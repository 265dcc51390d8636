"""Paper Table 2 datasets, instantiated synthetically (the port's copy of
``repro.graph.datasets``). ``scale`` shrinks a dataset uniformly."""
from __future__ import annotations

import dataclasses
import functools

from repro_torch.graph.csr import Graph
from repro_torch.graph.generators import make_graph


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    n_vertices: int
    n_edges: int
    family: str
    source: str


PAPER_DATASETS: dict[str, DatasetSpec] = {
    "3elt": DatasetSpec("3elt", 4200, 13722, "mesh", "Walshaw archive [25]"),
    "grqc": DatasetSpec("grqc", 5242, 14496, "collaboration", "SNAP [26]"),
    "wiki-vote": DatasetSpec("wiki-vote", 7115, 99291, "social", "SNAP [26]"),
    "4elt": DatasetSpec("4elt", 15606, 45878, "mesh", "Walshaw archive [25]"),
    "astroph": DatasetSpec("astroph", 18772, 198110, "citation", "SNAP [26]"),
    "email-enron": DatasetSpec("email-enron", 36692, 183831, "communication", "SNAP [26]"),
    "twitter": DatasetSpec("twitter", 81306, 1768149, "social", "SNAP [26]"),
}


@functools.lru_cache(maxsize=32)
def load_dataset(name: str, seed: int = 0, scale: float = 1.0) -> Graph:
    """Build the synthetic stand-in for a paper dataset.

    Args:
      name: key of ``PAPER_DATASETS``.
      seed: generator seed.
      scale: uniform shrink factor in (0, 1] for fast tests.
    """
    spec = PAPER_DATASETS[name.lower()]
    n = max(16, int(spec.n_vertices * scale))
    m = max(16, int(spec.n_edges * scale))
    return make_graph(spec.family, n, m, seed=seed)
