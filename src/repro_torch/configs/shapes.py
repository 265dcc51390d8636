"""Assigned input-shape sets, one per architecture family (the port's copy
of ``repro.configs.shapes``, which is framework-free; kept identical so
both packages run the same shapes).

Sizes are padded up front to multiples of 64 so every pjit-boundary
sharding divides the (pod×data×model) mesh axes evenly; models mask
padding. `requires_subquadratic` marks long_500k (skip rule: DESIGN.md §4).
"""
from __future__ import annotations

import dataclasses


def round_to(x: int, m: int = 64) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class LMShape:
    name: str
    kind: str          # 'train' | 'prefill' | 'decode'
    seq_len: int
    global_batch: int
    requires_subquadratic: bool = False


LM_SHAPES = {
    "train_4k": LMShape("train_4k", "train", 4096, 256),
    "prefill_32k": LMShape("prefill_32k", "prefill", 32768, 32),
    "decode_32k": LMShape("decode_32k", "decode", 32768, 128),
    "long_500k": LMShape("long_500k", "decode", 524288, 1,
                         requires_subquadratic=True),
}


@dataclasses.dataclass(frozen=True)
class GNNShape:
    name: str
    kind: str          # 'full' | 'minibatch' | 'molecule'
    n_nodes: int       # graph-level (paper numbers)
    n_edges: int       # undirected count
    d_feat: int = 0
    batch_nodes: int = 0
    fanout: tuple = ()
    mol_batch: int = 0

    @property
    def n_pad(self) -> int:
        return round_to(self.n_nodes)

    @property
    def e_pad(self) -> int:
        """Directed (2×) padded edge count."""
        return round_to(2 * self.n_edges)


GNN_SHAPES = {
    "full_graph_sm": GNNShape("full_graph_sm", "full", 2708, 10556,
                              d_feat=1433),
    "minibatch_lg": GNNShape("minibatch_lg", "minibatch", 232965, 114615892,
                             d_feat=602, batch_nodes=1024, fanout=(15, 10)),
    "ogb_products": GNNShape("ogb_products", "full", 2449029, 61859140,
                             d_feat=100),
    "molecule": GNNShape("molecule", "molecule", 30, 64, mol_batch=128),
}


@dataclasses.dataclass(frozen=True)
class RecSysShape:
    name: str
    kind: str          # 'train' | 'serve' | 'bulk' | 'retrieval'
    batch: int
    n_candidates: int = 0


RECSYS_SHAPES = {
    "train_batch": RecSysShape("train_batch", "train", 65536),
    "serve_p99": RecSysShape("serve_p99", "serve", 512),
    "serve_bulk": RecSysShape("serve_bulk", "serve", 262144),
    "retrieval_cand": RecSysShape("retrieval_cand", "retrieval", 1,
                                  n_candidates=1_048_576),
}
