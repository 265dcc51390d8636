"""SHA-256 of the JAX package's final PartitionState for the grqc session
that ``chip_smoke.py`` drives on the card (its phase ``grqc``), over every
leaf's bytes in field order — the same digest ``chip_smoke.py`` prints as
``state_sha256`` for the PyTorch port. Equal digests mean the port on the
card reproduced the JAX reference leaf for leaf.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/jax_state_digest.py
"""
from __future__ import annotations

import hashlib

import numpy as np

from repro.core import EngineConfig, run_stream
from repro.graph.datasets import load_dataset
from repro.graph.stream import interleaved_churn


def main() -> None:
    stream = interleaved_churn(load_dataset("grqc"), warmup_frac=0.2,
                               del_every=3, edge_del_every=5, seed=0)
    cfg = EngineConfig(k_max=16, k_init=1, max_cap=1500, autoscale=True)
    state, _ = run_stream(stream, policy="sdp", cfg=cfg, seed=0)
    digest = hashlib.sha256()
    for leaf in state:
        digest.update(np.asarray(leaf).tobytes())
    print(digest.hexdigest())


if __name__ == "__main__":
    main()
