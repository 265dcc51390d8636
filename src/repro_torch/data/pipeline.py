"""Deterministic synthetic data pipelines of the port (the counterpart of
``repro.data.pipeline``; numpy, the same arrays from the same seeds).

Every generator is seeded and stateless-resumable: batch t is a pure
function of (seed, t). (The trainer's resume does not pass ``start_step``
to ``recsys_batches``, as the JAX package's does not: ROADMAP C.)
"""
from __future__ import annotations

from typing import Iterator

import numpy as np

from repro_torch.models.recsys import TwoTowerConfig, make_batch

_GRAPH_ITEM = ("ROADMAP A18.5 (the GNN slice: graph/sampler.py and "
               "models/gnn/common.py)")


def lm_batch(vocab: int, batch: int, seq: int, *, seed: int, step: int) -> dict:
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    toks = rng.integers(0, vocab, (batch, seq + 1), dtype=np.int64)
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


def token_batches(vocab: int, batch: int, seq: int, *, seed: int = 0,
                  start_step: int = 0) -> Iterator[dict]:
    step = start_step
    while True:
        yield lm_batch(vocab, batch, seq, seed=seed, step=step)
        step += 1


def graph_full_batch(*args, **kwargs) -> dict:
    raise NotImplementedError(f"graph_full_batch is not ported yet: "
                              f"{_GRAPH_ITEM}")


def graph_minibatches(*args, **kwargs) -> Iterator[dict]:
    raise NotImplementedError(f"graph_minibatches is not ported yet: "
                              f"{_GRAPH_ITEM}")


def recsys_batches(cfg: TwoTowerConfig, batch: int, *, seed: int = 0,
                   start_step: int = 0) -> Iterator[dict]:
    step = start_step
    while True:
        yield make_batch(cfg, batch, seed=seed + step)
        step += 1
