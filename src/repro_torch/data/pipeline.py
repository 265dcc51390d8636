"""Deterministic synthetic data pipelines of the port (the counterpart of
``repro.data.pipeline``; numpy, the same arrays from the same seeds).

Every generator is seeded and stateless-resumable: batch t is a pure
function of (seed, t). (The trainer's resume does not pass ``start_step``
to ``recsys_batches``, as the JAX package's does not: ROADMAP C.)
"""
from __future__ import annotations

from typing import Iterator

import numpy as np

from repro_torch.graph.csr import Graph
from repro_torch.graph.sampler import make_minibatch
from repro_torch.models.gnn.common import graph_to_batch
from repro_torch.models.recsys import TwoTowerConfig, make_batch


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


def graph_full_batch(g: Graph, d_feat: int, *, with_positions=False,
                     out_dim=1, seed: int = 0) -> dict:
    return graph_to_batch(g, d_feat, seed=seed,
                          with_positions=with_positions, out_dim=out_dim)


def graph_minibatches(g: Graph, d_feat: int, batch_nodes: int,
                      fanouts: tuple[int, ...], *, seed: int = 0,
                      start_step: int = 0) -> Iterator[dict]:
    step = start_step
    while True:
        yield make_minibatch(g, d_feat, batch_nodes, fanouts,
                             seed=seed + step)
        step += 1


def recsys_batches(cfg: TwoTowerConfig, batch: int, *, seed: int = 0,
                   start_step: int = 0) -> Iterator[dict]:
    step = start_step
    while True:
        yield make_batch(cfg, batch, seed=seed + step)
        step += 1
