"""Fanout neighbour sampler (GraphSAGE-style) for `minibatch_lg`: the
port's numpy copy of ``repro.graph.sampler`` (the same ``rng`` draws in
the same order, so the same subgraphs from the same seeds).

Produces fixed-shape padded subgraphs, so every step sees one shape: seeds (B,), per-hop sampled neighbours with fanout f_h, local edge
lists, and a gathered feature matrix.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graph.csr import Graph


@dataclasses.dataclass(frozen=True)
class SampledSubgraph:
    """Local-id subgraph: row 0..B-1 are the seed nodes."""
    node_ids: np.ndarray     # (N_sub,) global ids (-1 pad)
    senders: np.ndarray      # (E_sub,) local ids (-1 pad)
    receivers: np.ndarray    # (E_sub,) local ids (-1 pad)
    seed_count: int

    @property
    def num_nodes(self) -> int:
        return int(self.node_ids.shape[0])


def sample_subgraph(
    g: Graph, seeds: np.ndarray, fanouts: tuple[int, ...],
    rng: np.random.Generator,
) -> SampledSubgraph:
    """Sample without dedup (fixed shapes): hop h draws `fanouts[h]`
    neighbours of every hop-(h-1) node; edges point child → parent so
    message passing flows toward the seeds."""
    seeds = np.asarray(seeds, dtype=np.int64)
    b = seeds.shape[0]
    frontier = seeds
    node_ids = [seeds]
    senders, receivers = [], []
    offset = 0          # local index of current frontier start
    next_offset = b
    for f in fanouts:
        nf = frontier.shape[0]
        children = -np.ones((nf, f), dtype=np.int64)
        for i, v in enumerate(frontier):
            if v < 0:
                continue
            nb = g.neighbors(int(v))
            if nb.size == 0:
                continue
            take = rng.choice(nb, size=f, replace=nb.size < f)
            children[i] = take
        child_local = next_offset + np.arange(nf * f).reshape(nf, f)
        parent_local = offset + np.repeat(np.arange(nf), f).reshape(nf, f)
        valid = children >= 0
        senders.append(np.where(valid, child_local, -1).reshape(-1))
        receivers.append(np.where(valid, parent_local, -1).reshape(-1))
        node_ids.append(children.reshape(-1))
        frontier = children.reshape(-1)
        offset = next_offset
        next_offset += nf * f
    return SampledSubgraph(
        node_ids=np.concatenate(node_ids).astype(np.int32),
        senders=np.concatenate(senders).astype(np.int32),
        receivers=np.concatenate(receivers).astype(np.int32),
        seed_count=b,
    )


def subgraph_sizes(batch_nodes: int, fanouts: tuple[int, ...]):
    """(n_nodes, n_edges) of the padded subgraph — for input_specs()."""
    n, e, layer = batch_nodes, 0, batch_nodes
    for f in fanouts:
        e += layer * f
        layer *= f
        n += layer
    return n, e


def make_minibatch(g: Graph, d_feat: int, batch_nodes: int,
                   fanouts: tuple[int, ...], *, seed: int = 0,
                   out_dim: int = 1) -> dict:
    """Host pipeline step → model batch dict (fixed shapes)."""
    rng = np.random.default_rng(seed)
    seeds = rng.integers(0, g.n, batch_nodes)
    sub = sample_subgraph(g, seeds, fanouts, rng)
    feat_rng = np.random.default_rng(seed + 1)
    valid = sub.node_ids >= 0
    feats = feat_rng.standard_normal((sub.num_nodes, d_feat)).astype(np.float32)
    feats[~valid] = 0.0
    mask = np.zeros(sub.num_nodes, bool)
    mask[: sub.seed_count] = True
    positions = feat_rng.standard_normal((sub.num_nodes, 3)).astype(np.float32)
    positions[~valid] = 0.0
    return {
        "senders": sub.senders,
        "receivers": sub.receivers,
        "node_feat": feats,
        "node_mask": mask,     # loss on seeds only
        "positions": positions,
        "species": feat_rng.integers(0, 16, sub.num_nodes).astype(np.int32),
        "targets": feat_rng.standard_normal(
            (sub.num_nodes, out_dim)).astype(np.float32),
    }
