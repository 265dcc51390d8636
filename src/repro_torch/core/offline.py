"""Offline (static) partitioner — the METIS stand-in of the paper's Fig. 5
(the port's copy of ``repro.core.offline``, numpy only).

BFS region growing to balanced seeds, then boundary Fiduccia–Mattheyses
style refinement sweeps. It sees the whole graph, so it bounds what the
streaming methods (and the rebalance) can reach on the edge cut.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graph.csr import Graph


def bfs_grow(g: Graph, k: int, seed: int = 0) -> np.ndarray:
    """Grow k balanced regions by multi-source BFS."""
    rng = np.random.default_rng(seed)
    assignment = -np.ones(g.n, dtype=np.int32)
    target = (g.n + k - 1) // k
    sizes = np.zeros(k, dtype=np.int64)
    order = rng.permutation(g.n)
    frontiers: list[list[int]] = [[] for _ in range(k)]
    for p, s in enumerate(order[:k]):
        assignment[s] = p
        sizes[p] = 1
        frontiers[p] = [int(s)]
    # round-robin BFS expansion, smallest region first
    progress = True
    while progress:
        progress = False
        for p in np.argsort(sizes):
            if sizes[p] >= target or not frontiers[p]:
                continue
            nxt = []
            for v in frontiers[p]:
                for u in g.neighbors(v):
                    if assignment[u] < 0 and sizes[p] < target:
                        assignment[u] = p
                        sizes[p] += 1
                        nxt.append(int(u))
                        progress = True
            frontiers[p] = nxt
    # orphans (disconnected) → least loaded
    for v in order:
        if assignment[v] < 0:
            p = int(np.argmin(sizes))
            assignment[v] = p
            sizes[p] += 1
    return assignment


def fm_refine(g: Graph, assignment: np.ndarray, k: int, passes: int = 4,
              balance_slack: float = 0.05) -> np.ndarray:
    """Boundary FM sweeps: move a vertex to the neighbouring partition with
    the most gain if the sizes stay within the slack."""
    assignment = assignment.copy()
    sizes = np.bincount(assignment, minlength=k).astype(np.int64)
    cap = int(np.ceil(g.n / k * (1 + balance_slack)))
    floor = int(np.floor(g.n / k * (1 - balance_slack)))
    for _ in range(passes):
        moved = 0
        for v in range(g.n):
            nb = g.neighbors(v)
            if nb.size == 0:
                continue
            p = assignment[v]
            counts = np.bincount(assignment[nb], minlength=k)
            q = int(np.argmax(counts))
            gain = counts[q] - counts[p]
            if q != p and gain > 0 and sizes[q] < cap and sizes[p] > floor:
                assignment[v] = q
                sizes[p] -= 1
                sizes[q] += 1
                moved += 1
        if moved == 0:
            break
    return assignment


def offline_partition(g: Graph, k: int, seed: int = 0,
                      passes: int = 4) -> np.ndarray:
    return fm_refine(g, bfs_grow(g, k, seed), k, passes=passes)


def cut_of(g: Graph, assignment: np.ndarray) -> int:
    e = g.edge_array()
    return int((assignment[e[:, 0]] != assignment[e[:, 1]]).sum())
