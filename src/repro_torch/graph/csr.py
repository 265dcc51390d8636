"""Compressed sparse row graph structure (numpy, host-side).

The port's own copy of the JAX package's ``repro.graph.csr`` (only what the
streaming session needs): the two packages must build byte-identical graphs
from the same seed, and the port imports nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class Graph:
    """Undirected graph in CSR form.

    Attributes:
      indptr:  (n+1,) int64 — CSR row pointers.
      indices: (nnz,) int32 — neighbour ids, both directions stored.
      n:       number of vertices.
    """

    indptr: np.ndarray
    indices: np.ndarray
    n: int

    @property
    def num_edges(self) -> int:
        """Number of undirected edges (each stored twice in CSR)."""
        return int(self.indices.shape[0]) // 2

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v] : self.indptr[v + 1]]

    def edge_array(self) -> np.ndarray:
        """(m, 2) array of undirected edges with u < v."""
        src = np.repeat(np.arange(self.n, dtype=np.int64), np.diff(self.indptr))
        dst = self.indices.astype(np.int64)
        mask = src < dst
        return np.stack([src[mask], dst[mask]], axis=1)


def from_edge_list(edges: np.ndarray, n: Optional[int] = None) -> Graph:
    """Build an undirected CSR graph from an (m, 2) edge array.

    Self-loops and duplicate edges are removed.
    """
    edges = np.asarray(edges, dtype=np.int64)
    if edges.size == 0:
        n = int(n or 0)
        return Graph(np.zeros(n + 1, dtype=np.int64), np.zeros(0, np.int32), n)
    if n is None:
        n = int(edges.max()) + 1
    u, v = edges[:, 0], edges[:, 1]
    keep = u != v
    u, v = u[keep], v[keep]
    # canonicalise + dedup
    lo, hi = np.minimum(u, v), np.maximum(u, v)
    key = lo * n + hi
    _, uniq = np.unique(key, return_index=True)
    lo, hi = lo[uniq], hi[uniq]
    # both directions
    src = np.concatenate([lo, hi])
    dst = np.concatenate([hi, lo])
    order = np.argsort(src, kind="stable")
    src, dst = src[order], dst[order]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, src + 1, 1)
    indptr = np.cumsum(indptr)
    return Graph(indptr, dst.astype(np.int32), n)


def cap_degree(g: Graph, max_deg: int, seed: int = 0) -> Graph:
    """Symmetric degree cap: drop edges so every vertex has ≤ max_deg.

    Needed so padded (n, max_deg) adjacency tensors stay exact: the stream,
    engine bookkeeping and metrics all agree on the *capped* graph. Only the
    heavy-tailed stand-ins (twitter) are affected at default caps.
    """
    rng = np.random.default_rng(seed)
    deg = np.diff(g.indptr).copy()
    if deg.size == 0 or deg.max(initial=0) <= max_deg:
        return g
    edges = g.edge_array()
    order = rng.permutation(edges.shape[0])
    kept = np.zeros(edges.shape[0], dtype=bool)
    cnt = np.zeros(g.n, dtype=np.int64)
    for i in order:
        u, v = edges[i]
        if cnt[u] < max_deg and cnt[v] < max_deg:
            kept[i] = True
            cnt[u] += 1
            cnt[v] += 1
    return from_edge_list(edges[kept], n=g.n)
