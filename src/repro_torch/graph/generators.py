"""Synthetic graph generators matched to the paper's dataset families.

The port's own copy of ``repro.graph.generators``: the same seed must give
the same graph in both packages, edge for edge.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graph.csr import Graph, from_edge_list


def mesh_graph(n: int, rng: np.random.Generator) -> Graph:
    """Finite-element-mesh-like planar graph (3elt/4elt family).

    Triangulated grid: ~3 edges per vertex interior, like the Walshaw
    archive FE meshes (avg degree ~6 in CSR, |E| ≈ 3|V|).
    """
    side = int(np.ceil(np.sqrt(n)))
    edges = []
    grid = np.arange(side * side).reshape(side, side)
    # right, down, and one diagonal -> triangulation
    for (di, dj) in ((0, 1), (1, 0), (1, 1)):
        a = grid[: side - di if di else side, : side - dj if dj else side]
        b = grid[di:, dj:]
        edges.append(np.stack([a.reshape(-1), b.reshape(-1)], axis=1))
    e = np.concatenate(edges)
    e = e[(e[:, 0] < n) & (e[:, 1] < n)]
    # jitter: drop a few edges so the mesh is irregular like 3elt
    keep = rng.random(e.shape[0]) > 0.02
    return from_edge_list(e[keep], n=n)


def barabasi_albert(n: int, m: int, rng: np.random.Generator) -> Graph:
    """Preferential-attachment graph (social / citation family)."""
    m = max(1, m)
    targets = list(range(m))
    repeated: list[int] = []
    edges = np.empty((max(0, (n - m)) * m, 2), dtype=np.int64)
    k = 0
    for v in range(m, n):
        for t in targets:
            edges[k] = (v, t)
            k += 1
        repeated.extend(targets)
        repeated.extend([v] * m)
        # sample next targets by degree (preferential attachment)
        idx = rng.integers(0, len(repeated), size=3 * m)
        cand = {repeated[i] for i in idx}
        targets = list(cand)[:m]
        while len(targets) < m:
            t = int(rng.integers(0, v + 1))
            if t not in targets:
                targets.append(t)
    return from_edge_list(edges[:k], n=n)


def erdos_renyi(n: int, m_edges: int, rng: np.random.Generator) -> Graph:
    """Uniform random graph with ~m_edges edges."""
    m_draw = int(m_edges * 1.15) + 8
    u = rng.integers(0, n, size=m_draw)
    v = rng.integers(0, n, size=m_draw)
    e = np.stack([u, v], axis=1)
    e = e[u != v][:m_edges]
    return from_edge_list(e, n=n)


def powerlaw_cluster(n: int, m: int, p: float, rng: np.random.Generator) -> Graph:
    """BA-with-triads (Holme–Kim-like): heavy tail + clustering (social)."""
    g = barabasi_albert(n, m, rng)
    # add triad-closing edges
    extra = []
    n_extra = int(p * g.num_edges)
    vs = rng.integers(0, n, size=n_extra)
    for v in vs:
        nbrs = g.neighbors(int(v))
        if nbrs.size >= 2:
            a, b = rng.choice(nbrs, size=2, replace=False)
            extra.append((int(a), int(b)))
    if extra:
        e = np.concatenate([g.edge_array(), np.array(extra, dtype=np.int64)])
        g = from_edge_list(e, n=n)
    return g


def make_graph(family: str, n: int, m_edges: int, seed: int = 0) -> Graph:
    """Dispatch by dataset family with target |V|=n, |E|≈m_edges."""
    rng = np.random.default_rng(seed)
    if family == "mesh":
        return mesh_graph(n, rng)
    if family in ("social", "citation", "collaboration"):
        m = max(1, int(round(m_edges / max(n, 1))))
        return powerlaw_cluster(n, m, 0.1, rng)
    if family == "communication":
        m = max(1, int(round(m_edges / max(n, 1))))
        return barabasi_albert(n, m, rng)
    if family == "uniform":
        return erdos_renyi(n, m_edges, rng)
    raise ValueError(f"unknown graph family: {family}")
