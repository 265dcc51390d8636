"""Paper §5.2 metrics (Eqs. 9–10) from first principles (the port's copy
of ``repro.core.metrics``).

These recompute from (assignment, present, adjacency) rather than trusting
the engines' incremental counters, so a run can be checked against them.
"""
from __future__ import annotations

import numpy as np


def recompute_counters(
    assignment: np.ndarray, present: np.ndarray, adj: np.ndarray, k_max: int
) -> dict[str, np.ndarray]:
    """Exact (edge_load, vertex_count, total_edges, cut_edges, cut_matrix)
    from scratch.

    ``cut_matrix`` is the (k_max, k_max) pairwise count the engines maintain
    incrementally: entry [p, q] (p != q) counts present edges between
    partitions p and q once per direction, and the diagonal [p, p] counts
    each internal edge of p twice — so rows sum to ``edge_load`` and the
    off-diagonal half-sum is ``cut_edges``.
    """
    assignment = np.asarray(assignment)
    present = np.asarray(present)
    adj = np.asarray(adj)
    valid = adj >= 0
    safe = np.where(valid, adj, 0)
    nb_present = valid & present[safe] & present[:, None]
    deg = nb_present.sum(axis=1)
    vertex_count = np.bincount(
        assignment[present & (assignment >= 0)], minlength=k_max
    )[:k_max]
    edge_load = np.zeros(k_max, dtype=np.int64)
    own = np.broadcast_to(assignment[:, None], adj.shape)
    np.add.at(edge_load, own[nb_present], 1)
    cut_matrix = np.zeros((k_max, k_max), dtype=np.int64)
    np.add.at(cut_matrix, (own[nb_present], assignment[safe][nb_present]), 1)
    total = int(deg.sum()) // 2
    diff = nb_present & (assignment[:, None] != assignment[safe])
    cut = int(diff.sum()) // 2
    return {
        "edge_load": edge_load,
        "vertex_count": vertex_count.astype(np.int64),
        "total_edges": total,
        "cut_edges": cut,
        "cut_matrix": cut_matrix,
    }


def edge_cut_ratio(cut_edges: int, total_edges: int) -> float:
    """Eq. 9."""
    return cut_edges / max(total_edges, 1)


def load_imbalance(edge_load: np.ndarray, active: np.ndarray) -> float:
    """Eq. 10: population std of per-partition load over active partitions."""
    load = np.asarray(edge_load, np.float64)[np.asarray(active, bool)]
    if load.size == 0:
        return 0.0
    return float(np.sqrt(np.mean((load - load.mean()) ** 2)))


def normalized_load_imbalance(edge_load: np.ndarray,
                              active: np.ndarray) -> float:
    """Eq. 10 normalised by the mean load (scale-free: the rebalance's
    drift signal compares it against a threshold)."""
    load = np.asarray(edge_load, np.float64)[np.asarray(active, bool)]
    if load.size == 0 or load.mean() == 0:
        return 0.0
    return load_imbalance(edge_load, active) / load.mean()


def replication_factor(n_replicas: int, n_vertices: int) -> float:
    """Vertex-cut metric (HDRF-family baselines)."""
    return n_replicas / max(n_vertices, 1)
