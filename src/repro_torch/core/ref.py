"""Pure-Python/numpy oracle for the streaming engine (the port's copy of
``repro.core.ref``).

An independent, dict/set-based reimplementation of Algorithm 1 — the same
shape as the paper's Java artifact — that the tests and ``chip_smoke.py``
hold the engines to bit for bit. It shares no code with the engines: its
counters are Python ints, the SDP guard's load statistics are Python
floats (f64), and a scale-in recounts the cut from scratch over the
adjacency sets. Random draws use the identical ``fold_in(base_key,
event_index)`` scheme (the port's ``core/rng.py``), so ties and random
placements match exactly.

The oracle runs on the host by design: it takes a ``VertexStream`` of
numpy arrays (or CPU tensors) and never touches a card.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import rng
from repro_torch.core.config import EngineConfig
from repro_torch.graph.stream import (
    EVENT_ADD, EVENT_DEL_EDGE, EVENT_DEL_VERTEX, VertexStream,
)


class RefState:
    def __init__(self, n: int, k_max: int, k_init: int, seed: int):
        self.n = n
        self.k_max = k_max
        self.assignment = {}          # vertex -> partition
        self.adj: dict[int, set] = {}  # vertex -> neighbour set (given at add)
        self.active = [i < k_init for i in range(k_max)]
        self.edge_load = [0] * k_max
        self.vertex_count = [0] * k_max
        self.total_edges = 0
        self.cut_edges = 0
        self.denied = 0
        self.scale_events = 0
        # pairwise cut counts, same convention as PartitionState.cut_matrix:
        # [p][q] (p != q) = present edges between p and q, diagonal = 2×
        # internal edges. Maintained incrementally; _scale_in still derives
        # cut_edges from a from-scratch recount, so the engines' matrix-based
        # merged cut is verified against an independent computation.
        self.cut_matrix = np.zeros((k_max, k_max), np.int64)
        self.base_key = rng.prng_key(seed, device="cpu")

    @property
    def num_partitions(self):
        return sum(self.active)

    def loads_active(self):
        return [(l, k) for k, (l, a) in enumerate(zip(self.edge_load, self.active)) if a]


class _Draws:
    """Event ``i``'s ``randint(fold_in(base_key, i), (), 0, m)``: the two
    words of every event drawn in one batch (``rng.draw_words``), each
    reduced onto ``[0, m)`` when its event needs a draw."""

    def __init__(self, base_key: torch.Tensor, num_events: int):
        self.hi, self.lo = rng.draw_words(
            base_key, torch.arange(num_events, dtype=torch.int64))

    def randint(self, i: int, m: int) -> int:
        return int(rng.randint_words(self.hi[i], self.lo[i], m))


def _load_stats(s: RefState):
    loads = [l for l, _ in s.loads_active()]
    p = max(len(loads), 1)
    avg_d = (max(loads) - min(loads)) / p if loads else 0.0
    mean = sum(loads) / p
    var = sum((l - mean) ** 2 for l in loads) / p
    return avg_d, float(np.sqrt(var))


def _scores(s: RefState, nbrs) -> tuple[list, int]:
    sc = [0] * s.k_max
    deg = 0
    for u in nbrs:
        if u in s.assignment:
            sc[s.assignment[u]] += 1
            deg += 1
    return sc, deg


def _argmin_load(s: RefState, mask=None):
    best, bk = None, None
    for k in range(s.k_max):
        ok = s.active[k] if mask is None else mask[k]
        if ok and (best is None or s.edge_load[k] < best):
            best, bk = s.edge_load[k], k
    return bk


def _nth_active(s: RefState, i: int) -> int:
    c = -1
    for k in range(s.k_max):
        if s.active[k]:
            c += 1
            if c == i:
                return k
    raise AssertionError("no active partition")


def _affinity(s: RefState, sc, draw) -> int:
    best = max(sc[k] if s.active[k] else -1 for k in range(s.k_max))
    if best > 0:
        tied = [s.active[k] and sc[k] == best for k in range(s.k_max)]
        return _argmin_load(s, tied)
    return _nth_active(s, draw(max(s.num_partitions, 1)))


def _choose(s: RefState, policy: str, cfg: EngineConfig, sc, deg, v,
            draw) -> int:
    if policy in ("greedy",):
        return _affinity(s, sc, draw)
    if policy == "sdp":
        avg_d, load_dev = _load_stats(s)
        w_dev = (s.total_edges / max(s.cut_edges, 1)) * load_dev
        th = w_dev - load_dev
        if cfg.balance_guard == "text":
            guard = s.num_partitions > 1 and avg_d > th
            return _argmin_load(s) if guard else _affinity(s, sc, draw)
        guard = s.num_partitions > 1 and load_dev > th
        return _affinity(s, sc, draw) if guard else _argmin_load(s)
    if policy == "ldg":
        k_act = max(s.num_partitions, 1)
        cap = cfg.ldg_slack * s.n / k_act
        h = [sc[k] * max(1.0 - s.vertex_count[k] / cap, 0.0) if s.active[k] else -np.inf
             for k in range(s.k_max)]
        best = max(h)
        tied = [s.active[k] and h[k] >= best - 1e-6 for k in range(s.k_max)]
        cand = [(s.vertex_count[k], k) for k in range(s.k_max) if tied[k]]
        return min(cand)[1]
    if policy == "fennel":
        g = cfg.fennel_gamma
        m = s.total_edges + deg
        nt = max(sum(s.vertex_count), 1)
        k_act = max(s.num_partitions, 1)
        alpha = cfg.fennel_alpha_scale * np.sqrt(k_act) * m / nt**1.5
        h = [sc[k] - alpha * g * s.vertex_count[k] ** (g - 1.0) if s.active[k] else -np.inf
             for k in range(s.k_max)]
        best = max(h)
        tied = [s.active[k] and h[k] >= best - 1e-6 for k in range(s.k_max)]
        cand = [(s.vertex_count[k], k) for k in range(s.k_max) if tied[k]]
        return min(cand)[1]
    if policy == "hash":
        return _nth_active(s, int(v) % max(s.num_partitions, 1))
    if policy == "random":
        return _nth_active(s, draw(max(s.num_partitions, 1)))
    raise ValueError(policy)


def _scale_out(s: RefState, cfg: EngineConfig):
    p = max(s.num_partitions, 1)
    if cfg.max_cap <= s.total_edges / p:
        if all(s.active):
            s.denied += 1
        else:
            s.active[s.active.index(False)] = True
            s.scale_events += 1


def _recompute_cut(s: RefState) -> int:
    cut = 0
    for v, nbrs in s.adj.items():
        if v not in s.assignment:
            continue
        for u in nbrs:
            if u in s.assignment and s.assignment[u] != s.assignment[v]:
                cut += 1
    return cut // 2


def _scale_in(s: RefState, cfg: EngineConfig):
    l = cfg.tolerance_param * cfg.max_cap / 100.0
    dest_threshold = cfg.max_cap - cfg.dest_param * cfg.max_cap / 100.0
    under = sum(1 for load, _ in s.loads_active() if load < l)
    if s.num_partitions <= 1 or under < 2:
        return
    src = _argmin_load(s)
    mask = list(s.active)
    mask[src] = False
    dst = _argmin_load(s, mask)
    if s.edge_load[src] + s.edge_load[dst] > dest_threshold:
        return
    for v, p in list(s.assignment.items()):
        if p == src:
            s.assignment[v] = dst
    s.edge_load[dst] += s.edge_load[src]
    s.edge_load[src] = 0
    s.vertex_count[dst] += s.vertex_count[src]
    s.vertex_count[src] = 0
    s.active[src] = False
    s.scale_events += 1
    s.cut_edges = _recompute_cut(s)  # independent of the pairwise matrix
    cm = s.cut_matrix
    row = cm[src, :].copy()
    cm[dst, :] += row
    cm[:, dst] += row
    cm[dst, dst] += cm[src, src]
    cm[src, :] = 0
    cm[:, src] = 0


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def run_reference(
    stream: VertexStream, *, policy: str = "sdp",
    cfg: EngineConfig | None = None, seed: int = 0,
) -> RefState:
    cfg = cfg or EngineConfig()
    s = RefState(stream.n, cfg.k_max, cfg.k_init, seed)
    etype, vertex, nbrs_all = (_host(x) for x in
                               (stream.etype, stream.vertex, stream.nbrs))
    draws = _Draws(s.base_key, stream.num_events)
    for i in range(stream.num_events):
        et = int(etype[i])
        v = int(vertex[i])
        if et == EVENT_ADD:
            if policy == "sdp" and cfg.autoscale:
                _scale_out(s, cfg)
            nbrs = [int(u) for u in nbrs_all[i] if u >= 0]
            sc, deg = _scores(s, nbrs)
            p = _choose(s, policy, cfg, sc, deg, v,
                        lambda m, i=i: draws.randint(i, m))
            if v not in s.assignment:
                s.assignment[v] = p
                s.adj[v] = set(nbrs)
                s.vertex_count[p] += 1
                for k in range(s.k_max):
                    s.edge_load[k] += sc[k]
                s.edge_load[p] += deg
                s.total_edges += deg
                s.cut_edges += deg - sc[p]
                s.cut_matrix[p, :] += np.asarray(sc)
                s.cut_matrix[:, p] += np.asarray(sc)
        elif et == EVENT_DEL_VERTEX:
            if v in s.assignment:
                nbrs = s.adj.get(v, set())
                sc, deg = _scores(s, nbrs)
                p = s.assignment[v]
                for k in range(s.k_max):
                    s.edge_load[k] -= sc[k]
                s.edge_load[p] -= deg
                s.vertex_count[p] -= 1
                s.total_edges -= deg
                s.cut_edges -= deg - sc[p]
                s.cut_matrix[p, :] -= np.asarray(sc)
                s.cut_matrix[:, p] -= np.asarray(sc)
                del s.assignment[v]
            if policy == "sdp" and cfg.autoscale:
                _scale_in(s, cfg)
        elif et == EVENT_DEL_EDGE:
            u = int(nbrs_all[i][0])
            exists = (v in s.assignment and u in s.assignment
                      and u in s.adj.get(v, set()))
            if exists:
                pv, pu = s.assignment[v], s.assignment[u]
                s.edge_load[pv] -= 1
                s.edge_load[pu] -= 1
                s.total_edges -= 1
                s.cut_edges -= int(pv != pu)
                s.cut_matrix[pv, pu] -= 1
                s.cut_matrix[pu, pv] -= 1
            if u >= 0:
                s.adj.get(v, set()).discard(u)
                s.adj.get(u, set()).discard(v)
    return s
