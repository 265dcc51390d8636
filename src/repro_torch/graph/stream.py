"""Streaming event representation of a dynamic graph (the port's copy of
``repro.graph.stream``, the part the streaming session needs).

The stream (paper §4.1, Fig. 3) delivers one event at a time:
  * add a vertex together with its associated edges,
  * delete a vertex (and all its edges),
  * delete an edge.

The engines consume a *padded event tensor*: dense arrays of
``(etype, vertex, nbrs[max_deg])`` with ``-1`` padding. For the same seed
the generators here emit byte-identical streams to the JAX package's:
``dynamic_schedule`` (the paper's §5.3.1 add/delete protocol),
``interleaved_churn``, and the adversarial quality streams
``hub_arrivals``, ``community_merge`` and ``flash_crowd``, which the
rebalance is judged on. ``materialize_graph`` is the graph a stream leaves
behind (the offline baseline partitions it).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.graph.csr import Graph, from_edge_list

EVENT_ADD = 0        # add vertex `vertex` with neighbour list `nbrs`
EVENT_DEL_VERTEX = 1  # delete vertex `vertex` and all incident edges
EVENT_DEL_EDGE = 2   # delete edge (vertex, nbrs[0])
EVENT_PAD = 3        # no-op padding


@dataclasses.dataclass(frozen=True)
class VertexStream:
    """Padded event tensor for a dynamic-graph stream.

    Attributes:
      etype:  (T,) int32 event codes (EVENT_*).
      vertex: (T,) int32 subject vertex (-1 for padding).
      nbrs:   (T, max_deg) int32 neighbour ids, -1 padded. For EVENT_ADD
              these are *all known* neighbours of the vertex in the underlying
              graph (capped at max_deg by uniform subsample); the engine only
              scores those already assigned, as in the paper.
      n:      total number of distinct vertex ids (array sizes).
      intervals: event indices at which the paper captures metrics.
      truncated_nbrs: count of neighbour entries dropped by the max_deg cap
              (0 ⇒ the stream is exact).
    """

    etype: np.ndarray
    vertex: np.ndarray
    nbrs: np.ndarray
    n: int
    intervals: tuple[int, ...] = ()
    truncated_nbrs: int = 0

    @property
    def num_events(self) -> int:
        return int(self.etype.shape[0])

    @property
    def max_deg(self) -> int:
        return int(self.nbrs.shape[1])

    def required_geometry(self):
        """Minimal :class:`repro_torch.core.geometry.Geometry` able to ingest
        this stream: ``n`` covers the declared universe AND every vertex id
        the events reference, ``max_deg`` is the real content width
        (all-pad trailing columns don't count)."""
        return required_geometry_of(self.vertex, self.nbrs, n=self.n)


def required_geometry_of(vertex, nbrs, n: int = 0):
    """``VertexStream.required_geometry`` over bare event arrays — the
    session feed path calls this on ``(etype, vertex, nbrs)`` triples."""
    from repro_torch.core.geometry import Geometry  # deferred: core imports us
    vertex = np.asarray(vertex)
    nbrs = np.asarray(nbrs)
    n_req = max(int(n), 1)
    if vertex.size:
        n_req = max(n_req, int(vertex.max()) + 1)
    real = nbrs >= 0
    width = 1
    if real.any():
        n_req = max(n_req, int(nbrs[real].max()) + 1)
        width = int(np.flatnonzero(real.any(axis=0)).max()) + 1
    return Geometry(n_req, width)


def normalize_rows(nbrs: np.ndarray, width: int) -> np.ndarray:
    """Pad (with -1) or losslessly trim neighbour rows to ``width``
    columns. Raises if trimming would drop a real neighbour id; callers
    grow the target geometry first rather than widening here."""
    nbrs = np.asarray(nbrs, np.int32)
    d = nbrs.shape[1]
    if d == width:
        return nbrs
    if d < width:
        return np.concatenate(
            [nbrs, np.full((nbrs.shape[0], width - d), -1, np.int32)],
            axis=1)
    if np.any(nbrs[:, width:] >= 0):
        raise ValueError(
            f"neighbour rows carry real ids beyond column {width} (rows are "
            f"{d} wide) — grow the target geometry's max_deg instead of "
            "trimming (repro_torch.core.state.grow_state)")
    return nbrs[:, :width]


def _neighbor_rows(
    g: Graph, order: np.ndarray, max_deg: int, rng: np.random.Generator
) -> tuple[np.ndarray, int]:
    rows = -np.ones((order.shape[0], max_deg), dtype=np.int32)
    truncated = 0
    for i, v in enumerate(order):
        nb = g.neighbors(int(v))
        if nb.size > max_deg:
            truncated += nb.size - max_deg
            nb = rng.choice(nb, size=max_deg, replace=False)
        rows[i, : nb.size] = nb
    return rows, truncated


def build_stream(
    g: Graph,
    *,
    max_deg: Optional[int] = None,
    seed: int = 0,
    order: Optional[np.ndarray] = None,
) -> VertexStream:
    """Static (insert-only) stream: every vertex arrives once, random order."""
    rng = np.random.default_rng(seed)
    if order is None:
        order = rng.permutation(g.n)
    order = np.asarray(order, dtype=np.int32)
    if max_deg is None:
        max_deg = int(np.diff(g.indptr).max(initial=1))
    nbrs, truncated = _neighbor_rows(g, order, max_deg, rng)
    return VertexStream(
        etype=np.full(order.shape[0], EVENT_ADD, dtype=np.int32),
        vertex=order,
        nbrs=nbrs,
        n=g.n,
        intervals=(order.shape[0],),
        truncated_nbrs=truncated,
    )


def dynamic_schedule(
    g: Graph,
    *,
    add_pct: float = 25.0,
    del_pct: float = 5.0,
    n_intervals: int = 4,
    max_deg: Optional[int] = None,
    seed: int = 0,
    del_edges_per_interval: int = 0,
) -> VertexStream:
    """Paper §5.3.1 protocol: per interval, add `add_pct`% of the dataset's
    vertices, then delete `del_pct`% of the *currently present* vertices
    (Eqs. 11–12). Optionally also delete individual edges, only ever
    between two present endpoints (a later add row must not resurrect a
    deleted edge one-sided)."""
    rng = np.random.default_rng(seed)
    if max_deg is None:
        max_deg = int(np.diff(g.indptr).max(initial=1))
    order = rng.permutation(g.n).astype(np.int32)
    n_add = int(round(g.n * add_pct / 100.0))
    n_del = int(round(g.n * del_pct / 100.0))

    etypes: list[np.ndarray] = []
    vertices: list[np.ndarray] = []
    nbr_rows: list[np.ndarray] = []
    intervals: list[int] = []
    truncated = 0

    present: list[int] = []
    cursor = 0
    t = 0
    for _ in range(n_intervals):
        add = order[cursor : cursor + n_add]
        cursor += add.shape[0]
        if add.size:
            rows, tr = _neighbor_rows(g, add, max_deg, rng)
            truncated += tr
            etypes.append(np.full(add.shape[0], EVENT_ADD, dtype=np.int32))
            vertices.append(add)
            nbr_rows.append(rows)
            present.extend(int(v) for v in add)
            t += add.shape[0]
        k = min(n_del, len(present))
        if k > 0:
            pick = rng.choice(len(present), size=k, replace=False)
            dels = np.array([present[i] for i in pick], dtype=np.int32)
            keep = np.ones(len(present), dtype=bool)
            keep[pick] = False
            present = [p for p, kk in zip(present, keep) if kk]
            etypes.append(np.full(k, EVENT_DEL_VERTEX, dtype=np.int32))
            vertices.append(dels)
            nbr_rows.append(-np.ones((k, max_deg), dtype=np.int32))
            t += k
        if del_edges_per_interval > 0 and present:
            evs, eus = [], []
            pres_arr = np.asarray(present, dtype=np.int64)
            for _ in range(del_edges_per_interval):
                v = int(rng.choice(present))
                nb = g.neighbors(v)
                nb = nb[np.isin(nb, pres_arr)]
                if nb.size:
                    evs.append(v)
                    eus.append(int(rng.choice(nb)))
            if evs:
                k = len(evs)
                etypes.append(np.full(k, EVENT_DEL_EDGE, dtype=np.int32))
                vertices.append(np.asarray(evs, dtype=np.int32))
                rows = -np.ones((k, max_deg), dtype=np.int32)
                rows[:, 0] = eus
                nbr_rows.append(rows)
                t += k
        intervals.append(t)
        if cursor >= g.n:
            break

    return VertexStream(
        etype=np.concatenate(etypes) if etypes else np.zeros(0, np.int32),
        vertex=np.concatenate(vertices) if vertices else np.zeros(0, np.int32),
        nbrs=(np.concatenate(nbr_rows) if nbr_rows
              else np.zeros((0, max_deg), np.int32)),
        n=g.n,
        intervals=tuple(intervals),
        truncated_nbrs=truncated,
    )


def interleaved_churn(
    g: Graph,
    *,
    warmup_frac: float = 0.25,
    del_every: int = 3,
    edge_del_every: int = 0,
    readd_every: int = 0,
    max_deg: Optional[int] = None,
    seed: int = 0,
) -> VertexStream:
    """Fine-grained interleaved churn stream (the xDGP-style regime).

    After a warm-up of ``warmup_frac`` of the vertices, the remaining adds
    arrive interleaved with deletions: every ``del_every`` adds a random
    *present* vertex is deleted, every ``edge_del_every`` adds a random
    present edge is deleted, and every ``readd_every`` adds a previously
    deleted vertex is re-added.
    """
    rng = np.random.default_rng(seed)
    if max_deg is None:
        max_deg = int(np.diff(g.indptr).max(initial=1))
    order = rng.permutation(g.n).astype(np.int32)
    truncated = 0
    # edges killed by DEL_EDGE stay dead: a later re-add of an endpoint must
    # not resurrect them (its row comes from the static graph), or the
    # materialized adjacency would go asymmetric
    dead_edges: set[tuple[int, int]] = set()

    def row_of(v: int) -> np.ndarray:
        nonlocal truncated
        row = -np.ones(max_deg, dtype=np.int32)
        nb = g.neighbors(int(v))
        if dead_edges:
            nb = np.asarray([u for u in nb
                             if (min(int(u), int(v)), max(int(u), int(v)))
                             not in dead_edges], dtype=nb.dtype)
        if nb.size > max_deg:
            truncated += nb.size - max_deg
            nb = rng.choice(nb, size=max_deg, replace=False)
        row[: nb.size] = nb
        return row

    etypes: list[int] = []
    vertices: list[int] = []
    nbr_rows: list[np.ndarray] = []

    def emit(et: int, v: int, row: np.ndarray):
        etypes.append(et)
        vertices.append(int(v))
        nbr_rows.append(row)

    present: list[int] = []
    # membership mask of `present` (same answers as np.isin(nb, present),
    # in O(len(nb)) instead of O(len(present)) per edge deletion)
    is_present = np.zeros(g.n, dtype=bool)
    deleted: list[int] = []
    n_warm = int(round(g.n * warmup_frac))
    for v in order[:n_warm]:
        emit(EVENT_ADD, v, row_of(v))
        present.append(int(v))
        is_present[v] = True

    count = 0
    for v in order[n_warm:]:
        emit(EVENT_ADD, v, row_of(v))
        present.append(int(v))
        is_present[v] = True
        count += 1
        if del_every and count % del_every == 0 and present:
            i = int(rng.integers(len(present)))
            dv = present.pop(i)
            is_present[dv] = False
            deleted.append(dv)
            emit(EVENT_DEL_VERTEX, dv, -np.ones(max_deg, np.int32))
        if edge_del_every and count % edge_del_every == 0 and present:
            ev = int(present[int(rng.integers(len(present)))])
            nb = g.neighbors(ev)
            # both endpoints present and the edge still alive (see row_of)
            nb = nb[is_present[nb]]
            nb = np.asarray([u for u in nb
                             if (min(int(u), ev), max(int(u), ev))
                             not in dead_edges], dtype=nb.dtype)
            if nb.size:
                eu = int(rng.choice(nb))
                dead_edges.add((min(eu, ev), max(eu, ev)))
                row = -np.ones(max_deg, np.int32)
                row[0] = eu
                emit(EVENT_DEL_EDGE, ev, row)
        if readd_every and count % readd_every == 0 and deleted:
            rv = deleted.pop(int(rng.integers(len(deleted))))
            emit(EVENT_ADD, rv, row_of(rv))
            present.append(rv)
            is_present[rv] = True

    return VertexStream(
        etype=np.asarray(etypes, np.int32),
        vertex=np.asarray(vertices, np.int32),
        nbrs=(np.stack(nbr_rows) if nbr_rows
              else np.zeros((0, max_deg), np.int32)),
        n=g.n,
        intervals=(len(etypes),),
        truncated_nbrs=truncated,
    )


def poisson_arrivals(
    s: VertexStream,
    *,
    rate: float,
    mean_batch: float = 24.0,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Chop a stream into arrival batches with Poisson-process due times
    (the serving-workload model). Batch sizes are Poisson around
    ``mean_batch`` (clamped >= 1, truncated at the stream end); gaps are
    exponential with mean ``batch_size / rate``. Returns ``(bounds,
    due)``: (B+1,) int64 slice boundaries and (B,) float64 due times in
    seconds."""
    if rate <= 0:
        raise ValueError(f"rate={rate} must be > 0 events/second")
    if mean_batch <= 0:
        raise ValueError(f"mean_batch={mean_batch} must be > 0 events")
    rng = np.random.default_rng(seed)
    T = s.num_events
    sizes: list[int] = []
    total = 0
    while total < T:
        b = max(int(rng.poisson(mean_batch)), 1)
        b = min(b, T - total)
        sizes.append(b)
        total += b
    bounds = np.concatenate([[0], np.cumsum(sizes, dtype=np.int64)])
    gaps = rng.exponential(np.asarray(sizes, np.float64) / rate)
    return bounds, np.cumsum(gaps)


def pad_stream(s: VertexStream, multiple: int) -> VertexStream:
    """Pad the event tensor length to a multiple (for fixed-window engines)."""
    t = s.num_events
    target = ((t + multiple - 1) // multiple) * multiple
    if target == t:
        return s
    pad = target - t
    return VertexStream(
        etype=np.concatenate([s.etype, np.full(pad, EVENT_PAD, np.int32)]),
        vertex=np.concatenate([s.vertex, np.full(pad, -1, np.int32)]),
        nbrs=np.concatenate([s.nbrs, -np.ones((pad, s.max_deg), np.int32)]),
        n=s.n,
        intervals=s.intervals,
        truncated_nbrs=s.truncated_nbrs,
    )


def concat_streams(streams: Sequence[VertexStream]) -> VertexStream:
    """Concatenate streams over the same vertex universe."""
    max_deg = max(s.max_deg for s in streams)
    nbrs = [normalize_rows(s.nbrs, max_deg) for s in streams]
    offs, acc = [], 0
    for s in streams:
        offs.extend(i + acc for i in s.intervals)
        acc += s.num_events
    return VertexStream(
        etype=np.concatenate([s.etype for s in streams]),
        vertex=np.concatenate([s.vertex for s in streams]),
        nbrs=np.concatenate(nbrs),
        n=max(s.n for s in streams),
        intervals=tuple(offs),
        truncated_nbrs=sum(s.truncated_nbrs for s in streams),
    )


# ---------------------------------------------------------------------------
# adversarial streams — the quality scenarios the rebalance is judged on
# ---------------------------------------------------------------------------
# Arrivals are arranged so that early one-shot decisions are maximally wrong
# by the end of the stream. Adjacency rows come from one static graph built
# up front (both endpoints of every edge list each other; rows naming ids
# not yet present are inert until the partner arrives), and deletions only
# name present vertices — the discipline the counters' recount needs.


def _append_dels(s: VertexStream, victims: np.ndarray,
                 intervals: Sequence[int]) -> VertexStream:
    """Append DEL_VERTEX events for ``victims`` (present vertices)."""
    nd = victims.shape[0]
    return VertexStream(
        etype=np.concatenate(
            [s.etype, np.full(nd, EVENT_DEL_VERTEX, np.int32)]),
        vertex=np.concatenate([s.vertex, victims.astype(np.int32)]),
        nbrs=np.concatenate([s.nbrs, -np.ones((nd, s.max_deg), np.int32)]),
        n=s.n,
        intervals=tuple(intervals) + (s.num_events + nd,),
        truncated_nbrs=s.truncated_nbrs,
    )


def hub_arrivals(
    g: Graph,
    *,
    hub_frac: float = 0.02,
    warmup_frac: float = 0.3,
    del_frac: float = 0.0,
    max_deg: Optional[int] = None,
    seed: int = 0,
) -> VertexStream:
    """Power-law burst: the top-degree hubs arrive in one burst after only
    ``warmup_frac`` of the periphery exists, so each hub is placed nearly
    blind. ``del_frac`` of the warm-up vertices then leave. Intervals:
    (end of warm-up, end of burst, end of adds[, end of dels])."""
    rng = np.random.default_rng(seed)
    deg = np.diff(g.indptr)
    n_hub = max(1, int(round(g.n * hub_frac)))
    hubs = np.argsort(deg, kind="stable")[::-1][:n_hub]
    rest = rng.permutation(np.setdiff1d(np.arange(g.n), hubs))
    n_warm = int(round(rest.size * warmup_frac))
    order = np.concatenate([rest[:n_warm], hubs, rest[n_warm:]])
    s = build_stream(g, max_deg=max_deg, seed=seed, order=order)
    intervals = (n_warm, n_warm + n_hub, g.n)
    n_del = int(round(n_warm * del_frac))
    if n_del == 0:
        return dataclasses.replace(s, intervals=intervals)
    victims = rng.choice(rest[:n_warm], size=n_del, replace=False)
    return _append_dels(s, victims, intervals)


def community_merge(
    *,
    block: int = 300,
    p_intra: float = 0.05,
    bridges: int = 60,
    bridge_deg: int = 6,
    max_deg: Optional[int] = None,
    seed: int = 0,
) -> VertexStream:
    """Two dense blocks bridged mid-stream: block A, then block B, then
    ``bridges`` vertices wired half into each block — the early per-block
    placements then cut every bridge edge. Intervals: (end of A, end of B,
    end of bridges)."""
    rng = np.random.default_rng(seed)
    n = 2 * block + bridges
    m_intra = max(block - 1, int(round(p_intra * block * (block - 1) / 2)))
    parts = []
    for base in (0, block):
        # sampled pair list — from_edge_list dedups and drops self-loops
        pairs = rng.integers(0, block, size=(m_intra, 2)) + base
        # a spanning chain keeps each block connected
        chain = np.stack([np.arange(block - 1), np.arange(1, block)],
                         axis=1) + base
        parts.append(np.concatenate([pairs, chain]))
    half = max(1, bridge_deg // 2)
    for b in range(2 * block, n):
        ends = np.concatenate([rng.choice(block, half, replace=False),
                               rng.choice(block, half, replace=False)
                               + block])
        parts.append(np.stack([np.full(ends.size, b), ends], axis=1))
    g = from_edge_list(np.concatenate(parts), n=n)
    order = np.concatenate([rng.permutation(block),
                            rng.permutation(block) + block,
                            rng.permutation(np.arange(2 * block, n))])
    s = build_stream(g, max_deg=max_deg, seed=seed, order=order)
    return dataclasses.replace(s, intervals=(block, 2 * block, n))


def flash_crowd(
    g: Graph,
    *,
    crowd: int = 200,
    celebrities: int = 8,
    attach: int = 3,
    arrive_frac: float = 0.5,
    depart_frac: float = 0.5,
    max_deg: Optional[int] = None,
    seed: int = 0,
) -> VertexStream:
    """Arrival spike onto few vertices: after ``arrive_frac`` of the base
    graph, ``crowd`` new vertices arrive back to back, each starring onto
    ``attach`` of the ``celebrities`` highest-degree vertices (the star
    edges are in the static graph from the start); ``depart_frac`` of the
    crowd then leaves. Intervals: (spike start, spike end, end of adds[,
    end of dels])."""
    rng = np.random.default_rng(seed)
    deg = np.diff(g.indptr)
    celebs = np.argsort(deg, kind="stable")[::-1][:max(celebrities, attach)]
    crowd_ids = np.arange(g.n, g.n + crowd)
    star = np.stack([
        np.repeat(crowd_ids, attach),
        np.concatenate([rng.choice(celebs, attach, replace=False)
                        for _ in crowd_ids]),
    ], axis=1)
    base_edges = g.edge_array()
    edges = np.concatenate([base_edges, star]) if base_edges.size else star
    g2 = from_edge_list(edges, n=g.n + crowd)
    basep = rng.permutation(g.n)
    n_pre = int(round(g.n * arrive_frac))
    order = np.concatenate([basep[:n_pre], rng.permutation(crowd_ids),
                            basep[n_pre:]])
    s = build_stream(g2, max_deg=max_deg, seed=seed, order=order)
    intervals = (n_pre, n_pre + crowd, g2.n)
    n_dep = int(round(crowd * depart_frac))
    if n_dep == 0:
        return dataclasses.replace(s, intervals=intervals)
    victims = rng.choice(crowd_ids, size=n_dep, replace=False)
    return _append_dels(s, victims, intervals)


def materialize_graph(s: VertexStream) -> Graph:
    """The graph a stream leaves behind: final present vertices and live
    edges under the engines' event semantics (duplicate adds ignored, a
    vertex deletion drops its incident edges, an edge deletion is
    permanent for the pair). Assumes the generator discipline above."""
    present: set[int] = set()
    rows: dict[int, set[int]] = {}
    live: set[tuple[int, int]] = set()
    dead: set[tuple[int, int]] = set()
    # live pairs by endpoint, so a vertex deletion touches only its own
    incident: dict[int, set[tuple[int, int]]] = {}
    for t in range(s.num_events):
        et, v = int(s.etype[t]), int(s.vertex[t])
        if et == EVENT_ADD:
            if v in present:
                continue  # duplicate adds are engine no-ops
            row = {int(u) for u in s.nbrs[t] if u >= 0}
            present.add(v)
            rows[v] = row
            for u in row:
                pair = (min(v, u), max(v, u))
                if u in present and v in rows.get(u, ()) \
                        and pair not in dead:
                    live.add(pair)
                    incident.setdefault(u, set()).add(pair)
                    incident.setdefault(v, set()).add(pair)
        elif et == EVENT_DEL_VERTEX:
            if v not in present:
                continue
            present.discard(v)
            for pair in incident.pop(v, ()):
                live.discard(pair)
                other = pair[0] if pair[1] == v else pair[1]
                incident.get(other, set()).discard(pair)
        elif et == EVENT_DEL_EDGE:
            u = int(s.nbrs[t, 0])
            pair = (min(v, u), max(v, u))
            if v in present and u in present and pair in live:
                live.discard(pair)
                incident[v].discard(pair)
                incident[u].discard(pair)
                dead.add(pair)
                rows[v].discard(u)
                rows[u].discard(v)
    n = s.required_geometry().n
    edges = (np.asarray(sorted(live), np.int64)
             if live else np.zeros((0, 2), np.int64))
    return from_edge_list(edges, n=n)
