"""Streaming event representation of a dynamic graph (the port's copy of
``repro.graph.stream``, the part the streaming session needs).

The stream (paper §4.1, Fig. 3) delivers one event at a time:
  * add a vertex together with its associated edges,
  * delete a vertex (and all its edges),
  * delete an edge.

The engines consume a *padded event tensor*: dense arrays of
``(etype, vertex, nbrs[max_deg])`` with ``-1`` padding. For the same seed
the generators here emit byte-identical streams to the JAX package's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.graph.csr import Graph

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
