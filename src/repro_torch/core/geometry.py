"""Elastic state geometry: the (n, max_deg, k_max) shape triple as a value
(the port's copy of ``repro.core.geometry``).

Growing ``n``/``max_deg`` never changes a decision: every transition core
scores absent rows as empty and ``-1`` neighbour entries are masked, and
the RNG folds ``(base_key, global_event_index)``. A state grown mid-stream
is therefore bit-identical to one that ran at the larger geometry from the
start — except under LDG, whose capacity knob reads the allocated ``n``.

Auto-growth doubles at minimum (:func:`grow_tier`): each grown dimension
jumps to ``next_pow2(max(required, 2 * current))``, so a session fed a
stream of unknown size regrows O(log n) times. Shrinking is its
hysteretic inverse (:func:`shrink_tier`): a dimension drops only once its
live content fills at most ``1 / (2 * hysteresis)`` of it, and lands at
most half full, so a stream oscillating around a tier boundary does not
regrow and shrink on every window.
"""
from __future__ import annotations

from typing import NamedTuple


def next_pow2(x: int) -> int:
    """Smallest power of two >= max(x, 1)."""
    x = int(x)
    return 1 if x <= 1 else 1 << (x - 1).bit_length()


class Geometry(NamedTuple):
    """The shape triple every dense partition state is allocated at.

    ``k_max=None`` means "no requirement" — streams know the vertex
    universe and row width they need but have no opinion on the
    partition-slot count (that is the config's job).
    """
    n: int
    max_deg: int
    k_max: int | None = None

    def covers(self, other: "Geometry") -> bool:
        """True iff a state at this geometry can ingest work requiring
        ``other`` (componentwise >=; a ``None`` requirement is free)."""
        return (self.n >= other.n and self.max_deg >= other.max_deg
                and (other.k_max is None or (self.k_max or 0) >= other.k_max))

    def union(self, other: "Geometry") -> "Geometry":
        """Componentwise max — the smallest geometry covering both."""
        ks = [k for k in (self.k_max, other.k_max) if k is not None]
        return Geometry(max(self.n, other.n),
                        max(self.max_deg, other.max_deg),
                        max(ks) if ks else None)


def geometry_of(state) -> Geometry:
    """The geometry a live ``PartitionState`` is allocated at."""
    return Geometry(int(state.assignment.shape[0]),
                    int(state.adj.shape[1]),
                    int(state.edge_load.shape[0]))


def grow_tier(current: Geometry, required: Geometry) -> Geometry:
    """The tier-doubling growth policy: every dimension that ``required``
    exceeds jumps to ``next_pow2(max(required, 2 * current))``; satisfied
    dimensions keep their size. ``k_max`` grows exactly, never tiered."""
    def dim(cur: int, req: int) -> int:
        return cur if req <= cur else next_pow2(max(req, 2 * cur))

    k = current.k_max
    if required.k_max is not None and (k or 0) < required.k_max:
        k = required.k_max
    return Geometry(dim(current.n, required.n),
                    dim(current.max_deg, required.max_deg), k)


def shrink_tier(current: Geometry, required: Geometry, *,
                hysteresis: int = 4) -> Geometry:
    """The hysteretic shrink policy, the inverse of :func:`grow_tier`: a
    dimension whose live requirement has fallen to ``1 / (2 *
    hysteresis)`` of the allocation drops to ``next_pow2(2 * required)``;
    everything else keeps its size. ``k_max`` never shrinks. Returns
    ``current`` when nothing qualifies."""
    if hysteresis < 2:
        raise ValueError(
            f"hysteresis={hysteresis} must be >= 2: at 1 the shrink "
            "target is exactly the growth trigger, so a stream oscillating"
            " around a tier boundary would regrow every window")

    def dim(cur: int, req: int) -> int:
        req = max(int(req), 1)
        if req * 2 * hysteresis > cur:
            return cur
        return next_pow2(2 * req)

    return Geometry(dim(current.n, required.n),
                    dim(current.max_deg, required.max_deg),
                    current.k_max)


def check_row_width(state, nbrs) -> None:
    """Geometry guard at the engine boundaries: event rows must match the
    state's allocated row width exactly."""
    if nbrs.shape[-1] != state.adj.shape[-1]:
        raise ValueError(
            f"event neighbour rows are {nbrs.shape[-1]} wide but the state "
            f"geometry is max_deg={state.adj.shape[-1]} — normalize the rows "
            "(repro_torch.graph.stream.normalize_rows) or grow the state "
            "(repro_torch.core.state.grow_state)")


def resolve_geometry(stream, cfg, geometry: Geometry | None) -> Geometry:
    """Geometry an engine entry point should run ``stream`` at: the
    stream's declared geometry by default, or the caller's ``geometry``
    (validated to cover the stream's requirement; ``k_max`` defaults to
    the config's)."""
    if geometry is None:
        return Geometry(int(stream.n), int(stream.max_deg), int(cfg.k_max))
    geom = Geometry(int(geometry.n), int(geometry.max_deg),
                    int(geometry.k_max) if geometry.k_max else int(cfg.k_max))
    req = stream.required_geometry()
    if not geom.covers(req):
        raise ValueError(
            f"geometry=(n={geom.n}, max_deg={geom.max_deg}) cannot ingest "
            f"this stream: it requires at least (n={req.n}, "
            f"max_deg={req.max_deg})")
    if geom.k_max < cfg.k_init:
        raise ValueError(
            f"geometry k_max={geom.k_max} is smaller than cfg.k_init="
            f"{cfg.k_init}: the initial partitions would not fit")
    return geom
