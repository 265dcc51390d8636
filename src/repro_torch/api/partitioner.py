"""Stateful streaming session over the port's engines — the feed path of
``repro.api.partitioner``.

    part = Partitioner.from_stream(stream, cfg, policy="sdp", use_kernel=True)
    for chunk in arriving_chunks:
        part.feed(chunk)            # any number of events per call
        print(part.metrics())       # observable mid-stream

The session owns a device-resident :class:`PartitionState` (on the CUDA
card by default) and a global event cursor.

* **Bit-identity under any chopping.** Event ``i`` draws from
  ``fold_in(key, i)`` whatever the chunk boundaries, so feeding in chunks
  of 1, 7 or anything else yields the state one whole-stream
  ``run_stream`` yields.
* **Carried state.** Each feed consumes the session's state (the engines
  update its O(n) leaves in place) — copy what you want to keep from
  ``part.state`` (``repro_torch.core.state.state_to_numpy``).
* **Engine selection.** Full windows of ``window`` events ride the window
  engines (the ADD-only kernel for pure-ADD windows, the mixed-window
  kernel otherwise); small tails ride the faithful per-event loop. Both
  are bit-identical, so the choice is throughput only. With
  ``use_kernel=True`` full windows run through the CUDA kernels —
  ``partition_affinity`` for pure-ADD windows, ``fused_chooser`` for mixed
  ones — and ``metrics()`` reports ``kernel_windows`` vs
  ``fallback_windows``.
* **Elastic geometry.** ``feed()`` grows ``(n, max_deg)`` along
  power-of-two tiers whenever an event needs more — a semantics no-op.

Snapshot/restore, compact/shrink, the external-id map, rebalancing and
vertex-sharded sessions are later slices of the port (ROADMAP A9, A10,
A12, A16): their arguments raise ``NotImplementedError`` when set.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import engine as eng
from repro_torch.core import windowed as wnd
from repro_torch.core.config import EngineConfig, POLICIES
from repro_torch.core.geometry import Geometry, geometry_of, grow_tier
from repro_torch.core.state import (
    PartitionState, grow_state, init_state, resolve_device, state_bytes,
    state_metrics,
)
from repro_torch.core.transition import EventTrace
from repro_torch.graph.stream import (
    EVENT_ADD, EVENT_PAD, VertexStream, normalize_rows, required_geometry_of,
)

_ENGINES = ("auto", "scan", "windowed")

# constructor arguments of later slices: name -> (default, ROADMAP item)
_DEFERRED = {
    "auto_shrink": (False, "A10 (compact/shrink)"),
    "shrink_every": (4096, "A10 (compact/shrink)"),
    "auto_rebalance": (False, "A12 (rebalancing)"),
    "rebalance_every": (2048, "A12 (rebalancing)"),
    "rebalance_m": (32, "A12 (rebalancing)"),
    "rebalance_passes": (0, "A12 (rebalancing)"),
    "rebalance_slack": (0.25, "A12 (rebalancing)"),
    "rebalance_drift": (None, "A12 (rebalancing)"),
    "sharded": (False, "A16 (vertex-sharded sessions)"),
    "shard_devices": (None, "A16 (vertex-sharded sessions)"),
}


def _later(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported to the PyTorch session yet — ROADMAP {item}")


class PreparedChunk(NamedTuple):
    """The host-side half of a ``feed()``: validated, dtype-coerced event
    arrays plus their ingestion requirement (``Partitioner.prepare``)."""

    etype: np.ndarray    # (T,) int32 event codes
    vertex: np.ndarray   # (T,) int32 subject vertices
    nbrs: np.ndarray     # (T, width) int32 neighbour rows, -1 padded
    required: Geometry   # minimal geometry able to ingest these events

    @property
    def num_events(self) -> int:
        return int(self.etype.shape[0])


class Partitioner:
    """A stateful streaming partitioning session (see module docstring).

    Args:
      cfg: engine knobs (validated in ``EngineConfig.__post_init__``).
      n: starting vertex-universe size (optional — grows on demand).
      max_deg: starting neighbour-row width (optional, grows like ``n``).
      policy: one of ``repro_torch.core.config.POLICIES``.
      seed: PRNG seed (folds with the global event index).
      engine: ``"auto"`` (windows for full windows, the per-event loop for
        tails), ``"scan"``, or ``"windowed"`` (tails padded into a window
        of no-op events).
      window: events per step of the window engines.
      collect_trace: record the per-event :class:`EventTrace`; forces the
        per-event loop (the window engines produce no trace).
      use_kernel: route full windows through the CUDA kernels (their plain
        versions when the session lives on the CPU).
      device: where the state lives; ``None`` is the CUDA card, and a
        machine without one raises. Pass ``"cpu"`` for the plain versions.

    The remaining keyword arguments belong to later slices and raise
    ``NotImplementedError`` at any value but their default.
    """

    def __init__(self, cfg: EngineConfig | None = None, *,
                 n: int | None = None, max_deg: int | None = None,
                 policy: str = "sdp", seed: int = 0,
                 engine: str = "auto", window: int = 256,
                 collect_trace: bool = False, use_kernel: bool = False,
                 device=None, **later):
        for name, value in later.items():
            if name not in _DEFERRED:
                raise TypeError(f"Partitioner() got an unexpected keyword "
                                f"argument {name!r}")
            default, item = _DEFERRED[name]
            if value != default:
                _later(f"{name}={value!r}", item)
        cfg = cfg or EngineConfig()
        if policy not in POLICIES:
            raise ValueError(
                f"policy={policy!r} is unknown: expected one of {POLICIES}")
        if engine not in _ENGINES:
            raise ValueError(
                f"engine={engine!r} is unknown: expected one of {_ENGINES} "
                "('auto' picks windows for full windows and the per-event "
                "loop for small tails)")
        if window <= 0:
            raise ValueError(
                f"window={window} must be > 0: it is the number of events "
                "the windowed backend batches per step")
        if (n is not None and n <= 0) or (max_deg is not None
                                          and max_deg <= 0):
            raise ValueError(
                f"n={n} and max_deg={max_deg} must be > 0 (or omitted to "
                "grow on demand): they size the dense (n, max_deg) "
                "adjacency")
        if collect_trace and engine == "windowed":
            raise ValueError(
                "collect_trace=True needs the per-event loop (the window "
                "engines do not produce traces) — use engine='scan' or "
                "'auto'")
        self.cfg = cfg
        self.policy = policy
        self.engine = engine
        self.window = int(window)
        self.collect_trace = bool(collect_trace)
        self.use_kernel = bool(use_kernel)
        self.device = resolve_device(device)
        if use_kernel:
            from repro_torch.kernels.fused_chooser import ops as fops
            from repro_torch.kernels.partition_affinity import ops as pops
            self._score_fn = pops.scores_for_state
            self._mixed_fn = fops.run_window_mixed_fused
        else:
            self._score_fn = None
            self._mixed_fn = wnd.run_window_mixed
        self._kernel_windows = 0
        self._fallback_windows = 0
        self._state = init_state(int(n or 1), int(max_deg or 1), cfg.k_max,
                                 cfg.k_init, seed, device=self.device)
        self._regeometries = 0
        self._cursor = 0
        self._geometry_events: list[dict] = []
        self._traces: list[EventTrace] = []

    @classmethod
    def from_stream(cls, stream: VertexStream,
                    cfg: EngineConfig | None = None, **kw) -> "Partitioner":
        """Size a session for ``stream``'s vertex universe and degree cap
        (the stream itself is NOT ingested — call ``feed``)."""
        geom = Geometry(stream.n, stream.max_deg).union(
            stream.required_geometry())
        return cls(cfg, n=geom.n, max_deg=geom.max_deg, **kw)

    # -- properties ---------------------------------------------------------

    @property
    def state(self) -> PartitionState:
        """The live device-resident state; the next ``feed()`` consumes it."""
        return self._state

    @property
    def n(self) -> int:
        """Current vertex-universe allocation (grows on demand)."""
        return int(self._state.assignment.shape[0])

    @property
    def max_deg(self) -> int:
        """Current neighbour-row width (grows on demand)."""
        return int(self._state.adj.shape[1])

    @property
    def geometry(self) -> Geometry:
        """The session's current :class:`Geometry` (n, max_deg, k_max)."""
        return geometry_of(self._state)

    @property
    def regeometries(self) -> int:
        """How many times the state geometry grew."""
        return self._regeometries

    @property
    def geometry_events(self) -> list[dict]:
        """One ``{"cursor", "kind", "from", "to"}`` dict per growth."""
        return list(self._geometry_events)

    @property
    def cursor(self) -> int:
        """Global index of the next event (== events ingested so far)."""
        return self._cursor

    def __repr__(self) -> str:
        return (f"Partitioner(policy={self.policy!r}, engine={self.engine!r},"
                f" n={self.n}, max_deg={self.max_deg}, events={self._cursor},"
                f" device={self.device})")

    # -- geometry -----------------------------------------------------------

    def grow_to(self, n: int | None = None,
                max_deg: int | None = None) -> "Partitioner":
        """Explicitly pre-size the session geometry (exact, no tier
        rounding); never shrinks."""
        cur = geometry_of(self._state)
        target = cur.union(Geometry(int(n or 1), int(max_deg or 1)))
        if target != cur:
            self._grow(cur, target)
        return self

    def _grow(self, cur: Geometry, target: Geometry) -> None:
        self._state = grow_state(self._state, target)
        self._regeometries += 1
        self._geometry_events.append(
            {"cursor": self._cursor, "kind": "grow", "from": cur,
             "to": target})

    def _ensure_geometry(self, required: Geometry) -> None:
        """Grow along power-of-two tiers until the state covers
        ``required`` — the feed-time auto-grow (a semantics no-op)."""
        cur = geometry_of(self._state)
        if not cur.covers(required):
            self._grow(cur, grow_tier(cur, required))

    # -- ingestion ----------------------------------------------------------

    def feed(self, events) -> "Partitioner":
        """Ingest any number of events; returns ``self`` for chaining.

        ``events`` is a :class:`VertexStream` or an ``(etype, vertex,
        nbrs)`` triple of arrays. Bit-identical to one whole-stream run
        regardless of chopping. Work is enqueued on the device
        asynchronously — ``sync()`` waits for it."""
        return self.feed_prepared(self.prepare(events))

    def prepare(self, events) -> PreparedChunk:
        """Host-only coercion and validation of ``events`` — touches no
        session state."""
        if isinstance(events, VertexStream):
            et = np.asarray(events.etype, np.int32)
            vx = np.asarray(events.vertex, np.int32)
            nb = np.asarray(events.nbrs, np.int32)
            required = events.required_geometry()
        else:
            try:
                et, vx, nb = events
            except (TypeError, ValueError):
                raise TypeError(
                    "feed() takes a VertexStream or an (etype, vertex, "
                    f"nbrs) triple, got {type(events).__name__}") from None
            et = np.atleast_1d(np.asarray(et, np.int32))
            vx = np.atleast_1d(np.asarray(vx, np.int32))
            nb = np.asarray(nb, np.int32)
            if nb.ndim != 2 or et.shape != vx.shape \
                    or nb.shape[0] != et.shape[0]:
                raise ValueError(
                    f"event triple shapes disagree: etype{et.shape}, "
                    f"vertex{vx.shape}, nbrs{nb.shape} — want (T,), (T,), "
                    "(T, max_deg)")
            required = required_geometry_of(vx, nb)
        return PreparedChunk(et, vx, nb, required)

    def feed_prepared(self, chunk: PreparedChunk) -> "Partitioner":
        """Ingest a :class:`PreparedChunk`: grow the geometry if needed,
        re-width the rows to the session, copy the events to the device
        once, and run the engines slice by slice."""
        self._ensure_geometry(chunk.required)
        T = chunk.num_events
        if T == 0:
            return self
        et = chunk.etype
        dev = self.device
        et_d = torch.tensor(et, device=dev)
        vx = torch.tensor(chunk.vertex, device=dev)
        nb = torch.tensor(normalize_rows(chunk.nbrs, self.max_deg), device=dev)
        use_scan = self.collect_trace or self.engine == "scan"
        t = 0
        while t < T:
            if use_scan:
                end = T
                self._feed_scan(et_d[t:], vx[t:], nb[t:])
            else:
                end = min(t + self.window, T)
                if end - t < self.window and self.engine == "auto":
                    # small tail: the per-event loop beats padding a
                    # nearly-empty window through the window engines
                    end = T
                    self._feed_scan(et_d[t:], vx[t:], nb[t:])
                else:
                    self._feed_window(et[t:end], et_d[t:end], vx[t:end],
                                      nb[t:end])
            # advance per processed slice, so a failure in a later slice
            # leaves the cursor matching the state
            self._cursor += end - t
            t = end
        return self

    def _feed_scan(self, et, vx, nb):
        # the per-event loop is outside the kernel surface (it is the
        # faithful reference) — count it as fallback coverage
        self._fallback_windows += 1
        self._state, tr = eng.run_events(
            self._state, et, vx, nb, self._cursor, policy=self.policy,
            cfg=self.cfg)
        if self.collect_trace:
            self._traces.append(tr)

    def _feed_window(self, et_host, et, vx, nb):
        """One (possibly right-padded) window. Pad slots are no-ops that
        occupy RNG indices past the true events; the cursor advances by
        the true count only."""
        if self.use_kernel:
            self._kernel_windows += 1
        else:
            self._fallback_windows += 1
        w = self.window
        vs_w = wnd._pad_to(vx, w, -1)
        rows_w = wnd._pad_to(nb, w, -1)
        if np.all(et_host == EVENT_ADD):
            self._state = wnd.run_window_adds(
                self._state, vs_w, rows_w, self._cursor, policy=self.policy,
                cfg=self.cfg, score_fn=self._score_fn)
        else:
            self._state = self._mixed_fn(
                self._state, wnd._pad_to(et, w, EVENT_PAD), vs_w, rows_w,
                self._cursor, policy=self.policy, cfg=self.cfg)

    def sync(self) -> "Partitioner":
        """Block until every enqueued feed has executed on the device."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    # -- observation --------------------------------------------------------

    def metrics(self) -> dict:
        """Paper metrics (Eq. 9 edge-cut ratio, Eq. 10 imbalance, scaling
        counters) of the state as of the last ``feed``, plus the session
        counters. Reads the device (a query point)."""
        m = state_metrics(self._state)
        m["events_ingested"] = self._cursor
        m["cursor"] = self._cursor
        m["n"] = self.n
        m["max_deg"] = self.max_deg
        m["regeometries"] = self._regeometries
        m["state_bytes"] = state_bytes(self._state)
        # kernel coverage: windows that rode the kernels vs the plain
        # engines (per-event loop slices count as one fallback unit each)
        m["kernel_windows"] = self._kernel_windows
        m["fallback_windows"] = self._fallback_windows
        return m

    def trace(self) -> EventTrace:
        """The per-event trace of everything ingested so far (requires
        ``collect_trace=True``)."""
        if not self.collect_trace:
            raise RuntimeError(
                "this session does not collect per-event traces — construct"
                " Partitioner(..., collect_trace=True) (forces the per-event"
                " loop, which is the one producing traces)")
        if not self._traces:
            z = torch.zeros((0,), dtype=torch.int32, device=self.device)
            return EventTrace(z, z, z, z.to(torch.float32))
        if len(self._traces) > 1:
            self._traces = [EventTrace(*(
                torch.cat([getattr(tr, f) for tr in self._traces])
                for f in EventTrace._fields))]
        return self._traces[0]

    # -- later slices -------------------------------------------------------

    def snapshot(self, *a, **kw):
        _later("snapshot()", "A9/A10 (checkpoints, snapshot/restore)")

    @classmethod
    def restore(cls, *a, **kw):
        _later("restore()", "A9/A10 (checkpoints, snapshot/restore)")

    def compact(self, *a, **kw):
        _later("compact()", "A10 (compact/shrink)")

    def shrink_to(self, *a, **kw):
        _later("shrink_to()", "A10 (compact/shrink)")

    def rebalance(self, *a, **kw):
        _later("rebalance()", "A12 (rebalancing)")
