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
  ``partition_affinity``, ``window_rng`` and the pure-ADD fixup
  (``fused_chooser.add_window_choose``) for pure-ADD windows;
  ``window_prep``, ``window_rng`` and ``fused_chooser`` for mixed ones —
  and ``metrics()`` reports ``kernel_windows`` vs ``fallback_windows``,
  and the window engines' ``add_windows`` vs ``mixed_windows``.
  A window reads nothing back from the card: the only host decision, the
  pure-ADD test, reads the host's copy of the event types.
* **Elastic geometry, both directions.** ``feed()`` grows ``(n,
  max_deg)`` along power-of-two tiers whenever an event needs more — a
  semantics no-op. ``compact()`` densely re-packs the live vertices to the
  smallest tier, ``shrink_to()`` targets an exact geometry, and
  ``maybe_shrink()`` (or ``auto_shrink=True``) applies the hysteretic
  ``shrink_tier`` policy, so a session that bulk-deleted most of its graph
  stops paying for its peak tier. Every change is in ``geometry_events``.
* **Rebalancing.** ``rebalance()`` runs greedy migration and LPA
  refinement between feeds (``repro_torch.rebalance``), its label
  histograms on the ``partition_affinity`` kernel when ``use_kernel=True``;
  ``auto_rebalance`` fires it every ``rebalance_every`` events and
  ``rebalance_drift`` when the cut or the imbalance drifts. A pass never
  advances ``state.key`` or the cursor.
* **Resumability.** ``snapshot()`` / ``Partitioner.restore()`` write and
  read the JAX package's checkpoint format (``repro_torch.checkpoint``):
  a checkpoint either package wrote, the other restores.

External vs internal vertex ids
-------------------------------
A compaction may *relabel* vertices. The session hides that: callers keep
using their original ("external") ids in events and queries, and the
session keeps the external→internal map (persisted by ``snapshot()``),
exposed as ``to_internal`` / ``to_external``. Until the first relabelling
compaction the map is the identity and costs nothing; id-preserving
shrinks never create one. Relabelling is a semantics no-op for every
policy except ``hash`` (which assigns by raw id — relabelling compaction
refuses it) and LDG's allocated-``n`` capacity knob, as in the JAX
package.

``place(device)`` moves a live session to another device (a host
round-trip).

Vertex-sharded sessions
-----------------------
``sharded=True`` splits the O(n) state into row blocks over a vertices
mesh (``shard_devices``: an int, a device sequence — a device may repeat —
or None for every CUDA card; see ``repro_torch.launch.mesh``) and runs
every slice as (padded) windows through ``runtime.shard_session``: each
block's ``window_prep_rows``, the slot loop once on the lead device, each
block's apply. The session stays bit-identical to a dense one: the knobs
and checkpoints see the *semantic* geometry (what a dense session would
allocate), the row count is padded to a multiple of the mesh. Geometry
changes, ``rebalance()`` and ``compact()`` gather the rows to the lead
device, work dense and re-shard; ``reshard(devices)`` moves the session to
another mesh, and ``snapshot()`` writes the canonical dense rows, so dense
and sharded sessions of any width restore each other's checkpoints.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import engine as eng
from repro_torch.core import windowed as wnd
from repro_torch.core.config import EngineConfig, POLICIES
from repro_torch.core.geometry import (
    Geometry, geometry_of, grow_tier, next_pow2, shrink_tier,
)
from repro_torch.core.metrics import (
    load_imbalance, normalized_load_imbalance,
)
from repro_torch.core.sharded_state import (
    gather_state, n_shards, per_device_state_bytes, shard_state,
    unshard_state,
)
from repro_torch.core.state import (
    PartitionState, compact_state, grow_state, init_state, live_extent,
    recount_cut_matrix, resolve_device, shrink_state, state_bytes,
    state_metrics,
)
from repro_torch.core.transition import EventTrace, knob_tensor
from repro_torch.graph.stream import (
    EVENT_ADD, EVENT_PAD, VertexStream, normalize_rows, required_geometry_of,
)
from repro_torch.kernels.fused_chooser import ops as fops
from repro_torch.kernels.fused_chooser.ops import check_shape_limits
from repro_torch.launch.mesh import resolve_vertices_mesh
from repro_torch.rebalance import rebalance_state

_ENGINES = ("auto", "scan", "windowed")


def _check_kernel_limits(device, *, use_kernel: bool, engine: str,
                         window: int, k_max: int) -> None:
    """A card session with ``use_kernel=True`` (and every sharded card
    session) runs its windows through kernels with shape limits
    (``fused_chooser.ops.check_shape_limits``): check them before any
    window runs, so a session past one raises when it is built, placed,
    re-sharded or restored — never at its first such window, after earlier
    ones committed. No fallback: the plain engines on the card are not a
    substitute. The CPU's plain versions have no limit."""
    dev = torch.device("cuda" if device is None else device)
    if use_kernel and engine != "scan" and dev.type == "cuda":
        check_shape_limits(window, k_max)


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
        versions when the session lives on the CPU). On the card a
        ``window`` or ``cfg.k_max`` past the kernels' shape limits raises
        here, naming the knob.
      device: where the state lives; ``None`` is the CUDA card, and a
        machine without one raises. Pass ``"cpu"`` for the plain versions.
      auto_shrink: run ``maybe_shrink()`` every ``shrink_every`` ingested
        events (checked at feed boundaries).
      shrink_every: event spacing of the ``auto_shrink`` checks.
      auto_rebalance: run ``rebalance()`` every ``rebalance_every`` ingested
        events (checked at feed boundaries, before the shrink check).
      rebalance_every: event spacing of the ``auto_rebalance`` checks.
      rebalance_m: default migration budget of ``rebalance()``.
      rebalance_passes: default LPA iterations of ``rebalance()``.
      rebalance_slack: Eq. 10 capacity slack — no rebalance move may push a
        destination beyond mean active load × (1 + slack).
      rebalance_drift: after each feed, fire ``rebalance()`` when the cut
        ratio or the normalized imbalance has risen more than this since
        the last pass (the baseline re-bases after every pass and rides
        checkpoint extras).
      sharded: split the O(n) state into row blocks over a vertices mesh
        (module docstring); windows only, launching the kernels on card
        blocks and running their plain versions on CPU ones.
      shard_devices: the mesh of a sharded session — None (every CUDA
        card, or ``[device]`` when ``device`` is given), an int (the first
        N cards) or a device sequence (entries may repeat).
    """

    def __init__(self, cfg: EngineConfig | None = None, *,
                 n: int | None = None, max_deg: int | None = None,
                 policy: str = "sdp", seed: int = 0,
                 engine: str = "auto", window: int = 256,
                 collect_trace: bool = False, use_kernel: bool = False,
                 auto_shrink: bool = False, shrink_every: int = 4096,
                 auto_rebalance: bool = False, rebalance_every: int = 2048,
                 rebalance_m: int = 32, rebalance_passes: int = 0,
                 rebalance_slack: float = 0.25,
                 rebalance_drift: float | None = None,
                 sharded: bool = False, shard_devices=None,
                 device=None):
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
        if sharded:
            if use_kernel:
                raise ValueError(
                    "sharded=True launches its kernels by the device of its "
                    "row blocks (the CUDA kernels on a card, their plain "
                    "versions on the CPU) — use_kernel does not apply to "
                    "it; drop use_kernel")
            if collect_trace or engine == "scan":
                raise ValueError(
                    "sharded=True processes every slice as (padded) "
                    "windows on the vertices mesh — the per-event loop "
                    "(engine='scan' / collect_trace=True) has no sharded "
                    "counterpart")
        if shrink_every <= 0:
            raise ValueError(
                f"shrink_every={shrink_every} must be > 0: it is the "
                "event spacing of the auto_shrink checks")
        if rebalance_every <= 0:
            raise ValueError(
                f"rebalance_every={rebalance_every} must be > 0: it is "
                "the event spacing of the auto_rebalance checks")
        if rebalance_m < 0 or rebalance_passes < 0 or rebalance_slack < 0:
            raise ValueError(
                f"rebalance_m={rebalance_m}, rebalance_passes="
                f"{rebalance_passes} and rebalance_slack={rebalance_slack} "
                "must all be >= 0 (m is a move budget, passes an iteration "
                "count, slack a capacity fraction)")
        if auto_rebalance and rebalance_m == 0 and rebalance_passes == 0:
            raise ValueError(
                "auto_rebalance=True with rebalance_m=0 and "
                "rebalance_passes=0 would run empty passes forever — give "
                "it a migration budget (rebalance_m) and/or LPA "
                "iterations (rebalance_passes)")
        if rebalance_drift is not None:
            if rebalance_drift <= 0:
                raise ValueError(
                    f"rebalance_drift={rebalance_drift} must be > 0: it "
                    "is the cut-ratio / imbalance increase (since the "
                    "last pass) that triggers an adaptive rebalance")
            if rebalance_m == 0 and rebalance_passes == 0:
                raise ValueError(
                    "rebalance_drift with rebalance_m=0 and "
                    "rebalance_passes=0 would fire empty passes — give "
                    "it a migration budget and/or LPA iterations")
        self._sharded = bool(sharded)
        self._mesh = None
        if self._sharded:
            self._mesh = resolve_vertices_mesh(shard_devices, device)
            device = self._mesh.lead
        _check_kernel_limits(device, use_kernel=use_kernel or self._sharded,
                             engine=engine, window=window, k_max=cfg.k_max)
        self.cfg = cfg
        self.policy = policy
        self.engine = engine
        self.window = int(window)
        self.collect_trace = bool(collect_trace)
        self.use_kernel = bool(use_kernel)
        self.device = resolve_device(device)
        if use_kernel:
            from repro_torch.kernels.fused_chooser import ops as fops
            self._adds_fn = fops.run_window_adds_fused
            self._mixed_fn = fops.run_window_mixed_fused
        else:
            self._adds_fn = wnd.run_window_adds
            self._mixed_fn = wnd.run_window_mixed
        self.auto_shrink = bool(auto_shrink)
        self.shrink_every = int(shrink_every)
        self.auto_rebalance = bool(auto_rebalance)
        self.rebalance_every = int(rebalance_every)
        self.rebalance_m = int(rebalance_m)
        self.rebalance_passes = int(rebalance_passes)
        self.rebalance_slack = float(rebalance_slack)
        self.rebalance_drift = (None if rebalance_drift is None
                                else float(rebalance_drift))
        self._drift_base: tuple[float, float] | None = None
        self._drift_fires = 0
        self._last_rebalance = 0
        self._rebalances = 0
        self._rebalance_moves = 0
        self._rebalance_events: list[dict] = []
        self._kernel_windows = 0
        self._fallback_windows = 0
        self._add_windows = 0
        self._mixed_windows = 0
        # the semantic geometry: what a dense session would allocate — what
        # the knobs (LDG capacity) and checkpoints see; a sharded session's
        # row count is this, padded to a multiple of the mesh
        self._sem_geom: Geometry | None = None
        self._set_state(init_state(int(n or 1), int(max_deg or 1),
                                   cfg.k_max, cfg.k_init, seed,
                                   device=self.device))
        self._regeometries = 0
        self._shrinks = 0
        self._compactions = 0
        self._last_shrink_check = 0
        self._cursor = 0
        # external→internal vertex-id map (None = identity: no relabelling
        # compaction yet) and its dense inverse
        self._ext2int: np.ndarray | None = None
        self._int2ext: np.ndarray | None = None
        self._geometry_events: list[dict] = []
        self._traces: list[EventTrace] = []
        self._managers: dict[str, CheckpointManager] = {}

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
        """Current vertex-universe allocation (grows on demand, shrinks via
        ``compact`` / ``shrink_to`` / ``maybe_shrink``). Internal slots:
        after a relabelling compaction it is smaller than the external id
        space (see ``to_internal``)."""
        return int(self._state.assignment.shape[0])

    @property
    def max_deg(self) -> int:
        """Current neighbour-row width (grows on demand, shrinks with
        ``n``)."""
        return int(self._state.adj.shape[1])

    @property
    def geometry(self) -> Geometry:
        """The session's current :class:`Geometry` (n, max_deg, k_max)."""
        return geometry_of(self._state)

    @property
    def regeometries(self) -> int:
        """How many times the state geometry changed (grow, shrink or a
        tier-changing compact)."""
        return self._regeometries

    @property
    def geometry_events(self) -> list[dict]:
        """One ``{"cursor", "kind", "from", "to"}`` dict per change, ``kind``
        in ``{"grow", "shrink", "compact", "restore"}`` (``compact`` is a
        same-tier re-pack; a tier-dropping one records ``shrink``)."""
        return list(self._geometry_events)

    @property
    def rebalance_events(self) -> list[dict]:
        """One ``{"cursor", "m", "passes", "moved", "cut_before",
        "cut_after", "imbalance_before", "imbalance_after"}`` dict per
        executed ``rebalance()``."""
        return list(self._rebalance_events)

    @property
    def cursor(self) -> int:
        """Global index of the next event (== events ingested so far)."""
        return self._cursor

    @property
    def sharded(self) -> bool:
        """Whether the state lives in row blocks over a vertices mesh."""
        return self._sharded

    @property
    def mesh(self):
        """The vertices mesh of a sharded session (None when dense)."""
        return self._mesh

    def __repr__(self) -> str:
        return (f"Partitioner(policy={self.policy!r}, engine={self.engine!r},"
                f" n={self.n}, max_deg={self.max_deg}, events={self._cursor},"
                f" device={self.device}"
                + (f", shards={n_shards(self._mesh)})" if self._sharded
                   else ")"))

    # -- geometry -----------------------------------------------------------

    def grow_to(self, n: int | None = None,
                max_deg: int | None = None) -> "Partitioner":
        """Explicitly pre-size the session geometry (exact, no tier
        rounding); never shrinks."""
        cur = self._sem_geometry()
        target = cur.union(Geometry(int(n or 1), int(max_deg or 1)))
        if target != cur:
            self._grow(cur, target)
        return self

    def _sem_geometry(self) -> Geometry:
        """The session's semantic geometry: what a dense session would
        allocate. A sharded session's rows are this, padded to a multiple
        of the mesh."""
        return self._sem_geom if self._sharded else geometry_of(self._state)

    def _dense(self) -> PartitionState:
        """The state in the dense layout on the session's device: a sharded
        session's rows gathered at the semantic n (a new state; the
        session's own is unchanged), a dense session's state itself."""
        if self._sharded:
            return unshard_state(self._state, n=self._sem_geom.n)
        return self._state

    def _record_geometry(self, kind: str, before: Geometry,
                         after: Geometry) -> None:
        self._geometry_events.append(
            {"cursor": self._cursor, "kind": kind, "from": before,
             "to": after})

    def _set_state(self, state: PartitionState) -> None:
        """Adopt a dense state of another geometry (the LDG knob reads the
        semantic ``n``); a sharded session places it on its mesh, rows
        padded to a multiple of the shard count."""
        if self._sharded:
            self._sem_geom = geometry_of(state)
            self._state = shard_state(state, self._mesh)
        else:
            self._state = state
        self._knobs = knob_tensor(self.cfg, self._sem_geometry().n,
                                  self.device)

    def _grow(self, cur: Geometry, target: Geometry) -> None:
        self._set_state(grow_state(self._dense(), target))
        self._regeometries += 1
        self._record_geometry("grow", cur, target)

    def _ensure_geometry(self, required: Geometry) -> None:
        """Grow along power-of-two tiers until the state covers
        ``required`` — the feed-time auto-grow (a semantics no-op). The tier
        trigger compares the semantic geometry, so a sharded session grows
        at exactly the cursors its dense twin would."""
        cur = self._sem_geometry()
        if not cur.covers(required):
            self._grow(cur, grow_tier(cur, required))

    def _repack_to(self, target: Geometry, kind: str) -> None:
        """Move the state to ``target``: the id-preserving truncation
        (``shrink_state``) when the live slots fit below ``target.n``, else
        the relabelling re-pack (``compact_state``), folding its
        permutation into the id maps. Callers guarantee that ``target``
        covers the packed extent. A sharded session repacks its gathered
        dense rows and re-shards."""
        cur = self._sem_geometry()
        if target == cur:
            return
        dense = self._dense()
        _, prefix = live_extent(dense)
        if prefix.n <= target.n and prefix.max_deg <= target.max_deg:
            self._set_state(shrink_state(dense, target))
        else:
            if self.policy == "hash":
                raise ValueError(
                    "the 'hash' policy assigns by raw vertex id, so a "
                    "relabeling compaction would change every future "
                    "decision — only id-preserving shrinks are legal "
                    "(shrink_to a geometry the current slot ids fit, or "
                    "accept the current tier)")
            state, perm = compact_state(dense, target)
            self._set_state(state)
            self._apply_perm(perm)
        self._regeometries += 1
        if kind == "shrink":
            self._shrinks += 1
        self._record_geometry(kind, cur, target)

    def _apply_perm(self, perm: np.ndarray) -> None:
        """Fold a relabelling permutation (old slot → new slot, -1 =
        dropped) into the external→internal maps. On the first relabel the
        external ids are the old slots, so the map starts as ``perm``."""
        keep_idx = np.flatnonzero(perm >= 0).astype(np.int32)
        if len(keep_idx) == len(perm):
            return  # nothing moved or dropped — still the identity
        if self._ext2int is None:
            self._ext2int = perm.astype(np.int32).copy()
            self._int2ext = keep_idx
        else:
            self._int2ext = self._int2ext[keep_idx]
            m = self._ext2int
            valid = m >= 0
            m[valid] = perm[m[valid]]
            self._ext2int = m

    def compact(self) -> "Partitioner":
        """Densely re-pack the live vertices and drop to the smallest
        power-of-two tier that holds them (no hysteresis: the caller has
        decided). Prefers the id-preserving truncation; otherwise relabels
        and keeps the external-id map, so ``feed`` and ``to_internal`` go
        on speaking original ids. Counters are untouched. Reads the device
        (ordered on the current stream after every enqueued feed)."""
        cur = self._sem_geometry()
        packed, _ = live_extent(self._dense())
        target = Geometry(min(next_pow2(packed.n), cur.n),
                          min(next_pow2(packed.max_deg), cur.max_deg),
                          cur.k_max)
        self._compactions += 1
        self._repack_to(target, "shrink" if (target.n < cur.n
                        or target.max_deg < cur.max_deg) else "compact")
        return self

    def shrink_to(self, n: int | None = None,
                  max_deg: int | None = None) -> "Partitioner":
        """Shrink the session to exactly ``(n, max_deg)`` (an omitted
        dimension keeps its size) — the counterpart of ``grow_to``.
        Truncates when the live slot ids fit, else re-packs (relabelling,
        see ``compact``). Raises if the live content cannot fit even
        packed, or if a dimension would grow."""
        cur = self._sem_geometry()
        target = Geometry(int(n if n is not None else cur.n),
                          int(max_deg if max_deg is not None
                              else cur.max_deg), cur.k_max)
        if target.n > cur.n or target.max_deg > cur.max_deg:
            raise ValueError(
                f"shrink_to target (n={target.n}, max_deg={target.max_deg})"
                f" exceeds the current geometry (n={cur.n}, "
                f"max_deg={cur.max_deg}) — growing is grow_to's job")
        packed, _ = live_extent(self._dense())
        if not Geometry(target.n, target.max_deg).covers(
                Geometry(packed.n, packed.max_deg)):
            raise ValueError(
                f"live content needs (n={packed.n}, "
                f"max_deg={packed.max_deg}) even densely packed — "
                f"(n={target.n}, max_deg={target.max_deg}) cannot hold "
                "this session")
        self._repack_to(target, "shrink")
        return self

    def maybe_shrink(self, *, hysteresis: int = 4) -> bool:
        """The auto-shrink check: apply ``shrink_tier`` (shrink a dimension
        only when live content fills at most ``1 / (2 * hysteresis)`` of
        it) and re-pack if any dimension qualifies. Returns True iff the
        geometry changed. A one-scalar device read (the present count)
        gates the scan of the live content."""
        cur = self._sem_geometry()
        if self._sharded:
            n_present = int(sum(b.sum().to(self.device)
                                for b in self._state.present.blocks))
        else:
            n_present = int(self._state.present.sum())
        if (n_present + 1) * 2 * hysteresis > cur.n:
            return False
        packed, _ = live_extent(self._dense())
        target = shrink_tier(cur, packed, hysteresis=hysteresis)
        if target == cur:
            return False
        self._repack_to(target, "shrink")
        return True

    def place(self, device) -> "Partitioner":
        """Move the session onto ``device`` through a host round-trip (card
        to CPU, CPU to card, or card to card) — the single-device re-mesh
        path: after a (simulated) device loss the session goes on feeding
        there bit-identically (placement is not semantics). Everything tied
        to the device moves or is remade: the state's tensors (the RNG key
        among them), ``device``, the knobs tensor and any collected traces.
        Syncs. Returns ``self``. A kernel session moving onto the card
        checks the kernels' shape limits first. A sharded session moves with
        ``reshard`` instead (this raises)."""
        if self._sharded:
            raise ValueError(
                "this session is vertex-sharded across a device mesh — "
                "single-device place() does not apply; use "
                "reshard(devices=...) to move it onto a different mesh")
        _check_kernel_limits(device, use_kernel=self.use_kernel,
                             engine=self.engine, window=self.window,
                             k_max=int(self._state.edge_load.shape[0]))
        dev = resolve_device(device)
        self.sync()
        host = [t.cpu() for t in self._state]
        self.device = dev
        self._set_state(PartitionState(*(t.to(dev) for t in host)))
        self._traces = [EventTrace(*(x.to(dev) for x in tr))
                        for tr in self._traces]
        return self

    def reshard(self, devices=None) -> "Partitioner":
        """Move a ``sharded=True`` session onto another vertices mesh
        (``devices``: an int, a device sequence, or None for every CUDA
        card) — the sharded re-mesh after a device-count change: gather the
        canonical dense rows, build the mesh, re-pad the rows to the new
        shard count and re-place. Placement is not semantics, so the
        session goes on bit-identically. A card mesh checks the kernels'
        shape limits first. Syncs. Returns ``self``."""
        if not self._sharded:
            raise ValueError(
                "reshard() applies to sharded=True sessions only — a "
                "dense session moves with place(device)")
        mesh = resolve_vertices_mesh(devices)
        _check_kernel_limits(mesh.lead, use_kernel=True, engine=self.engine,
                             window=self.window,
                             k_max=int(self._state.edge_load.shape[0]))
        self.sync()
        dense = unshard_state(self._state, n=self._sem_geom.n,
                              device=mesh.lead)
        self._mesh = mesh
        self.device = mesh.lead
        self._set_state(dense)
        return self

    # -- external ids -------------------------------------------------------

    def to_internal(self, ids) -> np.ndarray:
        """External (caller-facing, original) vertex ids → the session's
        internal slots; the identity until a relabelling compaction.
        Unknown or negative ids map to -1."""
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        if self._ext2int is None:
            return ids.astype(np.int32)
        m = self._ext2int
        out = np.full(ids.shape, -1, np.int32)
        ok = (ids >= 0) & (ids < len(m))
        out[ok] = m[ids[ok]]
        return out

    def to_external(self, ids) -> np.ndarray:
        """Inverse of ``to_internal``: internal slots → external ids.
        Out-of-range slots map to -1."""
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        if self._int2ext is None:
            return ids.astype(np.int32)
        m = self._int2ext
        out = np.full(ids.shape, -1, np.int32)
        ok = (ids >= 0) & (ids < len(m))
        out[ok] = m[ids[ok]]
        return out

    def _translate(self, chunk: PreparedChunk) -> PreparedChunk:
        """Rewrite a chunk's external ids to internal slots, giving ids
        never seen since the last relabel fresh slots in first-appearance
        order (vertex before its row — so a replay allocates the same). A
        no-op while the map is the identity."""
        if self._ext2int is None:
            return chunk
        vx, nb = chunk.vertex, chunk.nbrs
        seq = np.concatenate([vx[:, None], nb], axis=1).ravel()
        seq = seq[seq >= 0].astype(np.int64)
        m = self._ext2int
        if seq.size:
            mx = int(seq.max())
            if mx >= len(m):
                m = np.concatenate(
                    [m, np.full(mx + 1 - len(m), -1, np.int32)])
            unmapped = seq[m[seq] < 0]
            if unmapped.size:
                uniq, first = np.unique(unmapped, return_index=True)
                order = uniq[np.argsort(first)].astype(np.int32)
                base = len(self._int2ext)
                m[order] = np.arange(base, base + len(order),
                                     dtype=np.int32)
                self._int2ext = np.concatenate([self._int2ext, order])
            self._ext2int = m
        vx_t = np.where(vx >= 0, m[np.clip(vx, 0, None)], -1).astype(np.int32)
        nb_t = np.where(nb >= 0, m[np.clip(nb, 0, None)], -1).astype(np.int32)
        return PreparedChunk(chunk.etype, vx_t, nb_t,
                             required_geometry_of(vx_t, nb_t))

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
        """Ingest a :class:`PreparedChunk`: translate external ids, grow the
        geometry if needed, re-width the rows to the session, copy the
        events to the device once, run the engines slice by slice, then
        the auto-rebalance, drift and auto-shrink checks."""
        chunk = self._translate(chunk)
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
        windows = self.windows_drawn_ahead(T)
        tables = (fops.WindowTables(self.window,
                                    self._cursor + windows * self.window)
                  if windows else None)
        t = 0
        while t < T:
            if use_scan:
                end = T
                self._feed_scan(et_d[t:], vx[t:], nb[t:])
            else:
                end = min(t + self.window, T)
                if end - t < self.window and self.engine == "auto" \
                        and not self._sharded:
                    # small tail: the per-event loop beats padding a
                    # nearly-empty window through the window engines
                    end = T
                    self._feed_scan(et_d[t:], vx[t:], nb[t:])
                else:
                    self._feed_window(et[t:end], et_d[t:end], vx[t:end],
                                      nb[t:end], tables)
            # advance per processed slice, so a failure in a later slice
            # leaves the cursor matching the state
            self._cursor += end - t
            t = end
        # rebalance before the shrink check: migration changes loads and so
        # what maybe_shrink sees — the order is part of the replay contract
        if self.auto_rebalance and (self._cursor - self._last_rebalance
                                    >= self.rebalance_every):
            self._last_rebalance = self._cursor
            self.rebalance()
        if self.rebalance_drift is not None:
            self._check_drift()
        if self.auto_shrink and (self._cursor - self._last_shrink_check
                                 >= self.shrink_every):
            self._last_shrink_check = self._cursor
            self.maybe_shrink()
        return self

    def windows_drawn_ahead(self, T: int) -> int:
        """How many windows a feed of ``T`` events takes through the kernel
        pipelines with their random tables drawn ahead
        (``fused_chooser.ops.WindowTables``, ``windows_per_draw`` windows a
        ``window_rng`` launch): the full windows under "auto" (its short
        tail rides the per-event loop), every window under "windowed" (the
        tail padded); 0 for a session that runs no kernel window here
        (plain engines, the scan engine, traces, and a sharded session,
        which draws a table a window)."""
        if not self.use_kernel or self.collect_trace or self.engine == "scan":
            return 0
        return T // self.window if self.engine == "auto" \
            else -(-T // self.window)

    def _feed_scan(self, et, vx, nb):
        # the per-event loop is outside the kernel surface (it is the
        # faithful reference) — count it as fallback coverage
        self._fallback_windows += 1
        self._state, tr = eng.run_events(
            self._state, et, vx, nb, self._cursor, policy=self.policy,
            cfg=self.cfg)
        if self.collect_trace:
            self._traces.append(tr)

    def _feed_window(self, et_host, et, vx, nb, tables=None):
        """One (possibly right-padded) window. Pad slots are no-ops that
        occupy RNG indices past the true events; the cursor advances by
        the true count only. A sharded session takes every window through
        ``shard_session.sharded_window`` (the mixed path, as the JAX
        package's). ``tables`` (``fused_chooser.ops.WindowTables``, kernel
        sessions) gives the window its random table from a draw shared
        with the feed's other windows: no window writes ``state.key``, in
        this package or in JAX's ``core/windowed.py``."""
        if self.use_kernel or (self._sharded and self.device.type == "cuda"):
            self._kernel_windows += 1
        else:
            self._fallback_windows += 1
        w = self.window
        vs_w = wnd._pad_to(vx, w, -1)
        rows_w = wnd._pad_to(nb, w, -1)
        if self._sharded:
            from repro_torch.runtime.shard_session import sharded_window
            self._mixed_windows += 1
            self._state = sharded_window(
                self._state, wnd._pad_to(et, w, EVENT_PAD), vs_w, rows_w,
                self._cursor, n_sem=self._sem_geom.n, policy=self.policy,
                cfg=self.cfg, knobs=self._knobs)
            return
        kw = {} if tables is None else {
            "rand_tab": tables.take(self._state, self._cursor)}
        if np.all(et_host == EVENT_ADD):
            self._add_windows += 1
            self._state = self._adds_fn(
                self._state, vs_w, rows_w, self._cursor, policy=self.policy,
                cfg=self.cfg, knobs=self._knobs, **kw)
        else:
            self._mixed_windows += 1
            self._state = self._mixed_fn(
                self._state, wnd._pad_to(et, w, EVENT_PAD), vs_w, rows_w,
                self._cursor, policy=self.policy, cfg=self.cfg,
                knobs=self._knobs, **kw)

    def sync(self) -> "Partitioner":
        """Block until every enqueued feed has executed on the device (on
        every card of a sharded session's mesh)."""
        devices = set(self._mesh.devices) if self._sharded else {self.device}
        for dev in devices:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        return self

    # -- rebalancing --------------------------------------------------------

    def _drift_signals(self) -> tuple[float, float]:
        """(cut ratio, normalized load imbalance) from the counters the
        engines keep — scale-free, so one threshold fits both."""
        tot = int(self._state.total_edges)
        ratio = int(self._state.cut_edges) / tot if tot else 0.0
        imb = normalized_load_imbalance(self._state.edge_load.cpu().numpy(),
                                        self._state.active.cpu().numpy())
        return ratio, float(imb)

    def _check_drift(self) -> bool:
        """The ``rebalance_drift`` check (each feed boundary): fire a pass
        when either signal rose more than the threshold since the last pass
        (or the first check, the baseline). Only an executed pass moves the
        baseline, so slow drift cannot creep under it."""
        ratio, imb = self._drift_signals()
        if self._drift_base is None:
            self._drift_base = (ratio, imb)
            return False
        r0, i0 = self._drift_base
        if (ratio - r0) < self.rebalance_drift \
                and (imb - i0) < self.rebalance_drift:
            return False
        self._drift_fires += 1
        self._last_rebalance = self._cursor
        self.rebalance()
        return True

    def rebalance(self, m: int | None = None, passes: int | None = None,
                  slack: float | None = None) -> dict:
        """One rebalance over the live state: greedy migration of the top
        ``m`` worst-gain vertices, then ``passes`` LPA iterations
        (``repro_torch.rebalance``); defaults from the constructor. Never
        touches ``state.key`` or the cursor; with ``m=0`` and ``passes=0``
        the state is not touched at all. Returns the recorded event (also
        appended to ``rebalance_events``). Reads the device. A sharded
        session rebalances its gathered dense rows on the lead device, the
        histograms on ``partition_affinity`` there when it is a card, and
        re-shards."""
        m = self.rebalance_m if m is None else int(m)
        passes = self.rebalance_passes if passes is None else int(passes)
        slack = self.rebalance_slack if slack is None else float(slack)
        if m <= 0 and passes <= 0:
            return {"cursor": self._cursor, "m": 0, "passes": 0, "moved": 0}
        load0 = self._state.edge_load.cpu().numpy()
        act0 = self._state.active.cpu().numpy()
        dev = self.device
        state, stats = rebalance_state(
            self._dense(), self._cursor,
            torch.tensor(slack, dtype=torch.float32, device=dev),
            torch.tensor(self.cfg.max_cap, dtype=torch.float32, device=dev),
            True, m=min(m, self._sem_geometry().n), passes=passes,
            use_kernel=self.use_kernel or self._sharded)
        if self._sharded:
            self._set_state(state)
        else:
            self._state = state
        ev = {"cursor": self._cursor, "m": m, "passes": passes,
              "moved": int(stats.moved),
              "cut_before": int(stats.cut_before),
              "cut_after": int(stats.cut_after),
              "imbalance_before": load_imbalance(load0, act0),
              "imbalance_after": load_imbalance(
                  self._state.edge_load.cpu().numpy(),
                  self._state.active.cpu().numpy())}
        self._rebalances += 1
        self._rebalance_moves += ev["moved"]
        self._rebalance_events.append(ev)
        if self.rebalance_drift is not None:
            # re-base on the post-pass signals: the next fire needs fresh
            # drift, not this one's residue
            self._drift_base = self._drift_signals()
        return ev

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
        m["shrinks"] = self._shrinks
        m["compactions"] = self._compactions
        m["state_bytes"] = state_bytes(self._state)
        # kernel coverage: windows that rode the kernels vs the plain
        # engines (per-event loop slices count as one fallback unit each)
        m["kernel_windows"] = self._kernel_windows
        m["fallback_windows"] = self._fallback_windows
        # the window engines' windows by kind: pure-ADD and mixed
        m["add_windows"] = self._add_windows
        m["mixed_windows"] = self._mixed_windows
        m["rebalances"] = self._rebalances
        m["rebalance_moves"] = self._rebalance_moves
        m["rebalance_drift_fires"] = self._drift_fires
        # vertex sharding: how many row blocks carry the session, and the
        # peak resident bytes of one mesh entry (its blocks, and the lead
        # entry's unsplit leaves too; state_bytes on a dense session)
        m["shard_devices"] = n_shards(self._mesh) if self._sharded else 1
        m["per_device_state_bytes"] = per_device_state_bytes(self._state)
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

    # -- persistence --------------------------------------------------------

    def snapshot(self, directory: str, *, keep: int = 3,
                 blocking: bool = True) -> int:
        """Checkpoint the session under ``directory`` in the JAX package's
        format (atomic rename, the ``keep`` newest retained); the step is
        the event cursor, which it returns. The state is staged to the host
        before the call returns, so ``blocking=False`` writes on a
        background thread while the next ``feed`` runs; the next snapshot
        to the same directory, or ``wait()``, joins the writer. The id map,
        both cadence marks and the drift baseline ride along as extras."""
        mgr = self._managers.get(directory)
        if mgr is None:
            mgr = CheckpointManager(directory, interval=1, keep=keep)
            self._managers[directory] = mgr
        else:
            mgr.keep = keep
        extras = {}
        if self._ext2int is not None:
            extras["ext2int"] = self._ext2int
        if self._last_shrink_check:
            extras["shrink_mark"] = np.asarray([self._last_shrink_check],
                                               np.int64)
        if self._last_rebalance:
            extras["rebalance_mark"] = np.asarray([self._last_rebalance],
                                                  np.int64)
        if self._drift_base is not None:
            extras["drift_base"] = np.asarray(self._drift_base, np.float64)
        tree, geom = self._state, geometry_of(self._state)
        if self._sharded:
            # the canonical dense rows at the semantic geometry, so dense
            # and sharded sessions of any width restore each other's
            tree, geom = gather_state(self._state, n=self._sem_geom.n), \
                self._sem_geom
        mgr.save_now(self._cursor, tree, blocking=blocking, geometry=geom,
                     extras=extras or None)
        return self._cursor

    def wait(self) -> None:
        """Join any background snapshot writers (a no-op if none)."""
        for mgr in self._managers.values():
            mgr.wait()

    @classmethod
    def restore(cls, directory: str, cfg: EngineConfig | None = None, *,
                n: int | None = None, max_deg: int | None = None,
                step: int | None = None, **kw) -> "Partitioner":
        """Resume a session from a checkpoint (default: the latest step) —
        one this package or the JAX package wrote — on ``device`` (a
        keyword for the constructor; ``None`` is the card). The
        checkpoint's geometry sizes the restore; ``n`` / ``max_deg``
        larger grow it, smaller shrink it (``shrink_to``, which raises if
        the live content cannot fit), and declare the geometry of a
        checkpoint so old that its leaves cannot tell it. A larger
        ``cfg.k_max`` grows the partition slots; a smaller one raises.
        States that predate ``cut_matrix`` restore through ``fill_missing``
        and are healed with ``recount_cut_matrix``. Pass the ``cfg``,
        policy and engine knobs the session ran with (they are not
        stored). Traces are not checkpointed. The session is built first,
        so its knobs (the kernels' shape limits among them) are checked
        before the checkpoint is read. ``sharded=True`` restores into row
        blocks on the session's mesh, whichever layout and width wrote
        the checkpoint."""
        cfg = cfg or EngineConfig()
        # the session starts tier-minimal: its placeholder state is
        # replaced below
        part = cls(cfg, **kw)
        mgr = CheckpointManager(directory, interval=1)
        step = step if step is not None else mgr.latest()
        if step is None:
            raise FileNotFoundError(
                f"no checkpoint found under {directory!r}")
        ck = mgr.geometry(step)
        if ck is None:
            if n is None or max_deg is None:
                raise ValueError(
                    f"checkpoint at step {step} records no geometry and "
                    "none could be inferred from its leaf shapes — pass "
                    "n= and max_deg= explicitly")
            ck = Geometry(int(n), int(max_deg), cfg.k_max)
        if cfg.k_max < (ck.k_max or 0):
            raise ValueError(
                f"checkpoint was taken at k_max={ck.k_max} but "
                f"cfg.k_max={cfg.k_max}: partition-slot shapes grow, "
                "never shrink — raise cfg.k_max")
        target = Geometry(max(int(n or 0), ck.n),
                          max(int(max_deg or 0), ck.max_deg), cfg.k_max)
        # the payload dictates the leaf shapes: a host `like` at the exact
        # checkpoint geometry, each restored leaf placed on the session's
        # device
        like = init_state(ck.n, ck.max_deg, ck.k_max or cfg.k_max,
                          cfg.k_init, 0, device="cpu")
        keys = mgr.leaf_keys(step)
        state, step = mgr.restore(like, step=step, fill_missing=True,
                                  device=part.device)
        k_saved = int(state.edge_load.shape[0])
        if k_saved > cfg.k_max:
            raise ValueError(
                f"checkpoint was taken at k_max={k_saved} but "
                f"cfg.k_max={cfg.k_max}: partition-slot shapes grow, "
                "never shrink — raise cfg.k_max")
        if len(keys) < len(like):
            # pre-cut_matrix checkpoint: fill_missing kept `like`'s zero
            # matrix — rebuild it exactly from the restored adjacency
            state = recount_cut_matrix(state)
        part._set_state(grow_state(state, target))
        part._cursor = int(step)
        ext = mgr.extras(step)
        if "ext2int" in ext:
            e2i = np.asarray(ext["ext2int"], np.int32)
            part._ext2int = e2i
            valid = np.flatnonzero(e2i >= 0)
            slots = int(e2i[valid].max()) + 1 if valid.size else 0
            inv = np.full(slots, -1, np.int32)
            inv[e2i[valid]] = valid.astype(np.int32)
            part._int2ext = inv
        if "shrink_mark" in ext:
            part._last_shrink_check = int(np.asarray(ext["shrink_mark"])[0])
        if "rebalance_mark" in ext:
            part._last_rebalance = int(np.asarray(ext["rebalance_mark"])[0])
        if "drift_base" in ext:
            base = np.asarray(ext["drift_base"])
            part._drift_base = (float(base[0]), float(base[1]))
        part._record_geometry("restore", ck, part._sem_geometry())
        want_n = int(n) if n is not None and n < target.n else None
        want_d = int(max_deg) if max_deg is not None \
            and max_deg < target.max_deg else None
        if want_n is not None or want_d is not None:
            part.shrink_to(n=want_n, max_deg=want_d)
        return part
