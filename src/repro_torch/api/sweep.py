"""The fluent ``Sweep`` — the one validated entry for multi-lane runs (the
port's counterpart of ``repro.api.sweep``):

    results = (Sweep(stream)          # one shared or per-lane streams
               .lanes(runs)           # SweepRun / (policy, cfg, seed)
               .windowed(256)         # or .scan() [default] + .chunked(n)
               .kernel()              # the CUDA kernel lanes
               .run())

Every lane-compatibility rule is checked in ``_validate`` before any
tensor is stacked, with the JAX ``Sweep``'s rules and messages, and on the
card with ``.kernel()`` the kernels' shape limits too
(``fused_chooser.ops.check_shape_limits``). Every lane is bit-identical
to ``run_stream`` on that lane's stream. The lanes live on ``device``
(``None``: the CUDA card, raising without one; ``"cpu"``: the plain
versions). ``sharded()`` keeps JAX's surface and runs the same one-card
path; ``sharded_vertices()`` runs each lane as one vertex-sharded session
over a mesh of row blocks (``runtime.shard_session``).
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core.config import EngineConfig, POLICIES
from repro_torch.graph.stream import VertexStream
from repro_torch.kernels.fused_chooser.ops import check_shape_limits
from repro_torch.runtime.sweep import SweepResult, SweepRun, _execute_sweep


class Sweep:
    """One multi-lane sweep over ``stream``, described fluently (a shared
    :class:`VertexStream`, or a sequence of per-lane streams) on
    ``device``. Every configuration method returns ``self`` for chaining;
    ``run()`` validates the whole description and executes it."""

    def __init__(self, stream: VertexStream | Sequence[VertexStream], *,
                 device=None):
        self._stream = stream
        self._device = device
        self._runs: list[SweepRun] = []
        self._engine = "scan"
        self._window = 256
        self._chunk: int | None = None
        self._shard: bool | None = None
        self._use_kernel = False
        self._rebalance: dict | None = None
        self._shard_vertices = False
        self._shard_devices = None

    # -- lanes --------------------------------------------------------------

    def lane(self, policy: str = "sdp", cfg: EngineConfig | None = None,
             seed: int = 0) -> "Sweep":
        """Append one (policy, cfg, seed) lane."""
        self._runs.append(SweepRun(policy, cfg or EngineConfig(), seed))
        return self

    def lanes(self, runs: Sequence[SweepRun | tuple]) -> "Sweep":
        """Append many lanes (``SweepRun`` or ``(policy, cfg, seed)``)."""
        self._runs.extend(
            r if isinstance(r, SweepRun) else SweepRun(*r) for r in runs)
        return self

    # -- engine -------------------------------------------------------------

    def scan(self) -> "Sweep":
        """Per-event lanes (default): returns per-event traces."""
        self._engine = "scan"
        return self

    def windowed(self, window: int = 256) -> "Sweep":
        """Mixed-event windows of ``window`` events — the fastest engine;
        returns ``trace=None`` per lane."""
        if window <= 0:
            raise ValueError(
                f"window={window} must be > 0: it is the number of events "
                "each lane batches per device step")
        self._engine = "windowed"
        self._window = int(window)
        return self

    def kernel(self, use_kernel: bool = True) -> "Sweep":
        """Run the windowed lanes through the kernels: per window step one
        launch of the fused chooser's sweep form for every lane
        (``fused_chooser.ops.sweep_window_mixed_fused``). Windowed-engine
        only (``run()`` raises on ``.scan().kernel()``)."""
        self._use_kernel = bool(use_kernel)
        return self

    def chunked(self, chunk: int) -> "Sweep":
        """Re-dispatch the scan engine every ``chunk`` events. Scan-engine
        only."""
        if chunk <= 0:
            raise ValueError(f"chunk={chunk} must be > 0")
        self._chunk = int(chunk)
        return self

    def rebalance(self, m: int = 32, *, every: int = 512, passes: int = 0,
                  slack: float = 0.25,
                  lanes: Sequence[int] | None = None) -> "Sweep":
        """Interleave a rebalance pass (``repro_torch.rebalance``: greedy
        top-``m`` migration + ``passes`` LPA iterations, Eq. 10 ``slack``
        guard) after every ``every`` processed events, over every lane.
        ``lanes`` restricts it to those lane indices (None = all): the
        other lanes are gated off, bit-identical to a sweep that never
        rebalanced. With the windowed engine ``every`` must be a multiple
        of the window."""
        self._rebalance = {"m": int(m), "every": int(every),
                           "passes": int(passes), "slack": float(slack),
                           "lanes": None if lanes is None
                           else tuple(int(i) for i in lanes)}
        return self

    def sharded(self, shard: bool = True) -> "Sweep":
        """JAX's lane sharding across local devices. One card holds every
        lane, so this runs the same one-device path (lanes over several
        cards are ROADMAP A23)."""
        self._shard = bool(shard)
        return self

    def sharded_vertices(self, shard: bool = True, *,
                         devices=None) -> "Sweep":
        """Shard each lane's vertex axis instead of the lane axis: lanes
        run one after another, each as one vertex-sharded session over the
        mesh (``runtime.shard_session``) — the big-graph regime, where one
        lane's (n, max_deg) state does not fit a device. ``devices`` is the
        mesh: None (``[device]`` of a sweep that names its device, else
        every CUDA card), an int or a device sequence (entries may repeat).
        Windowed engine only; bit-identical per lane to ``run_stream``.
        Mutually exclusive with ``.sharded()``: to get both at once, build
        a 2-D mesh with ``repro_torch.launch.mesh.make_grid_mesh`` and run
        lane groups as separate sweeps."""
        self._shard_vertices = bool(shard)
        self._shard_devices = devices
        return self

    # -- execution ----------------------------------------------------------

    def _validate(self) -> None:
        """Every lane-compatibility rule, in one place, before any tensor
        is stacked."""
        if self._engine == "windowed" and self._chunk is not None:
            raise ValueError(
                f"chunk={self._chunk} is a scan-engine knob: the windowed "
                "engine processes each lane's stream as a device-resident "
                "lax.scan over windows — its window IS the chunk. Drop "
                ".chunked() (or the chunk= argument) or use the scan "
                "engine.")
        if self._shard_vertices:
            if self._shard:
                raise ValueError(
                    "sharded() and sharded_vertices() are mutually "
                    "exclusive: lane-parallel lanes each claim a device "
                    "while vertex-parallel lanes each claim the WHOLE "
                    "mesh — combining them would silently oversubscribe "
                    "the device pool. Run lane groups as separate sweeps, "
                    "or build an explicit 2-D lanes×vertices mesh with "
                    "repro_torch.launch.mesh.make_grid_mesh and drive the "
                    "session runtime directly.")
            if self._engine != "windowed":
                raise ValueError(
                    "sharded_vertices() requires the windowed engine: the "
                    "vertex-sharded runtime processes streams as windows "
                    "with two int32 sums per window (the per-event loop "
                    "has no sharded counterpart) — chain .windowed() "
                    "before .sharded_vertices()")
            if self._use_kernel:
                raise ValueError(
                    "sharded_vertices() cannot run the kernel lanes: a "
                    "vertex-sharded lane launches its kernels by the device "
                    "of its row blocks, one session at a time — drop "
                    ".kernel()")
            if self._rebalance is not None:
                raise ValueError(
                    "sharded_vertices() does not interleave rebalance "
                    "passes (the rebalance cadence is a lane-parallel "
                    "program) — drop .rebalance(), or use a "
                    "Partitioner(sharded=True) session with "
                    "auto_rebalance/rebalance_drift")
        if self._use_kernel and self._engine != "windowed":
            raise ValueError(
                "kernel() requires the windowed engine: the fused Pallas "
                "chooser is the windowed kernel's Pallas form; the scan "
                "engine is the semantic reference and always scores with "
                "XLA gathers. Chain .windowed() before .kernel(), or drop "
                ".kernel().")
        if self._rebalance is not None:
            rb = self._rebalance
            if rb["every"] <= 0:
                raise ValueError(
                    f"rebalance every={rb['every']} must be > 0: it is "
                    "the event cadence of the interleaved passes")
            if rb["m"] < 0 or rb["passes"] < 0 or rb["slack"] < 0:
                raise ValueError(
                    f"rebalance m={rb['m']}, passes={rb['passes']} and "
                    f"slack={rb['slack']} must all be >= 0")
            if rb["m"] == 0 and rb["passes"] == 0:
                raise ValueError(
                    "rebalance(m=0, passes=0) would interleave empty "
                    "passes — give it a migration budget (m) and/or LPA "
                    "iterations (passes), or drop .rebalance()")
            if self._engine == "windowed" \
                    and rb["every"] % self._window != 0:
                raise ValueError(
                    f"rebalance every={rb['every']} must be a multiple of "
                    f"the window ({self._window}): the cadence segments "
                    "the on-device window loop at window boundaries")
            if rb["lanes"] is not None:
                bad = [i for i in rb["lanes"]
                       if not 0 <= i < len(self._runs)]
                if bad:
                    raise ValueError(
                        f"rebalance lanes={rb['lanes']} reference "
                        f"out-of-range lane indices {bad} (the sweep has "
                        f"{len(self._runs)} lanes)")
        if isinstance(self._stream, (list, tuple)):
            streams = list(self._stream)
            if len(streams) != len(self._runs):
                raise ValueError(
                    f"got {len(streams)} streams for {len(self._runs)} runs"
                    " — per-lane streams must pair one stream per lane "
                    "(pass a single VertexStream to share it)")
        if not self._runs:
            return
        cfg0 = self._runs[0].cfg
        for r in self._runs:
            if r.policy not in POLICIES:
                raise ValueError(
                    f"unknown policy {r.policy!r} (expected one of "
                    f"{POLICIES})")
            if r.cfg.k_max != cfg0.k_max:
                raise ValueError(
                    "all sweep lanes must share k_max (array shapes): got "
                    f"{r.cfg.k_max} vs {cfg0.k_max}")
            if r.cfg.balance_guard != cfg0.balance_guard:
                raise ValueError(
                    "all sweep lanes must share balance_guard (trace-time "
                    f"branch): got {r.cfg.balance_guard!r} vs "
                    f"{cfg0.balance_guard!r}")
        dev = torch.device("cuda" if self._device is None else self._device)
        if self._use_kernel and dev.type == "cuda":
            check_shape_limits(self._window, cfg0.k_max)
        if self._shard_vertices:
            from repro_torch.launch.mesh import resolve_vertices_mesh
            mesh = resolve_vertices_mesh(self._shard_devices, self._device)
            if mesh.lead.type == "cuda":
                check_shape_limits(self._window, cfg0.k_max)

    def run(self) -> list[SweepResult]:
        """Validate and execute; lane results in lane order, each
        bit-identical to ``run_stream`` on that lane's stream."""
        self._validate()
        if not self._runs:
            return []
        return _execute_sweep(
            self._stream, self._runs, chunk=self._chunk,
            engine=self._engine, window=self._window, shard=self._shard,
            use_kernel=self._use_kernel, rebalance=self._rebalance,
            shard_vertices=self._shard_vertices,
            shard_devices=self._shard_devices, device=self._device)
