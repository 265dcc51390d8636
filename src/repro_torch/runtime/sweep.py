"""Sweep runtime: many (policy × seed × config × stream) lanes in one run
(the port's counterpart of ``repro.runtime.sweep``).

The figure benchmarks run their policies × seeds × configs as *lanes*.
Each lane carries its own state and, optionally, its own event stream
(per-seed permutations, per-lane churn mixes); every lane's result is
bit-identical to ``run_stream`` with that lane's (policy, cfg, seed) on
its stream — per-event (``engine="scan"``, with traces) or in mixed
windows (``engine="windowed"``), whole-stream or chunked.

Where JAX stacks the lanes' states and vmaps one jitted program over
them, the port keeps one ``PartitionState`` per lane (each lane's O(n)
leaves are its own tensors, updated in place) and runs the lanes in turn
— except on the kernel path: ``engine="windowed"`` with ``use_kernel``
runs every window step of every lane through ONE launch of the fused
chooser's sweep form (``fused_chooser.ops.sweep_window_mixed_fused``),
each lane under its own policy and scale gate.

Static requirements across lanes, as in JAX: one ``k_max`` (array
shapes) and one ``balance_guard``. ``k_init``, ``seed``, ``autoscale``,
the stream and the numeric knobs vary per lane — the stream's geometry
too: per-lane streams of unequal ``n`` / ``max_deg`` are padded to the
union geometry, and each lane equals ``run_stream(stream,
geometry=union)`` (its own-geometry run for every policy but LDG, whose
capacity knob reads ``n``).

One card holds every lane: ``shard`` is accepted and runs the same
one-device path (JAX's one-device mesh, zero lane padding); lanes over
several cards are ROADMAP A23. ``shard_vertices`` runs the lanes one after
another, each a vertex-sharded session over the whole mesh
(``runtime.shard_session.run_stream_sharded``) at its own stream's
geometry. ``cut_fn`` (fig12's from-scratch scale-in baseline) reaches
the scan path only (``sweep_events``), as in JAX, where only the scan
kernel takes it.
"""
from __future__ import annotations

import functools
import warnings
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import transition as tx
from repro_torch.core.config import EngineConfig
from repro_torch.core.geometry import Geometry, check_row_width
from repro_torch.core.state import PartitionState, init_state, resolve_device
from repro_torch.core.windowed import (
    lane_autoscaling, lane_events, sweep_window_mixed,
)
from repro_torch.graph.stream import EVENT_PAD, VertexStream, normalize_rows


class SweepRun(NamedTuple):
    """One lane of a sweep: a policy/config/seed triple over its stream."""
    policy: str = "sdp"
    cfg: EngineConfig = EngineConfig()
    seed: int = 0


class SweepResult(NamedTuple):
    policy: str
    cfg: EngineConfig
    seed: int
    state: PartitionState
    trace: tx.EventTrace | None   # None for engine="windowed"


def _scan_lanes(
    states: list,              # one PartitionState per lane
    kns: torch.Tensor,         # (L, 7) f32 knobs
    policy_idx,                # (L,) host ints into POLICIES order
    autoscale,                 # (L,) host bools (cfg.autoscale per lane)
    etype: torch.Tensor,       # (L, T) per-lane — or (T,) shared — streams
    vertex: torch.Tensor,      # (L, T) / (T,)
    nbrs: torch.Tensor,        # (L, T, max_deg) / (T, max_deg)
    t0: int,                   # global index of the first event
    *,
    balance_guard: str,
    autoscale_mode: str,       # "off" | "dynamic"
    shared_stream: bool = False,
    cut_fn=None,
) -> tuple[list, list]:
    """One chunk of every lane's stream through the per-event loop
    (``transition.scan_events`` with the lane step
    ``transition.make_masked_step``); resumable. Lanes run in turn. Returns
    the lanes' states and their traces."""
    check_row_width(states[0], nbrs)
    n = states[0].assignment.shape[0]
    autos = lane_autoscaling(policy_idx, autoscale, autoscale_mode)
    out, traces = [], []
    for b, state in enumerate(states):
        step = tx.make_masked_step(
            tx.Knobs(*kns[b].unbind()), n, balance_guard=balance_guard,
            policy_idx=policy_idx[b], autoscale=autos[b], cut_fn=cut_fn)
        state, trace = tx.scan_events(
            step, state, *(lane_events(x, b, shared_stream)
                           for x in (etype, vertex, nbrs)), t0)
        out.append(state)
        traces.append(trace)
    return out, traces


def _host_list(x) -> list:
    return x.tolist() if isinstance(x, torch.Tensor) else list(x)


def sweep_events(states: PartitionState, kns: torch.Tensor, policy_idx,
                 autoscale, etype, vertex, nbrs, t0: int, *,
                 balance_guard: str, autoscale_mode: str,
                 shared_stream: bool = False, cut_fn=None):
    """The public resumable scan over stacked lanes, JAX's ``sweep_events``:
    ``states`` and the returned states and ``EventTrace`` carry a leading
    lane axis (L, ...), ``policy_idx`` and ``autoscale`` are (L,)
    sequences (or tensors, read on the host). Consumes ``states``.
    ``cut_fn`` (assignment, present, adj) -> cut replaces every lane's
    incremental scale-in cut by a recount (fig12's baseline,
    ``transition.recompute_cut``)."""
    lanes = [_unstack(states, b) for b in range(states.assignment.shape[0])]
    lanes, traces = _scan_lanes(
        lanes, kns, _host_list(policy_idx), _host_list(autoscale), etype,
        vertex, nbrs, t0, balance_guard=balance_guard,
        autoscale_mode=autoscale_mode, shared_stream=shared_stream,
        cut_fn=cut_fn)
    return _stack(lanes), _stack(traces)


def _stack(trees):
    return type(trees[0])(*(torch.stack(xs) for xs in zip(*trees)))


def _unstack(tree, i):
    return type(tree)(*(x[i] for x in tree))


def _stack_streams(streams: Sequence[VertexStream], length: int, device):
    """Per-lane streams → dense (L, T[, D]) event tensors on ``device``,
    EVENT_PAD-padded on the right so shorter lanes no-op, at the union
    geometry of the lanes' streams (returned as its (n, max_deg), which
    the caller sizes the lanes' states at)."""
    geom = functools.reduce(
        Geometry.union, (Geometry(s.n, s.max_deg) for s in streams))
    L = len(streams)
    et = np.full((L, length), EVENT_PAD, np.int32)
    vx = np.full((L, length), -1, np.int32)
    nb = np.full((L, length, geom.max_deg), -1, np.int32)
    for i, s in enumerate(streams):
        t = s.num_events
        et[i, :t] = s.etype
        vx[i, :t] = s.vertex
        nb[i, :t] = normalize_rows(s.nbrs, geom.max_deg)
    return (*(torch.from_numpy(a).to(device) for a in (et, vx, nb)),
            geom.n, geom.max_deg)


def _shared_stream_arrays(s: VertexStream, length: int, device):
    """One shared stream → dense (T[, D]) tensors on ``device``, every
    lane reading the same (never copied L-fold)."""
    et = np.full(length, EVENT_PAD, np.int32)
    vx = np.full(length, -1, np.int32)
    nb = np.full((length, s.max_deg), -1, np.int32)
    t = s.num_events
    et[:t] = s.etype
    vx[:t] = s.vertex
    nb[:t] = normalize_rows(s.nbrs, s.max_deg)
    return tuple(torch.from_numpy(a).to(device) for a in (et, vx, nb))


def _execute_sweep(
    stream: VertexStream | Sequence[VertexStream],
    runs: Sequence[SweepRun | tuple],
    *,
    chunk: int | None = None,
    engine: str = "scan",
    window: int = 256,
    shard: bool | None = None,
    use_kernel: bool = False,
    rebalance: dict | None = None,
    shard_vertices: bool = False,
    shard_devices=None,
    device=None,
) -> list[SweepResult]:
    """Executor behind ``repro_torch.api.Sweep`` (and the deprecated
    ``run_sweep`` shim): every lane bit-identical to ``run_stream`` with
    the same arguments on that lane's stream. Lane compatibility is
    validated by ``Sweep._validate`` — go through ``Sweep``.

    stream: one shared ``VertexStream`` or one stream per run (right-padded
      with no-op events to a common T and to the union geometry).
    chunk: re-dispatch the scan engine every ``chunk`` events; traces are
      concatenated along the event axis.
    engine: "scan" — the per-event loop, with traces; "windowed" — mixed
      windows of ``window`` events (``trace=None``).
    shard: accepted for JAX's signature; one card runs every lane.
    use_kernel: with ``engine="windowed"``, the kernel lanes
      (``sweep_window_mixed_fused``: one sweep-form chooser launch a window
      step); their plain versions on the CPU.
    rebalance: ``{"m", "every", "passes", "slack", "lanes"}`` from
      ``Sweep.rebalance()`` — after every full ``every`` processed events,
      ``lane_rebalance`` over the lanes (per-lane ``max_cap``, shared
      slack, lanes outside ``lanes`` gated off).
    shard_vertices: run each lane as one vertex-sharded session over the
      mesh of ``shard_devices`` (windowed engine; lanes in turn, each at
      its own stream's geometry, bit-identical to ``run_stream``).
    shard_devices: that mesh — None (``[device]`` when ``device`` is
      given, else every CUDA card), an int (the first N cards) or a device
      sequence (entries may repeat).
    device: where the lanes live; ``None`` is the CUDA card (raises
      without one), ``"cpu"`` runs the plain versions.
    """
    runs = [r if isinstance(r, SweepRun) else SweepRun(*r) for r in runs]
    if not runs:
        return []
    shared = not isinstance(stream, (list, tuple))
    streams = [stream] * len(runs) if shared else list(stream)
    if shard_vertices:
        from repro_torch.launch.mesh import resolve_vertices_mesh
        from repro_torch.runtime.shard_session import run_stream_sharded
        mesh = resolve_vertices_mesh(shard_devices, device)
        return [SweepResult(r.policy, r.cfg, r.seed,
                            run_stream_sharded(s, policy=r.policy, cfg=r.cfg,
                                               seed=r.seed, window=window,
                                               mesh=mesh), None)
                for r, s in zip(runs, streams)]
    dev = resolve_device(device)
    cfg0 = runs[0].cfg
    autoscale_mode = (
        "dynamic"
        if any(r.cfg.autoscale and r.policy == "sdp" for r in runs)
        else "off"
    )

    L = len(runs)
    lens = [s.num_events for s in streams]
    T_ev = max(lens)   # real events: the rebalance cadence counts these
    T = T_ev
    if engine == "windowed":
        T = ((T + window - 1) // window) * window
    if shared:
        et, vx, nb = _shared_stream_arrays(streams[0], T, dev)
        n, max_deg = streams[0].n, streams[0].max_deg
    else:
        et, vx, nb, n, max_deg = _stack_streams(streams, T, dev)
    states = [init_state(n, max_deg, cfg0.k_max, r.cfg.k_init, r.seed,
                         device=dev) for r in runs]
    kns = torch.stack([tx.knob_tensor(r.cfg, n, dev) for r in runs])
    pidx = [tx.POLICY_INDEX[r.policy] for r in runs]
    auto = [r.cfg.autoscale for r in runs]
    kw = {"balance_guard": cfg0.balance_guard,
          "autoscale_mode": autoscale_mode, "shared_stream": shared}

    def ev_slice(a, sl):
        return a[sl] if shared else a[:, sl]

    def segment(fn, states, t, end, **more):
        sl = slice(t, end)
        return fn(states, kns, pidx, auto, ev_slice(et, sl), ev_slice(vx, sl),
                  ev_slice(nb, sl), t, **kw, **more)

    reb_apply = None
    if rebalance is not None:
        from repro_torch.rebalance import lane_rebalance
        reb_every = int(rebalance["every"])
        chosen = (range(L) if rebalance["lanes"] is None
                  else set(rebalance["lanes"]))
        enabled = [b in chosen for b in range(L)]
        caps = [torch.tensor(float(r.cfg.max_cap), dtype=torch.float32,
                             device=dev) for r in runs]
        slack = torch.tensor(rebalance["slack"], dtype=torch.float32,
                             device=dev)
        reb_call = lane_rebalance(min(int(rebalance["m"]), n),
                                  int(rebalance["passes"]),
                                  use_kernel=use_kernel)

        def reb_apply(states, t):
            return reb_call(states, t, slack, caps, enabled)[0]

    traces = None
    if engine == "windowed":
        if use_kernel:
            from repro_torch.kernels.fused_chooser.ops import (
                sweep_window_mixed_fused as fn,
            )
        else:
            fn = sweep_window_mixed
        # segment the stream at the rebalance cadence (a window multiple,
        # validated) and rebalance after each full segment
        step = T if reb_apply is None else reb_every
        t = 0
        while t < T:
            end = min(t + step, T)
            states = segment(fn, states, t, end, window=window)
            # a segment padded past the real stream end is not a full
            # cadence interval (T is window-rounded; the scan engine never
            # sees the padding, and the engines must agree)
            if reb_apply is not None and end - t == reb_every \
                    and end <= T_ev:
                states = reb_apply(states, end)
            t = end
    else:
        step = chunk if chunk is not None else T
        chunks = [[] for _ in runs]
        t = 0
        while t < T:
            end = min(t + step, T)
            if rebalance is not None:
                # dispatch boundaries never cross a cadence boundary, so
                # the pass lands exactly between the right two events
                end = min(end, (t // reb_every + 1) * reb_every)
            states, trs = segment(_scan_lanes, states, t, end)
            for c, tr in zip(chunks, trs):
                c.append(tr)
            t = end
            if rebalance is not None and t % reb_every == 0:
                states = reb_apply(states, t)
        traces = [tx.EventTrace(*(torch.cat([getattr(tr, f) for tr in c])
                                  for f in tx.EventTrace._fields))
                  for c in chunks]

    return [
        SweepResult(
            r.policy, r.cfg, r.seed, states[i],
            None if traces is None else tx.EventTrace(
                *(x[:lens[i]] for x in traces[i])))
        for i, r in enumerate(runs)
    ]


def run_sweep(
    stream: VertexStream | Sequence[VertexStream],
    runs: Sequence[SweepRun | tuple],
    *,
    chunk: int | None = None,
    engine: str = "scan",
    window: int = 256,
    shard: bool | None = None,
    shard_vertices: bool = False,
    shard_devices=None,
    device=None,
) -> list[SweepResult]:
    """Deprecated batch entry — use the fluent ``Sweep``::

        from repro_torch.api import Sweep
        Sweep(stream).lanes(runs).windowed(256).sharded().run()

    This shim makes the equivalent ``Sweep`` (so its lane
    validation applies — e.g. ``engine="windowed"`` with ``chunk``
    raises) and runs it on ``device``; ``shard_vertices`` is
    ``.sharded_vertices(devices=shard_devices)``."""
    warnings.warn(
        "run_sweep is deprecated: use repro_torch.api.Sweep — e.g. "
        "Sweep(stream).lanes(runs).windowed().sharded().run()",
        DeprecationWarning, stacklevel=2)
    from repro_torch.api.sweep import Sweep
    sw = Sweep(stream, device=device).lanes(runs)
    if engine == "windowed":
        sw.windowed(window)
    elif engine != "scan":
        raise ValueError(
            f"unknown engine {engine!r} (expected 'scan' or 'windowed')")
    if chunk is not None:
        sw.chunked(chunk)
    if shard is not None:
        sw.sharded(shard)
    if shard_vertices:
        sw.sharded_vertices(devices=shard_devices)
    return sw.run()
