"""Faithful one-pass streaming engine (paper Algorithm 1) as a per-event
loop — the port's counterpart of ``repro.core.engine``.

Every event (add vertex / delete vertex / delete edge) is processed in
arrival order, exactly one pass, with the partition decision taken from
the state as of that event. The transition bodies live in
``repro_torch.core.transition``. This module is the port's semantic
reference: its kernels (``partition_affinity``, ``fused_chooser``) attach
to the windowed paths only, and every bit-identity check compares against
this loop.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.config import EngineConfig
from repro_torch.core.geometry import Geometry, check_row_width, resolve_geometry
from repro_torch.core.state import PartitionState, init_state
from repro_torch.core.transition import (
    EventTrace, make_knobs, make_transition, scan_events,
)
from repro_torch.graph.stream import VertexStream, normalize_rows

__all__ = ["EventTrace", "run_events", "run_stream", "trace_at"]


def _run_events(
    state: PartitionState,
    etype: torch.Tensor,     # (T,)
    vertex: torch.Tensor,    # (T,)
    nbrs: torch.Tensor,      # (T, max_deg)
    t0: int,                 # global index of the first event (RNG alignment)
    *,
    policy: str,
    cfg: EngineConfig,
) -> tuple[PartitionState, EventTrace]:
    """Process a chunk of events; resumable. Consumes ``state`` (its O(n)
    leaves are updated in place, see ``repro_torch.core.state``)."""
    check_row_width(state, nbrs)
    n = state.assignment.shape[0]
    trn = make_transition(
        make_knobs(cfg, n, state.edge_load.device), n,
        balance_guard=cfg.balance_guard, policy=policy,
        autoscale=cfg.autoscale and policy == "sdp",
    )
    return scan_events(trn.step, state, etype, vertex, nbrs, int(t0))


run_events = _run_events


def run_stream(
    stream: VertexStream,
    *,
    policy: str = "sdp",
    cfg: EngineConfig | None = None,
    seed: int = 0,
    chunk: int | None = None,
    geometry: Geometry | None = None,
    device=None,
) -> tuple[PartitionState, EventTrace]:
    """Host entry: run a full stream through the faithful engine on
    ``device`` (default the CUDA card; raises if there is none).

    ``geometry`` overrides the state allocation (default: the stream's
    declared ``(n, max_deg)`` with the config's ``k_max``)."""
    cfg = cfg or EngineConfig()
    geom = resolve_geometry(stream, cfg, geometry)
    state = init_state(geom.n, geom.max_deg, geom.k_max, cfg.k_init, seed,
                       device=device)
    dev = state.edge_load.device
    et = torch.as_tensor(stream.etype, dtype=torch.int32).to(dev)
    vx = torch.as_tensor(stream.vertex, dtype=torch.int32).to(dev)
    nb = torch.as_tensor(normalize_rows(stream.nbrs, geom.max_deg)).to(dev)
    if chunk is None:
        return run_events(state, et, vx, nb, 0, policy=policy, cfg=cfg)
    traces = []
    t = 0
    while t < stream.num_events:
        sl = slice(t, min(t + chunk, stream.num_events))
        state, tr = run_events(state, et[sl], vx[sl], nb[sl], t,
                               policy=policy, cfg=cfg)
        traces.append(tr)
        t = sl.stop
    trace = EventTrace(*(torch.cat([getattr(tr, f) for tr in traces])
                         for f in EventTrace._fields))
    return state, trace


def trace_at(trace: EventTrace, indices) -> dict[str, np.ndarray]:
    """Sample the trace at interval boundaries (paper's capture points)."""
    tr = EventTrace(*(t.cpu().numpy() for t in trace))
    idx = np.asarray(indices, dtype=np.int64) - 1
    idx = np.clip(idx, 0, tr.total_edges.shape[0] - 1)
    tot = tr.total_edges[idx]
    cut = tr.cut_edges[idx]
    return {
        "total_edges": tot,
        "cut_edges": cut,
        "edge_cut_ratio": cut / np.maximum(tot, 1),
        "num_partitions": tr.num_partitions[idx],
        "load_std": tr.load_std[idx],
    }
