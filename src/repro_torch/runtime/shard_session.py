"""Vertex-sharded session runtime: one session's (n, max_deg) state split
into row blocks along the "vertices" axis of a mesh (the port's
counterpart of ``repro.runtime.shard_session``).

Slots inside a window depend on each other through the K-sized counters,
so the slot loop cannot be split across devices without changing results;
everything O(n) can. The mixed window already factors into prep (O(n +
W·D), choice-independent) → slot loop (O(W·K)) → apply (O(n)), so the
sharded step runs prep and apply block by block and the one slot loop on
the lead device. One process owns every device (JAX's single controller):

  round 1 — each block's shard-local prep (``window_prep_rows``: the
    ``window_prep`` kernel's row-block form, its plain loop on the CPU). A
    block applies the faithful adjacency writes to its own rows, drops the
    writes to rows it does not own, and emits, owner-masked and encoded +2
    so 0 is the sum's identity, the deleted vertex's row and the four
    presence bits.
  sum #1 — the blocks' int32 emissions summed on the lead device (a block
    on another card is copied there first, ordered on the streams). An
    int32 sum is exact in any order, so it is bit-identical to JAX's
    ``lax.psum``; no collective library is needed in one process.
  round 2 — the score-source rows are now known (ADD rows from the
    events, DEL_VERTEX rows from sum #1), so each block contributes the
    committed labels of the entries it owns; sum #2 merges them. Which
    earlier slot last touched each entry depends only on the window's
    (event, vertex) list, so the touch tables are computed once on the
    lead device — the same values as the reference's O(W²·D) compare, from
    a sort of the window's touches and a binary search per entry.
  round 3 — the window's one slot loop on the lead device: the
    ``fused_window_choose`` kernel (its plain version on the CPU) over the
    ``window_rng`` table, with the semantic n (row padding must not move
    LDG's capacity knob).
  round 4 — each block's apply: the last touching slot of each of its
    rows, then ``label = w_label[last_touch]`` where touched, else
    ``remap[committed]`` — the dense apply, on the block.

Kernels launch or not by the device of the tensors alone: CPU blocks run
every plain version, CUDA blocks every kernel. ``run_stream_sharded`` is
the whole-stream entry, bit-identical to the dense ``run_stream`` for any
mesh width; ``sharded_stream_fn`` is the window loop a session feeds.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.core import transition as tx
from repro_torch.core import windowed as wnd
from repro_torch.core.config import EngineConfig
from repro_torch.core.geometry import Geometry, resolve_geometry
from repro_torch.core.sharded_state import shard_state, unshard_state
from repro_torch.core.state import PartitionState, init_state
from repro_torch.graph.stream import (
    EVENT_ADD, EVENT_DEL_EDGE, EVENT_DEL_VERTEX, EVENT_PAD, VertexStream,
    normalize_rows, pad_stream,
)
from repro_torch.kernels.fused_chooser import fused_chooser as fk
from repro_torch.kernels.fused_chooser.ops import _apply, check_shape_limits
from repro_torch.kernels.fused_chooser.window_prep import window_prep_rows
from repro_torch.kernels.window_rng.ops import window_rng
from repro_torch.launch.mesh import Mesh, RowBlocks, make_vertices_mesh

_I32 = torch.int32


def _on(dev: torch.device):
    """The block's device as the current one (a kernel launches on the
    current device's stream); nothing on the CPU."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def _to(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """``x`` on ``dev``: itself when it is there already (mesh entries may
    repeat a device), else a copy ordered on both devices' streams — which
    only a copy from card to card is: one to the host must be complete
    before the host reads it, so it blocks (a mesh does not mix the CPU
    with cards, ``launch.mesh``; ``x`` may still come from elsewhere)."""
    if x.device == dev:
        return x
    return x.to(dev, non_blocking=x.device.type == dev.type == "cuda")


def _sum(parts, lead: torch.device) -> torch.Tensor:
    """The blocks' int32 emissions summed on the lead device — exact in any
    order, so equal to the reference's ``lax.psum``."""
    out = _to(parts[0], lead)
    for p in parts[1:]:
        out = out + _to(p, lead)
    return out


def _last_touch(safe_vs, touches, ids, slots):
    """For each query (``ids``, ``slots``), the last slot j < slot whose
    event touches (ADD or DEL_VERTEX) vertex id, -1 if none — the value the
    serial scan's ``last_touch[id]`` held at that slot. Each touching slot
    j is the key ``vs_j·W + j``; the answer is the largest key in [id·W,
    id·W + slot), found by a binary search over the sorted keys."""
    w = safe_vs.shape[0]
    iota = torch.arange(w, dtype=torch.int64, device=safe_vs.device)
    keys = torch.where(touches, safe_vs.long() * w + iota, -1)
    keys = torch.sort(keys).values
    base = ids.long() * w
    pos = torch.searchsorted(keys, base + slots) - 1
    cand = keys[torch.clamp(pos, min=0)]
    return torch.where((pos >= 0) & (cand >= base), cand - base, -1).to(_I32)


def sharded_window(state: PartitionState, ets, vs, rows, t0: int, *,
                   n_sem: int, policy: str, cfg: EngineConfig,
                   knobs: torch.Tensor | None = None) -> PartitionState:
    """One mixed window of ``ets``, ``vs`` (W,) and ``rows`` (W, D), on the
    lead device, through a vertex-sharded ``state`` (row leaves in
    ``RowBlocks``); returns the post-window state, whose adjacency blocks
    were updated in place. See the module docstring for the rounds.
    ``knobs`` is ``transition.knob_tensor(cfg, n_sem, lead)``, made here
    when not given."""
    lead = state.edge_load.device
    asg_b = state.assignment.blocks
    prs_b = state.present.blocks
    adj_b = state.adj.blocks
    n_loc = adj_b[0].shape[0]
    w = vs.shape[0]
    k_max = state.edge_load.shape[0]
    ets = torch.where(vs >= 0, ets, EVENT_PAD)
    is_add = ets == EVENT_ADD
    is_dv = ets == EVENT_DEL_VERTEX
    is_de = ets == EVENT_DEL_EDGE
    safe_vs = torch.where(vs >= 0, vs, 0)
    touches = is_add | is_dv

    # round 1: each block's prep, then sum #1
    preps = []
    for b, (prs, adj) in enumerate(zip(prs_b, adj_b)):
        dev = adj.device
        with _on(dev):
            preps.append(window_prep_rows(adj, prs, _to(ets, dev),
                                          _to(vs, dev), _to(rows, dev),
                                          b * n_loc))
    rows_dv = _sum([p.rows_dv for p in preps], lead) - 2
    flags = _sum([p.flags for p in preps], lead) != 0
    fresh, was = flags[:, 0], flags[:, 1]
    exists = is_de & flags[:, 2] & flags[:, 3]

    # round 2: the committed labels of the score sources and both subjects
    # from their owners (sum #2), the touch tables on the lead device
    src_row = torch.where(is_add[:, None], rows,
                          torch.where(is_dv[:, None], rows_dv, -1))
    src_safe = torch.clamp(src_row, min=0)
    us = torch.clamp(rows[:, 0], min=0)
    ids = torch.cat([src_safe.reshape(-1), safe_vs, us])
    label0_b, parts = [], []
    for b, (asg, prs) in enumerate(zip(asg_b, prs_b)):
        dev = asg.device
        lo = b * n_loc
        label0 = torch.where(prs, asg, -1)
        q = _to(ids, dev) - lo
        owned = (q >= 0) & (q < n_loc)
        parts.append(torch.where(
            owned, label0[torch.clamp(q, 0, n_loc - 1)] + 2, 0))
        label0_b.append(label0)
    lbl = _sum(parts, lead) - 2
    wd = src_row.numel()
    src_lbl = torch.where(src_row >= 0, lbl[:wd].reshape(src_row.shape), -1)
    iota = torch.arange(w, dtype=torch.int64, device=lead)
    slots = torch.cat([iota.repeat_interleave(src_row.shape[1]), iota, iota])
    lt = _last_touch(safe_vs, touches, ids, slots)
    touch = torch.where(src_row >= 0, lt[:wd].reshape(src_row.shape), -1)
    ev = torch.stack([
        ets, safe_vs, fresh.to(_I32), was.to(_I32), exists.to(_I32),
        lbl[wd:wd + w], lt[wd:wd + w], lbl[wd + w:], lt[wd + w:]], dim=1)

    # round 3: the slot loop, once, on the lead device
    if knobs is None:
        knobs = tx.knob_tensor(cfg, n_sem, lead)
    rand_tab = window_rng(state.key, t0, w, k_max)
    w_label, _psel, remap, *small_out = fk.fused_window_choose(
        ev, src_lbl, touch, rand_tab, *wnd.small_args(state), knobs,
        n=n_sem, policy=policy, balance_guard=cfg.balance_guard,
        autoscaling=policy == "sdp" and cfg.autoscale)

    # round 4: each block's apply
    iota32 = iota.to(_I32)
    new_asg = []
    for b, label0 in enumerate(label0_b):
        dev = label0.device
        sv = _to(safe_vs, dev) - b * n_loc
        mine = _to(touches, dev) & (sv >= 0) & (sv < n_loc)
        last = torch.full((n_loc + 1,), -1, dtype=_I32, device=dev)
        last.scatter_reduce_(0, torch.where(mine, sv, n_loc).long(),
                             _to(iota32, dev), "amax")
        new_asg.append(_apply(_to(w_label, dev), _to(remap, dev),
                              last[:n_loc], label0))
    return wnd.with_small_outputs(
        state, *small_out, assignment=RowBlocks(new_asg),
        present=RowBlocks(a >= 0 for a in new_asg), adj=state.adj)


def sharded_stream_fn(mesh: Mesh, *, n_sem: int, policy: str,
                      cfg: EngineConfig, window: int, n_events: int):
    """The sharded window loop: ``fn(state, ets, vs, rows, t0) -> state``
    runs ``n_events`` events (a multiple of ``window``, on the lead device)
    window by window through ``sharded_window`` over a state placed on
    ``mesh`` (``sharded_state.shard_state``), consuming it. A card mesh is
    checked against the kernels' shape limits here, before any window."""
    if n_events % window != 0:
        raise ValueError(
            f"sharded_stream_fn(n_events={n_events}, window={window}): "
            "the event tensor must be padded to a multiple of the window "
            "(graph.stream.pad_stream, or the session's tail padding)")
    if mesh.lead.type == "cuda":
        check_shape_limits(window, cfg.k_max)
    knobs = tx.knob_tensor(cfg, n_sem, mesh.lead)

    def fn(state, ets, vs, rows, t0):
        for i0 in range(0, n_events, window):
            sl = slice(i0, i0 + window)
            state = sharded_window(state, ets[sl], vs[sl], rows[sl], t0 + i0,
                                   n_sem=n_sem, policy=policy, cfg=cfg,
                                   knobs=knobs)
        return state

    return fn


def run_stream_sharded(
    stream: VertexStream,
    *,
    policy: str = "sdp",
    cfg: EngineConfig | None = None,
    seed: int = 0,
    window: int = 256,
    geometry: Geometry | None = None,
    mesh: Mesh | None = None,
    devices=None,
) -> PartitionState:
    """Whole-stream entry: run ``stream`` vertex-sharded over ``mesh``
    (default: ``make_vertices_mesh(devices=devices)``, every CUDA card when
    ``devices`` is None) and gather the final state back dense on the lead
    device — bit-identical to ``run_stream(stream, ...)[0]`` at the same
    geometry, for any mesh width. The correctness gate and the lane body of
    ``Sweep.sharded_vertices()``."""
    cfg = cfg if cfg is not None else EngineConfig()
    geom = resolve_geometry(stream, cfg, geometry)
    if mesh is None:
        mesh = make_vertices_mesh(devices=devices)
    s = pad_stream(stream, window)
    fn = sharded_stream_fn(mesh, n_sem=geom.n, policy=policy, cfg=cfg,
                           window=window, n_events=s.num_events)
    lead = mesh.lead
    state = shard_state(init_state(geom.n, geom.max_deg, geom.k_max,
                                   cfg.k_init, seed, device=lead), mesh)
    state = fn(state, torch.tensor(s.etype, device=lead),
               torch.tensor(s.vertex, device=lead),
               torch.tensor(normalize_rows(s.nbrs, geom.max_deg),
                            device=lead), 0)
    return unshard_state(state, n=geom.n)
