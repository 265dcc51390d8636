"""Windowed streaming engine (the port's counterpart of
``repro.core.windowed``): W events per step instead of one, bit-identical
to the faithful engine.

* ``run_window_adds`` — ADD-only windows: one batched committed-affinity
  histogram (W, K) against the window-start state
  (``prepare_add_window``), then a sequential fixup over the W slots that
  adds the intra-window neighbours and keeps the O(K) counters
  (``add_window_fixup_ref``), then the O(n) writes
  (``commit_add_window``). Under ``use_kernel`` the same three steps run
  as ``fused_chooser.ops.run_window_adds_fused``: the histogram in the
  ``partition_affinity`` kernel, the fixup in the pure-ADD kernel.
* ``run_window_mixed`` — arbitrary ADD / DEL_VERTEX / DEL_EDGE windows,
  scoring every slot from a dense per-vertex label journal. Under
  ``use_kernel`` the whole slot loop runs in the fused chooser kernel
  instead (``repro_torch.kernels.fused_chooser``).
* ``sweep_window_mixed`` — the sweep's plain lanes: every window of every
  lane through ``run_window_mixed``'s body under the lane's policy (its
  kernel twin is ``fused_chooser.ops.sweep_window_mixed_fused``).

RNG is the engines' ``fold_in(key, global_event_index)`` scheme, drawn in
one batch per window (``repro_torch.kernels.window_rng``). Like every
engine of the port, these consume the state they are given (O(n) leaves
updated in place).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import rng
from repro_torch.core import transition as tx
from repro_torch.core.config import EngineConfig
from repro_torch.core.geometry import Geometry, check_row_width, resolve_geometry
from repro_torch.core.state import PartitionState, init_state
from repro_torch.graph.stream import (
    EVENT_ADD, EVENT_DEL_EDGE, EVENT_DEL_VERTEX, EVENT_PAD, VertexStream,
    normalize_rows,
)
from repro_torch.kernels.common import label_histogram
from repro_torch.kernels.partition_affinity.ops import gather_labels

_I32 = torch.int32
# the scalar counters in the window kernels' order (csrc's enum Scal)
_SCALARS = ("num_partitions", "total_edges", "cut_edges", "denied_scaleout",
            "scale_events")


class SmallState(NamedTuple):
    """The O(K)/O(K²) slice of PartitionState carried through a window."""
    active: torch.Tensor
    edge_load: torch.Tensor
    vertex_count: torch.Tensor
    num_partitions: torch.Tensor
    total_edges: torch.Tensor
    cut_edges: torch.Tensor
    denied_scaleout: torch.Tensor
    scale_events: torch.Tensor
    cut_matrix: torch.Tensor


def _small(state: PartitionState) -> SmallState:
    return SmallState(*(getattr(state, f) for f in SmallState._fields))


def _with_small(state: PartitionState, small: SmallState, **kw
                ) -> PartitionState:
    return state._replace(**small._asdict(), **kw)


def _last_writers(idx: torch.Tensor, mask: torch.Tensor):
    """The plan of a last-wins scatter to ``idx`` (W,): for each slot j,
    whether a masked slot names ``idx[j]`` and the last such slot."""
    w = idx.shape[0]
    same = (idx[:, None] == idx[None, :]) & mask[None, :]
    has = same.any(dim=1)
    last = (w - 1) - torch.argmax(same.flip(1).to(_I32), dim=1)
    return has, last


def _scatter_last(dst: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
                  mask: torch.Tensor, plan=None) -> None:
    """In place: ``dst[idx[j]] = vals[j]`` for every slot j with
    ``mask[j]``; of several masked slots naming one index the last wins
    (the order of XLA's CPU scatter), and unmasked slots write nothing.
    Every slot naming an index writes that index's one final value, so
    duplicate indices cannot race on the device. ``plan`` is
    ``_last_writers(idx, mask)``, made here when not given."""
    w = idx.shape[0]
    has, last = _last_writers(idx, mask) if plan is None else plan
    cur = dst[idx]
    has = has.reshape((w,) + (1,) * (cur.dim() - 1))
    dst[idx] = torch.where(has, vals[last], cur)


def committed_scores(state: PartitionState, rows: torch.Tensor):
    """Batched paper-Eq.-1 affinity of W vertices vs the committed state —
    the plain path; ``repro_torch.kernels.partition_affinity.ops
    .scores_for_state`` is the kernel twin. Absent neighbours score as
    empty regardless of their stale assignment entries."""
    labels = gather_labels(state.assignment, state.present, rows)
    return label_histogram(labels, state.edge_load.shape[0])   # (W, K), (W,)


class AddWindow(NamedTuple):
    """The choice-independent tables of a pure-ADD window."""
    scores_c: torch.Tensor    # (W, K) affinity vs the window-start state
    deg_c: torch.Tensor       # (W,) degree vs the window-start state
    win_pos: torch.Tensor     # (W, D) window slot of each row entry, -1 none
    fresh_c: torch.Tensor     # (W,) an ADD of a vertex absent at the start


def prepare_add_window(state: PartitionState, vs: torch.Tensor,
                       rows: torch.Tensor, score_fn=None) -> AddWindow:
    """The batched half of a pure-ADD window: committed scores
    (``score_fn``, by default ``committed_scores``), each row entry's window
    slot (the last slot adding that vertex) and the fresh flags."""
    n = state.assignment.shape[0]
    w = vs.shape[0]
    is_add = vs >= 0
    safe_vs = torch.where(is_add, vs, 0)
    scores_c, deg_c = (score_fn or committed_scores)(state, rows)
    pos_of = torch.full((n,), -1, dtype=_I32, device=vs.device)
    _scatter_last(pos_of, safe_vs,
                  torch.arange(w, dtype=_I32, device=vs.device), is_add)
    valid = rows >= 0
    win_pos = torch.where(valid, pos_of[torch.where(valid, rows, 0)], -1)
    return AddWindow(scores_c, deg_c, win_pos,
                     is_add & ~state.present[safe_vs])


def small_args(state: PartitionState) -> tuple:
    """The O(K) counter slice as the window kernels take it: (active,
    edge_load, vertex_count, cut_matrix, scalars (5,) in ``_SCALARS``
    order)."""
    return (state.active, state.edge_load, state.vertex_count,
            state.cut_matrix, torch.stack([getattr(state, f)
                                           for f in _SCALARS]))


def small_from_args(active, edge_load, vertex_count, cut_matrix,
                    scalars) -> SmallState:
    """``small_args``' tensors (``active`` bool or int) as a SmallState."""
    return SmallState(active=active != 0, edge_load=edge_load,
                      vertex_count=vertex_count, cut_matrix=cut_matrix,
                      **dict(zip(_SCALARS, scalars.unbind())))


def small_outputs(small: SmallState) -> tuple:
    """A SmallState as the window kernels return it: (active int32, loads
    (2, K) [edge_load; vertex_count], cut_matrix, scalars (5,))."""
    return (small.active.to(_I32),
            torch.stack([small.edge_load, small.vertex_count]),
            small.cut_matrix,
            torch.stack([getattr(small, f) for f in _SCALARS]))


def with_small_outputs(state: PartitionState, active, loads, cut_matrix,
                       scalars, **kw) -> PartitionState:
    """``state`` with a window kernel's counter outputs (and ``kw``)."""
    return state._replace(
        active=active != 0, edge_load=loads[0], vertex_count=loads[1],
        cut_matrix=cut_matrix, **dict(zip(_SCALARS, scalars.unbind())), **kw)


def add_window_fixup_ref(scores_c, deg_c, win_pos, fresh_c, vs, rand_tab,
                         active, edge_load, vertex_count, cut_matrix, scalars,
                         knobs, *, n: int, policy: str, balance_guard: str,
                         autoscaling: bool):
    """The pure-ADD window's slot loop, on any device: the plain version of
    ``fused_chooser.add_window_choose`` (same arguments and outputs). Slot
    i adds its neighbours among the earlier slots (``win_pos < i``) to its
    committed scores — every one to its degree, and under its label where
    its slot committed one — draws ``rand_tab[i, num_partitions - 1]``,
    chooses and commits if fresh, keeping the O(K) counters."""
    w = vs.shape[0]
    k_max = rand_tab.shape[1]
    kn = tx.Knobs(*knobs.unbind())
    choose = tx.make_table_chooser(balance_guard, policy)
    small = small_from_args(active, edge_load, vertex_count, cut_matrix,
                            scalars)
    is_add = vs >= 0
    safe_vs = torch.where(is_add, vs, 0)
    slots = torch.arange(w, dtype=_I32, device=vs.device)
    intra_all = (win_pos >= 0) & (win_pos < slots[:, None])
    safe_pos = torch.clamp(win_pos, min=0)
    w_assign = torch.full((w,), -1, dtype=_I32, device=vs.device)
    for i in range(w):
        if autoscaling:
            # the faithful engine scales out per ADD event only
            small = tx.scale_out(small, kn, is_add[i])
        intra = intra_all[i]
        nb_wa = torch.where(intra, w_assign[safe_pos[i]], -1)
        sc = scores_c[i] + label_histogram(nb_wa, k_max)[0]
        deg = deg_c[i] + intra.sum(dtype=_I32)
        ridx = tx._take(rand_tab[i],
                        torch.clamp(small.num_partitions, min=1) - 1)
        p = choose(small, sc, deg, safe_vs[i], ridx, kn, n)
        do = fresh_c[i]
        d = torch.where(do, deg, 0)
        scm = torch.where(do, sc, 0)
        small = small._replace(
            vertex_count=tx._add_at(small.vertex_count, p, do.to(_I32)),
            edge_load=tx._add_at(small.edge_load + scm, p, d),
            total_edges=small.total_edges + d,
            cut_edges=small.cut_edges + d - tx._take(scm, p),
            cut_matrix=tx._add_row_col(small.cut_matrix, p, scm),
        )
        w_assign[i] = torch.where(do, p, w_assign[i])
    return (w_assign, *small_outputs(small))


def commit_add_window(state: PartitionState, vs, rows, w_assign, *small_out
                      ) -> PartitionState:
    """Write a pure-ADD window's decisions into the O(n) state (in place;
    of several slots adding one vertex the last wins) and take the new
    counters ``small_out`` (``add_window_choose``'s outputs after
    ``w_assign``)."""
    is_add = vs >= 0
    safe_vs = torch.where(is_add, vs, 0)
    fresh = is_add & (w_assign >= 0)
    plan = _last_writers(safe_vs, fresh)          # one plan, three leaves
    _scatter_last(state.assignment, safe_vs, w_assign, fresh, plan)
    _scatter_last(state.present, safe_vs, fresh, fresh, plan)
    _scatter_last(state.adj, safe_vs, rows, fresh, plan)
    return with_small_outputs(state, *small_out)


def run_window_adds(
    state: PartitionState,
    vs: torch.Tensor,       # (W,) vertex ids (-1 pad allowed)
    rows: torch.Tensor,     # (W, max_deg)
    t0: int,                # global event index of window start
    *,
    policy: str,
    cfg: EngineConfig,
    knobs: torch.Tensor | None = None,
) -> PartitionState:
    """Process one ADD-only window with the plain versions (committed
    scores, random table, slot loop). Bit-identical to the faithful
    engine. ``knobs`` is ``transition.knob_tensor(cfg, n, device)``, made
    here when not given."""
    check_row_width(state, rows)
    n = state.assignment.shape[0]
    if knobs is None:
        knobs = tx.knob_tensor(cfg, n, vs.device)
    prep = prepare_add_window(state, vs, rows)
    rand_tab = tx.rand_index_table(state.key, t0, vs.shape[0],
                                   state.edge_load.shape[0])
    out = add_window_fixup_ref(
        *prep, vs, rand_tab, *small_args(state), knobs, n=n, policy=policy,
        balance_guard=cfg.balance_guard,
        autoscaling=policy == "sdp" and cfg.autoscale)
    return commit_add_window(state, vs, rows, *out)


def _scale_in_journal(small: SmallState, label_now: torch.Tensor, kn, gate):
    """transition.scale_in (§4.2.3, Eqs. 6–8) on the window-local journal
    representation (label_now ≡ assignment, label_now >= 0 ≡ present). The
    trigger and counter merges are shared with the faithful engine."""
    src, dst, do = tx.scale_in_trigger(small, kn)
    do = do & gate
    return (tx.merge_counters(small, src, dst, do),
            torch.where(do & (label_now == src), dst, label_now))


def _window_mixed_lane(
    state: PartitionState,
    ets: torch.Tensor,      # (W,) event types (EVENT_* codes)
    vs: torch.Tensor,       # (W,) subject vertex ids (-1 pad allowed)
    rows: torch.Tensor,     # (W, max_deg) neighbour rows / deletion operands
    t0: int,                # global event index of window start
    kn: tx.Knobs,
    *,
    choose,
    autoscaling: bool,
) -> PartitionState:
    """One mixed window (static knob). Deletions and earlier adds inside
    the window change neighbour presence mid-window, so every slot scores
    from a dense per-vertex label journal ``label_now`` (≡ present ?
    assignment : -1, one write per slot). A slot holds exactly one event
    type, so each branch's effect is a masked contribution to the counters
    plus at most two row writes into adj."""
    n = state.assignment.shape[0]
    w = vs.shape[0]
    k_max = state.edge_load.shape[0]
    dev = vs.device

    ets = torch.where(vs >= 0, ets, EVENT_PAD)
    is_add = ets == EVENT_ADD
    is_dv = ets == EVENT_DEL_VERTEX
    is_de = ets == EVENT_DEL_EDGE
    safe_vs = torch.where(vs >= 0, vs, 0)
    rows_add = torch.where(is_add[:, None], rows, -1)
    hi, lo = rng.draw_words(
        state.key, t0 + torch.arange(w, dtype=torch.int64, device=dev))

    small = _small(state)
    label_now = torch.where(state.present, state.assignment, -1)
    adj = state.adj
    for i in range(w):
        v = safe_vs[i]
        v1 = v.reshape(1)
        row = rows[i]
        add_i, dv_i, de_i = is_add[i], is_dv[i], is_de[i]
        own_row = adj[v1][0]                      # pre-event adjacency
        u = row[0]
        safe_u = torch.clamp(u, min=0)

        # --- ADD: corrected scores + policy choice (faithful apply_add) ---
        if autoscaling:
            small = tx.scale_out(small, kn, add_i)
        # one journal gather + histogram serves the whole slot: an ADD
        # scores its event row, a DEL_VERTEX its own adjacency row
        src_row = torch.where(add_i, rows_add[i],
                              torch.where(dv_i, own_row, -1))
        eff = torch.where(src_row >= 0,
                          label_now[torch.clamp(src_row, min=0)], -1)
        sc_eff, deg_eff = label_histogram(eff, k_max)
        p = choose(small, sc_eff, deg_eff, v, (hi[i], lo[i]), kn, n)
        lv = tx._take(label_now, v)
        lu = tx._take(label_now, safe_u)
        fresh = add_i & (lv < 0)                  # faithful commit_add
        was = dv_i & (lv >= 0)                    # faithful del_vertex_core
        in_adj = (own_row == u).any() & (u >= 0)  # faithful del_edge_core
        exists = de_i & (lv >= 0) & (lu >= 0) & in_adj
        small = tx.merge_slot(small, sc_eff, deg_eff, p, fresh,
                              torch.clamp(lv, min=0), was,
                              torch.clamp(lu, min=0), exists)

        # --- row-level array updates ---
        new_lbl = torch.where(add_i, torch.where(fresh, p, lv),
                              torch.where(dv_i, -1, lv))
        tx._write(label_now, v, vs[i] >= 0, new_lbl)
        hit = (own_row == u) & (u >= 0)
        w1_val = torch.where(add_i, row,
                             torch.where(de_i & hit, -1, own_row))
        tx._write(adj, v, fresh | de_i, w1_val)
        row_u = adj[safe_u.reshape(1)][0]         # after write 1 (self-loops)
        tx._write(adj, safe_u, de_i,
                  torch.where((row_u == v) & (u >= 0), -1, row_u))

        # --- scale-in after DEL_VERTEX (faithful apply_del_vertex) ---
        if autoscaling:
            small, label_now = _scale_in_journal(small, label_now, kn, dv_i)

    return _with_small(state, small, assignment=label_now,
                       present=label_now >= 0, adj=adj)


def run_window_mixed(
    state: PartitionState,
    ets: torch.Tensor,
    vs: torch.Tensor,
    rows: torch.Tensor,
    t0: int,
    *,
    policy: str,
    cfg: EngineConfig,
    knobs: torch.Tensor | None = None,
) -> PartitionState:
    """One window of interleaved ADD / DEL_VERTEX / DEL_EDGE events,
    bit-identical to the faithful engine (static knob). ``knobs`` as in
    ``run_window_adds``."""
    check_row_width(state, rows)
    n = state.assignment.shape[0]
    if knobs is None:
        knobs = tx.knob_tensor(cfg, n, vs.device)
    return _window_mixed_lane(
        state, ets, vs, rows, t0, tx.Knobs(*knobs.unbind()),
        choose=tx.make_chooser(cfg.balance_guard, policy),
        autoscaling=policy == "sdp" and cfg.autoscale,
    )


def lane_autoscaling(policy_idx, autoscale, autoscale_mode: str) -> list:
    """Each sweep lane's resolved autoscale: on where the sweep's mode is
    ``"dynamic"`` and the lane is an SDP lane with ``cfg.autoscale`` (JAX's
    ``do_scale = auto & (pidx == sdp)`` under ``autoscaling=dynamic``)."""
    if autoscale_mode not in ("off", "dynamic"):
        raise ValueError(f"autoscale_mode={autoscale_mode!r} is unknown "
                         "(expected 'off' or 'dynamic')")
    sdp = tx.POLICY_INDEX["sdp"]
    return [autoscale_mode == "dynamic" and bool(a) and int(p) == sdp
            for p, a in zip(policy_idx, autoscale)]


def window_starts(T: int, window: int) -> range:
    """The first events of a sweep's windows over ``T`` events, which must
    be a multiple of ``window`` (right-padded with EVENT_PAD)."""
    if T % window:
        raise ValueError(f"the stream's {T} events are not a multiple of "
                         f"the window ({window}): right-pad with EVENT_PAD")
    return range(0, T, window)


def lane_events(x: torch.Tensor, b: int, shared_stream: bool):
    """Lane ``b``'s events of a sweep's (L, T[, D]) stream, or the shared
    (T[, D]) stream itself."""
    return x if shared_stream else x[b]


def sweep_window_mixed(
    states: list,              # one PartitionState per lane
    kns: torch.Tensor,         # (L, 7) f32 knobs (knob_tensor per lane)
    policy_idx,                # (L,) host ints into POLICIES order
    autoscale,                 # (L,) host bools (cfg.autoscale per lane)
    ets: torch.Tensor,         # (L, T) per-lane — or (T,) shared — events
    vs: torch.Tensor,          # (L, T) / (T,)
    rows: torch.Tensor,        # (L, T, max_deg) / (T, max_deg)
    t0: int,                   # global event index of the first event
    *,
    balance_guard: str,
    autoscale_mode: str,       # "off" | "dynamic"
    window: int = 256,
    shared_stream: bool = False,
) -> list:
    """A stream of mixed windows across all sweep lanes — the plain lanes
    of JAX's ``sweep_window_mixed``: per lane, every ``window`` events go
    through ``_window_mixed_lane`` under the lane's policy and resolved
    autoscale (``lane_autoscaling``). Every window takes the mixed path,
    pure-ADD ones too, as JAX's sweep does. T must be a multiple of
    ``window`` (right-pad with EVENT_PAD). Lanes are independent, so each
    runs its windows in turn; each lane's state is consumed (its O(n)
    leaves updated in place) and the new states are returned in lane
    order."""
    check_row_width(states[0], rows)
    starts = window_starts(ets.shape[-1], window)
    autos = lane_autoscaling(policy_idx, autoscale, autoscale_mode)
    out = []
    for b, state in enumerate(states):
        kn = tx.Knobs(*kns[b].unbind())
        choose = tx.make_chooser(balance_guard, policy_idx=policy_idx[b])
        et_b, vs_b, rows_b = (lane_events(x, b, shared_stream)
                              for x in (ets, vs, rows))
        for i0 in starts:
            sl = slice(i0, i0 + window)
            state = _window_mixed_lane(state, et_b[sl], vs_b[sl], rows_b[sl],
                                       t0 + i0, kn, choose=choose,
                                       autoscaling=autos[b])
        out.append(state)
    return out


def _pad_to(arr: torch.Tensor, length: int, fill) -> torch.Tensor:
    pad = length - arr.shape[0]
    if pad <= 0:
        return arr
    tail = torch.full((pad,) + tuple(arr.shape[1:]), fill, dtype=arr.dtype,
                      device=arr.device)
    return torch.cat([arr, tail])


def run_stream_windowed(
    stream: VertexStream,
    *,
    policy: str = "sdp",
    cfg: EngineConfig | None = None,
    seed: int = 0,
    window: int = 256,
    use_kernel: bool = False,
    geometry: Geometry | None = None,
    device=None,
) -> PartitionState:
    """Host loop: fixed windows of ``window`` events per step on
    ``device`` (default the CUDA card; raises if there is none).

    Pure-ADD windows take ``run_window_adds``; windows with deletions take
    ``run_window_mixed``. ``use_kernel=True`` routes both through the
    kernels (``fused_chooser.ops``): pure-ADD windows through
    ``run_window_adds_fused``, mixed ones through ``run_window_mixed_fused``.
    Each kernel wrapper runs its plain version for CPU tensors, so on the
    CPU ``use_kernel=True`` exercises the kernel pipelines' plain halves."""
    cfg = cfg or EngineConfig()
    geom = resolve_geometry(stream, cfg, geometry)
    state = init_state(geom.n, geom.max_deg, geom.k_max, cfg.k_init, seed,
                       device=device)
    dev = state.edge_load.device
    T = stream.num_events
    kw = {}
    if use_kernel:
        from repro_torch.kernels.fused_chooser.ops import (
            WindowTables, run_window_adds_fused as adds_fn,
            run_window_mixed_fused as mixed_fn,
        )
        # every window's random table from draws of many windows each (no
        # window writes state.key)
        tables = WindowTables(window, -(-T // window) * window)
    else:
        adds_fn, mixed_fn = run_window_adds, run_window_mixed
    knobs = tx.knob_tensor(cfg, geom.n, dev)

    et = np.asarray(stream.etype)
    et_d = torch.as_tensor(et, dtype=_I32).to(dev)
    vx = torch.as_tensor(stream.vertex, dtype=_I32).to(dev)
    nb = torch.as_tensor(normalize_rows(stream.nbrs, geom.max_deg)).to(dev)

    for t in range(0, T, window):
        end = min(t + window, T)
        vs_w = _pad_to(vx[t:end], window, -1)
        rows_w = _pad_to(nb[t:end], window, -1)
        if use_kernel:
            kw["rand_tab"] = tables.take(state, t)
        if np.all(et[t:end] == EVENT_ADD):
            state = adds_fn(state, vs_w, rows_w, t, policy=policy, cfg=cfg,
                            knobs=knobs, **kw)
        else:
            state = mixed_fn(state, _pad_to(et_d[t:end], window, EVENT_PAD),
                             vs_w, rows_w, t, policy=policy, cfg=cfg,
                             knobs=knobs, **kw)
    return state
