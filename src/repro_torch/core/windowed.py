"""Windowed streaming engine (the port's counterpart of
``repro.core.windowed``): W events per step instead of one, bit-identical
to the faithful engine.

* ``run_window_adds`` — ADD-only windows: one batched committed-affinity
  histogram (W, K) against the window-start state (the
  ``partition_affinity`` kernel under ``use_kernel``), then a sequential
  fixup over the W slots that adds the intra-window neighbours and keeps
  the O(K) counters.
* ``run_window_mixed`` — arbitrary ADD / DEL_VERTEX / DEL_EDGE windows,
  scoring every slot from a dense per-vertex label journal. Under
  ``use_kernel`` the whole slot loop runs in the fused chooser kernel
  instead (``repro_torch.kernels.fused_chooser``).

RNG is the engines' ``fold_in(key, global_event_index)`` scheme, drawn in
one batch per window. Like every engine of the port, these consume the
state they are given (O(n) leaves updated in place).
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


def _scatter_last(dst: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
                  mask: torch.Tensor) -> None:
    """In place: ``dst[idx[j]] = vals[j]`` for every slot j with
    ``mask[j]``; of several masked slots naming one index the last wins
    (the order of XLA's CPU scatter), and unmasked slots write nothing.
    Every slot naming an index writes that index's one final value, so
    duplicate indices cannot race on the device."""
    w = idx.shape[0]
    same = (idx[:, None] == idx[None, :]) & mask[None, :]
    has = same.any(dim=1)
    last = (w - 1) - torch.argmax(same.flip(1).to(_I32), dim=1)
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


def run_window_adds(
    state: PartitionState,
    vs: torch.Tensor,       # (W,) vertex ids (-1 pad allowed)
    rows: torch.Tensor,     # (W, max_deg)
    t0: int,                # global event index of window start
    *,
    policy: str,
    cfg: EngineConfig,
    score_fn=None,
) -> PartitionState:
    """Process one ADD-only window. Bit-identical to the faithful engine."""
    check_row_width(state, rows)
    n = state.assignment.shape[0]
    w = vs.shape[0]
    k_max = state.edge_load.shape[0]
    dev = vs.device
    kn = tx.make_knobs(cfg, n, dev)
    choose = tx.make_chooser(cfg.balance_guard, policy)
    autoscale = policy == "sdp" and cfg.autoscale
    is_add = vs >= 0
    safe_vs = torch.where(is_add, vs, 0)
    slots = torch.arange(w, dtype=_I32, device=dev)

    scores_c, deg_c = (score_fn or committed_scores)(state, rows)
    # window position of each vertex, for the intra-window neighbour fixup
    pos_of = torch.full((n,), -1, dtype=_I32, device=dev)
    _scatter_last(pos_of, safe_vs, slots, is_add)
    valid = rows >= 0
    win_pos = torch.where(valid, pos_of[torch.where(valid, rows, 0)], -1)
    intra_all = (win_pos >= 0) & (win_pos < slots[:, None])
    safe_pos = torch.clamp(win_pos, min=0)
    fresh_c = is_add & ~state.present[safe_vs]
    hi, lo = rng.draw_words(state.key, t0 + slots.to(torch.int64))

    small = _small(state)
    w_assign = torch.full((w,), -1, dtype=_I32, device=dev)
    for i in range(w):
        if autoscale:
            # the faithful engine scales out per ADD event only
            small = tx.scale_out(small, kn, is_add[i])
        intra = intra_all[i]
        nb_wa = torch.where(intra, w_assign[safe_pos[i]], -1)
        sc = scores_c[i] + label_histogram(nb_wa, k_max)[0]
        deg = deg_c[i] + intra.sum(dtype=_I32)
        p = choose(small, sc, deg, safe_vs[i], (hi[i], lo[i]), kn, n)
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

    fresh = is_add & (w_assign >= 0)
    _scatter_last(state.assignment, safe_vs, w_assign, fresh)
    _scatter_last(state.present, safe_vs, fresh, fresh)
    _scatter_last(state.adj, safe_vs, rows, fresh)
    return _with_small(state, small)



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
) -> PartitionState:
    """One window of interleaved ADD / DEL_VERTEX / DEL_EDGE events,
    bit-identical to the faithful engine (static knob)."""
    check_row_width(state, rows)
    n = state.assignment.shape[0]
    return _window_mixed_lane(
        state, ets, vs, rows, t0, tx.make_knobs(cfg, n, vs.device),
        choose=tx.make_chooser(cfg.balance_guard, policy),
        autoscaling=policy == "sdp" and cfg.autoscale,
    )



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
    kernels: pure-ADD windows score with ``partition_affinity``, mixed
    windows run the fused chooser. Each kernel wrapper runs its plain
    version for CPU tensors, so on the CPU ``use_kernel=True`` exercises
    the kernel pipelines' plain halves."""
    cfg = cfg or EngineConfig()
    geom = resolve_geometry(stream, cfg, geometry)
    state = init_state(geom.n, geom.max_deg, geom.k_max, cfg.k_init, seed,
                       device=device)
    dev = state.edge_load.device
    if use_kernel:
        from repro_torch.kernels.fused_chooser.ops import run_window_mixed_fused
        from repro_torch.kernels.partition_affinity.ops import scores_for_state
        score_fn = scores_for_state
        mixed_fn = run_window_mixed_fused
    else:
        score_fn = None
        mixed_fn = run_window_mixed

    et = np.asarray(stream.etype)
    et_d = torch.as_tensor(et, dtype=_I32).to(dev)
    vx = torch.as_tensor(stream.vertex, dtype=_I32).to(dev)
    nb = torch.as_tensor(normalize_rows(stream.nbrs, geom.max_deg)).to(dev)

    T = stream.num_events
    for t in range(0, T, window):
        end = min(t + window, T)
        vs_w = _pad_to(vx[t:end], window, -1)
        rows_w = _pad_to(nb[t:end], window, -1)
        if np.all(et[t:end] == EVENT_ADD):
            state = run_window_adds(state, vs_w, rows_w, t, policy=policy,
                                    cfg=cfg, score_fn=score_fn)
        else:
            state = mixed_fn(state, _pad_to(et_d[t:end], window, EVENT_PAD),
                             vs_w, rows_w, t, policy=policy, cfg=cfg)
    return state
