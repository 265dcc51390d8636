"""Wiring of the fused chooser kernel into the window engine.

Pipeline per mixed window (see fused_chooser.py for the design):

  1. ``_prepare_window`` — choice-independent prep: a loop over the W slots
     carrying (adj, present, last_touch) that emits the per-slot scalar
     rows and the (W, D) committed-label / touch-index tables, and performs
     the faithful adjacency row writes (adjacency never depends on
     partition choices). Plain PyTorch on the device.
  2. ``transition.rand_index_table`` — the per-slot random draw for every
     possible partition count, in one batch.
  3. ONE ``fused_window_choose`` launch for all W slots.
  4. apply — two O(n) gathers rebuild the final journal from
     (w_label, remap): ``label = w_label[last_touch]`` where touched, else
     ``remap[committed]``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import transition as tx
from repro_torch.core.config import EngineConfig
from repro_torch.core.geometry import check_row_width
from repro_torch.core.state import PartitionState
from repro_torch.graph.stream import (
    EVENT_ADD, EVENT_DEL_EDGE, EVENT_DEL_VERTEX, EVENT_PAD,
)
from repro_torch.kernels.fused_chooser import fused_chooser as fk

_I32 = torch.int32


class WindowPrep(NamedTuple):
    """Choice-independent window tables (see module docstring)."""
    ev: torch.Tensor          # (W, EV_COLS) per-slot scalars
    src_lbl: torch.Tensor     # (W, D) committed labels of score sources
    touch: torch.Tensor       # (W, D) last label-touching slot (< i), -1 none
    label0: torch.Tensor      # (n,) committed journal (present ? label : -1)
    last_touch: torch.Tensor  # (n,) final label-touching slot per vertex
    adj: torch.Tensor         # (n, D) post-window adjacency


def _prepare_window(state: PartitionState, ets, vs, rows) -> WindowPrep:
    """The prep loop. Presence, adjacency, freshness and touch indices
    depend only on the event structure, so the kernel's slot loop needs no
    O(n) state at all. The adjacency row writes replicate
    ``windowed._window_mixed_lane`` op for op (including the self-loop
    order of the two DEL_EDGE row writes); ``state.adj`` is updated in
    place and becomes the post-window adjacency."""
    n = state.assignment.shape[0]
    w, d = rows.shape
    dev = vs.device
    ets = torch.where(vs >= 0, ets, EVENT_PAD)
    is_add = ets == EVENT_ADD
    is_dv = ets == EVENT_DEL_VERTEX
    is_de = ets == EVENT_DEL_EDGE
    safe_vs = torch.where(vs >= 0, vs, 0)
    label0 = torch.where(state.present, state.assignment, -1)
    rows_add = torch.where(is_add[:, None], rows, -1)
    u_all = rows[:, 0]
    safe_u_all = torch.clamp(u_all, min=0)

    adj = state.adj
    present = state.present.clone()
    last_touch = torch.full((n,), -1, dtype=_I32, device=dev)
    ev = torch.empty((w, fk.EV_COLS), dtype=_I32, device=dev)
    src_lbl = torch.empty((w, d), dtype=_I32, device=dev)
    touch = torch.empty((w, d), dtype=_I32, device=dev)
    for i in range(w):
        v = safe_vs[i]
        row = rows[i]
        add_i, dv_i, de_i = is_add[i], is_dv[i], is_de[i]
        own_row = adj[v.reshape(1)][0]
        u, safe_u = u_all[i], safe_u_all[i]
        pv = tx._take(present, v)

        fresh = add_i & ~pv
        was = dv_i & pv
        in_adj = (own_row == u).any() & (u >= 0)
        exists = de_i & pv & tx._take(present, safe_u) & in_adj

        src_row = torch.where(add_i, rows_add[i],
                              torch.where(dv_i, own_row, -1))
        src_ok = src_row >= 0
        src_safe = torch.clamp(src_row, min=0)
        src_lbl[i] = torch.where(src_ok, label0[src_safe], -1)
        touch[i] = torch.where(src_ok, last_touch[src_safe], -1)
        vu = torch.stack([v, safe_u])
        ev[i] = torch.stack([
            ets[i], v, fresh.to(_I32), was.to(_I32), exists.to(_I32),
            *torch.stack([label0[vu], last_touch[vu]], dim=1).reshape(4)])

        # presence / touch updates (add and del_vertex touch the subject)
        touched = add_i | dv_i
        tx._write(present, v, touched, add_i)
        tx._write(last_touch, v, touched, i)

        # faithful adjacency row writes (windowed._window_mixed_lane)
        hit = (own_row == u) & (u >= 0)
        w1_val = torch.where(add_i, row, torch.where(de_i & hit, -1, own_row))
        tx._write(adj, v, fresh | de_i, w1_val)
        row_u = adj[safe_u.reshape(1)][0]          # after write 1 (self-loops)
        tx._write(adj, safe_u, de_i,
                  torch.where((row_u == v) & (u >= 0), -1, row_u))
    return WindowPrep(ev, src_lbl, touch, label0, last_touch, adj)


def _fused_lane(state: PartitionState, ets, vs, rows, t0: int, knobs, *,
                policy: str, balance_guard: str,
                autoscaling: bool) -> PartitionState:
    """One mixed window through prep → rand table → kernel → apply."""
    w = vs.shape[0]
    k_max = state.edge_load.shape[0]
    prep = _prepare_window(state, ets, vs, rows)
    rand_tab = tx.rand_index_table(state.key, t0, w, k_max)
    scalars = torch.stack([
        state.num_partitions, state.total_edges, state.cut_edges,
        state.denied_scaleout, state.scale_events])
    w_label, _psel, remap, active, loads, cut_matrix, scal = \
        fk.fused_window_choose(
            prep.ev, prep.src_lbl, prep.touch, rand_tab, state.active,
            state.edge_load, state.vertex_count, state.cut_matrix, scalars,
            knobs, n=state.assignment.shape[0], policy=policy,
            balance_guard=balance_guard, autoscaling=autoscaling)

    # apply: rebuild the journal from the window-local decisions — two
    # O(n) gathers, no scatter ordering to get wrong
    lbl_touched = w_label[torch.clamp(prep.last_touch, 0, w - 1)]
    lbl_kept = torch.where(prep.label0 >= 0,
                           remap[torch.clamp(prep.label0, min=0)], -1)
    label_final = torch.where(prep.last_touch >= 0, lbl_touched, lbl_kept)
    return state._replace(
        assignment=label_final, present=label_final >= 0, adj=prep.adj,
        active=active != 0, edge_load=loads[0], vertex_count=loads[1],
        num_partitions=scal[fk.SCAL_NP], total_edges=scal[fk.SCAL_TOTAL],
        cut_edges=scal[fk.SCAL_CUT], denied_scaleout=scal[fk.SCAL_DENIED],
        scale_events=scal[fk.SCAL_SCALE], cut_matrix=cut_matrix,
    )


def run_window_mixed_fused(state: PartitionState, ets, vs, rows, t0: int,
                           *, policy: str,
                           cfg: EngineConfig) -> PartitionState:
    """Drop-in for ``windowed.run_window_mixed`` (static knob),
    bit-identical to the faithful engine."""
    check_row_width(state, rows)
    n = state.assignment.shape[0]
    knobs = torch.tensor(tx.knob_values(cfg, n), dtype=torch.float32,
                         device=vs.device)
    return _fused_lane(state, ets, vs, rows, t0, knobs, policy=policy,
                       balance_guard=cfg.balance_guard,
                       autoscaling=policy == "sdp" and cfg.autoscale)

