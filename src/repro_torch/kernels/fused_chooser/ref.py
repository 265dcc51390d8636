"""Plain PyTorch versions of the mixed window's kernels: the prep scan
(``prepare_window_ref``, a Python loop over the slots; its row-block form
``prepare_rows_ref`` for vertex-sharded states) and the fused
window chooser (the slot step ``fused_chooser.make_slot_step`` driven by a
Python loop; its sweep form ``fused_window_choose_lanes_ref``, that loop
once per lane); and CPU models of how their CUDA kernels split the work, for
the tests (``prepare_window_chains``, the ``warp_*`` reductions)."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import transition as tx
from repro_torch.core.config import POLICIES
from repro_torch.core.state import PartitionState
from repro_torch.core.windowed import small_from_args, small_outputs
from repro_torch.graph.stream import (
    EVENT_ADD, EVENT_DEL_EDGE, EVENT_DEL_VERTEX, EVENT_PAD,
)
from repro_torch.kernels.fused_chooser.fused_chooser import (
    EV_COLS, EV_EXISTS, make_slot_step,
)

_I32 = torch.int32


class WindowPrep(NamedTuple):
    """Choice-independent window tables (``ops`` module docstring)."""
    ev: torch.Tensor          # (W, EV_COLS) per-slot scalars
    src_lbl: torch.Tensor     # (W, D) committed labels of score sources
    touch: torch.Tensor       # (W, D) last label-touching slot (< i), -1 none
    label0: torch.Tensor      # (n,) committed journal (present ? label : -1)
    last_touch: torch.Tensor  # (n,) final label-touching slot per vertex
    adj: torch.Tensor         # (n, D) post-window adjacency


def prepare_window_ref(state: PartitionState, ets, vs, rows) -> WindowPrep:
    """The prep loop. Presence, adjacency, freshness and touch indices
    depend only on the event structure, so the kernel's slot loop needs no
    O(n) state at all. The adjacency row writes replicate
    ``windowed._window_mixed_lane`` op for op (including the self-loop
    order of the two DEL_EDGE row writes); ``state.adj`` is updated in
    place and becomes the post-window adjacency; ``state.present`` is not
    written."""
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
    ev = torch.empty((w, EV_COLS), dtype=_I32, device=dev)
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


class RowPrep(NamedTuple):
    """One row block's emissions of a mixed window (``prepare_rows_ref``),
    each 0 unless the block owns the vertex it reads; summed over the
    blocks they are the whole state's."""
    rows_dv: torch.Tensor     # (W, D) a DEL_VERTEX's row at its slot, +2
    flags: torch.Tensor       # (W, 4) fresh, was, exists' v half, u present


def prepare_rows_ref(adj, present, ets, vs, rows, lo: int) -> RowPrep:
    """The row-block prep loop: rows ``lo`` .. ``lo + n_loc - 1`` of a
    vertex-sharded state (``adj`` (n_loc, D), ``present`` (n_loc,))
    against a whole window, op for op the shard-local scan of
    ``src/repro/runtime/shard_session.py:117-149``. The block applies the
    faithful adjacency and presence writes to its own rows (writes to
    other rows are dropped; the self-loop order of the two DEL_EDGE writes
    kept) and emits, owner-masked, the deleted vertex's row +2, ``fresh``,
    ``was`` and the two DEL_EDGE halves (``exists`` is their product).
    ``adj`` is updated in place; ``present`` is not written."""
    n_loc = adj.shape[0]
    w, d = rows.shape
    dev = vs.device
    ets = torch.where(vs >= 0, ets, EVENT_PAD)
    is_add = ets == EVENT_ADD
    is_dv = ets == EVENT_DEL_VERTEX
    is_de = ets == EVENT_DEL_EDGE
    safe_vs = torch.where(vs >= 0, vs, 0)
    present = present.clone()
    rows_dv = torch.empty((w, d), dtype=_I32, device=dev)
    flags = torch.empty((w, 4), dtype=_I32, device=dev)

    def owned(g):
        return (g >= lo) & (g < lo + n_loc)

    def loc(g):                      # clamped local index
        return torch.clamp(g - lo, 0, n_loc - 1)

    for i in range(w):
        v = safe_vs[i]
        row = rows[i]
        add_i, dv_i, de_i = is_add[i], is_dv[i], is_de[i]
        lv = loc(v)
        own_row = tx._take(adj, lv)
        u = row[0]
        safe_u = torch.clamp(u, min=0)
        lu = loc(safe_u)
        o_v, o_u = owned(v), owned(safe_u)

        pv = tx._take(present, lv)
        fresh = add_i & ~pv
        was = dv_i & pv
        in_adj = (own_row == u).any() & (u >= 0)
        rows_dv[i] = torch.where(dv_i & o_v, own_row + 2, 0)
        flags[i] = torch.stack([
            fresh & o_v, was & o_v, de_i & pv & in_adj & o_v,
            tx._take(present, lu) & o_u]).to(_I32)

        tx._write(present, lv, (add_i | dv_i) & o_v, add_i)
        row_v_de = torch.where((own_row == u) & (u >= 0), -1, own_row)
        w1_val = torch.where(add_i, row, torch.where(de_i, row_v_de, own_row))
        tx._write(adj, lv, (fresh | de_i) & o_v, w1_val)
        row_u = tx._take(adj, lu)    # after write 1 (self-loops)
        tx._write(adj, lu, de_i & o_u,
                  torch.where((row_u == v) & (u >= 0), -1, row_u))
    return RowPrep(rows_dv, flags)


def prepare_window_chains(state: PartitionState, ets, vs, rows
                          ) -> WindowPrep:
    """A CPU model of the ``window_prep`` kernel's decomposition (tests
    only; same arguments, outputs and in-place adjacency update as
    ``prepare_window_ref``). First, from the event list alone, each slot's
    previous toucher of a vertex (``touch_before``: the kernel's (first,
    last, count) shortcut, else a scan down to the first touch), presence
    and freshness; then each adjacency row the window touches walked
    through its own chain of slots, from its pre-window value, on its own
    — the order of the rows is free."""
    et = np.where(vs.numpy() >= 0, ets.numpy(), EVENT_PAD)
    v = np.maximum(vs.numpy(), 0)
    rows_n = rows.numpy()
    u = rows_n[:, 0]
    w, d = rows_n.shape
    present0 = state.present.numpy()
    label0 = np.where(present0, state.assignment.numpy(), -1).astype(np.int32)
    adj = state.adj.numpy()          # a view: the row writes land in place

    touches: dict[int, list[int]] = {}
    for j in range(w):
        if et[j] in (EVENT_ADD, EVENT_DEL_VERTEX):
            touches.setdefault(int(v[j]), []).append(j)

    def touch_before(x: int, i: int) -> int:
        ts = touches.get(x)
        if not ts or ts[0] >= i:
            return -1
        if ts[-1] < i:
            return ts[-1]
        if len(ts) == 2:
            return ts[0]
        for j in range(i - 1, ts[0], -1):
            if et[j] in (EVENT_ADD, EVENT_DEL_VERTEX) and v[j] == x:
                return j
        return ts[0]

    def present_at(x: int, i: int) -> bool:
        lt = touch_before(x, i)
        return bool(et[lt] == EVENT_ADD) if lt >= 0 else bool(present0[x])

    ev = np.zeros((w, EV_COLS), np.int32)
    src_lbl = np.full((w, d), -1, np.int32)
    touch = np.full((w, d), -1, np.int32)
    chains: dict[int, list[int]] = {}
    for i in range(w):
        vi, su = int(v[i]), max(int(u[i]), 0)
        pv, pu = present_at(vi, i), present_at(su, i)
        fresh = et[i] == EVENT_ADD and not pv
        ev[i, :5] = (et[i], vi, fresh, et[i] == EVENT_DEL_VERTEX and pv,
                     0)
        ev[i, 5:] = (label0[vi], touch_before(vi, i), label0[su],
                     touch_before(su, i))
        if et[i] == EVENT_ADD:
            r = rows_n[i]
            src_lbl[i] = np.where(r >= 0, label0[np.maximum(r, 0)], -1)
            touch[i] = [touch_before(int(x), i) if x >= 0 else -1
                        for x in r]
        de = et[i] == EVENT_DEL_EDGE and u[i] >= 0
        if fresh or et[i] == EVENT_DEL_VERTEX or de:
            chains.setdefault(vi, []).append(i)
        if de and u[i] != vi:
            chains.setdefault(int(u[i]), []).append(i)

    for x, slots in chains.items():
        row = adj[x].copy()
        for s in slots:
            if et[s] == EVENT_ADD:                      # a fresh ADD
                row = rows_n[s].copy()
            elif et[s] == EVENT_DEL_VERTEX:             # scores its row
                src_lbl[s] = np.where(row >= 0, label0[np.maximum(row, 0)],
                                      -1)
                touch[s] = [touch_before(int(r), s) if r >= 0 else -1
                            for r in row]
            elif v[s] == x:                             # write 1
                hit = row == u[s]
                ev[s, EV_EXISTS] = bool(hit.any()) and present_at(x, s) \
                    and present_at(int(u[s]), s)
                row[hit] = -1
            else:                                       # write 2
                row[row == v[s]] = -1
        adj[x] = row

    last_touch = np.full(label0.shape, -1, np.int32)
    for x, ts in touches.items():
        last_touch[x] = ts[-1]
    return WindowPrep(*(torch.from_numpy(a) for a in (
        ev, src_lbl, touch, label0, last_touch)), state.adj)


def fused_window_choose_ref(ev, src_lbl, touch, rand_tab, active, edge_load,
                            vertex_count, cut_matrix, scalars, knobs, *,
                            n: int, policy: str, balance_guard: str,
                            autoscaling: bool):
    """Same signature and outputs as ``fused_chooser.fused_window_choose``,
    on any device."""
    w = ev.shape[0]
    k_max = int(rand_tab.shape[-1])
    kn = tx.Knobs(*knobs.unbind())
    slot_step = make_slot_step(
        k_max=k_max, n=n, autoscaling=autoscaling,
        choose=tx.make_table_chooser(balance_guard, policy))
    small = small_from_args(active, edge_load, vertex_count, cut_matrix,
                            scalars)
    w_label = torch.full((w,), -1, dtype=_I32, device=ev.device)
    remap = torch.arange(k_max, dtype=_I32, device=ev.device)
    psel = torch.zeros((w,), dtype=_I32, device=ev.device)
    for i in range(w):
        small, w_label, remap, psel[i] = slot_step(
            small, w_label, remap, kn, i, ev[i], src_lbl[i], touch[i],
            rand_tab[i])
    return (w_label, psel, remap, *small_outputs(small))


def fused_window_choose_lanes_ref(ev, src_lbl, touch, rand_tab, active,
                                  edge_load, vertex_count, cut_matrix,
                                  scalars, knobs, flags, *, n: int,
                                  balance_guard: str, dynamic: bool):
    """Same signature and outputs as
    ``fused_chooser.fused_window_choose_lanes``, on any device:
    ``fused_window_choose_ref`` once per lane, lane b under policy
    ``POLICIES[flags[b, 0]]`` and autoscaling ``dynamic and flags[b, 1]``.
    Reads ``flags`` on the host; an index that names no policy raises."""
    outs = []
    for b, (pidx, gate) in enumerate(flags.tolist()):
        if not 0 <= pidx < len(POLICIES):
            raise ValueError(f"lane {b}: policy index {pidx} names no "
                             f"policy (0 .. {len(POLICIES) - 1})")
        outs.append(fused_window_choose_ref(
            ev[b], src_lbl[b], touch[b], rand_tab[b], active[b],
            edge_load[b], vertex_count[b], cut_matrix[b], scalars[b],
            knobs[b], n=n, policy=POLICIES[pidx],
            balance_guard=balance_guard, autoscaling=dynamic and gate != 0))
    return tuple(torch.stack(x) for x in zip(*outs))


# ---------------------------------------------------------------------------
# a model of the CUDA kernel's warp reductions
# ---------------------------------------------------------------------------
#
# The kernel keeps partition j on lane j % 32 as entry t = j // 32 of the
# lane's arrays. These functions run its K-wide reductions in that layout,
# step for step, so the CPU tests can hold them against the sequential
# loops of ``repro_torch.core.transition``.

_INT_MAX = 2 ** 31 - 1


def _lanes(x: torch.Tensor, fill) -> torch.Tensor:
    """(KT, 32) layout of a (K,) vector: [t, lane] is partition 32 t +
    lane; entries past K hold ``fill``."""
    k = x.shape[0]
    grid = torch.full((-(-k // 32) * 32,), fill, dtype=x.dtype)
    grid[:k] = x
    return grid.reshape(-1, 32)


def warp_argmin(val: torch.Tensor) -> int:
    """``Lanes::argmin``: each lane keeps its first least entry (t
    ascending, a strict <), lanes without a partition hold (INT_MAX,
    INT_MAX); then the least value over the lanes, and the least index of
    the lanes that hold it."""
    k = val.shape[0]
    v = _lanes(val.to(torch.int64), _INT_MAX).tolist()
    best, idx = [_INT_MAX] * 32, [_INT_MAX] * 32
    for lane in range(32):
        for t in range(len(v)):
            j = 32 * t + lane
            if j < k and (idx[lane] == _INT_MAX or v[t][lane] < best[lane]):
                best[lane], idx[lane] = v[t][lane], j
    m = min(best)                                   # __reduce_min_sync
    return min(i if b == m else _INT_MAX for b, i in zip(best, idx))


def warp_masked_argmin(x: torch.Tensor, mask: torch.Tensor) -> int:
    """``Lanes::masked_argmin``: masked-out entries count as 2^30."""
    return warp_argmin(torch.where(mask, x, 2 ** 30))


def _ballots(active: torch.Tensor) -> list[int]:
    """The active set as the kernel's per-t 32-bit masks."""
    grid = _lanes(active.to(torch.int64), 0).tolist()
    return [sum(bit << lane for lane, bit in enumerate(row)) for row in grid]


def warp_nth_active(active: torch.Tensor, i: int) -> int:
    """``Lanes::nth_active``: i modulo the active count, then the lane whose
    popc prefix of the active mask equals what is left of i (a ballot)."""
    masks = _ballots(active)
    cnt = sum(bin(m).count("1") for m in masks)
    i = i % max(cnt, 1)                             # floor_mod
    found, before = 0, 0
    for t, m in enumerate(masks):
        hits = [lane for lane in range(32) if (m >> lane) & 1
                and before + bin(m & ((1 << lane) - 1)).count("1") == i]
        if hits:
            found = 32 * t + hits[0]                # __ffs of the ballot
        before += bin(m).count("1")
    return found


def warp_affinity_choice(active, scores, edge_load, ridx: int) -> int:
    """``affinity_choice``: the best score over active partitions (a warp
    max), its ties broken by the least load, else the ridx-th active."""
    sv = torch.where(active, scores, -1)
    best = int(sv.max())                            # __reduce_max_sync
    if best <= 0:
        return warp_nth_active(active, ridx)
    return warp_masked_argmin(edge_load, active & (sv == best))


def warp_banded_pick(h, active, vertex_count) -> int:
    """``banded_pick``: a butterfly of fmaxf over the lanes for the best h,
    then the least vertex count within 1e-6 of it among active ones."""
    grid = _lanes(h, float("-inf"))
    lane_best = grid.max(dim=0).values               # each lane's t loop
    for off in (16, 8, 4, 2, 1):                     # __shfl_xor_sync
        lane_best = torch.fmax(lane_best, lane_best[torch.arange(32) ^ off])
    floor_ = lane_best[0] - torch.tensor(1e-6, dtype=torch.float32)
    return warp_masked_argmin(vertex_count, active & (h >= floor_))
