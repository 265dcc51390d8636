"""Fused window chooser: gather → score → choose → commit for a whole mixed
window in one CUDA kernel (``csrc/fused_chooser.cu``), its slot step, and
its wrapper.

Which labels a slot of a mixed window can observe does not depend on the
partition choices — presence, adjacency, freshness, and "which earlier
slot last touched this vertex" follow from the event structure alone. So
a choice-independent prep pass (``ops._prepare_window``) reduces the O(n)
label journal to window-local **touch tables**: ``src_lbl[i, d]``, the
committed label of slot i's d-th score source, and ``touch[i, d]``, the
last earlier slot that relabelled it (-1 if none), plus a per-slot scalar
row. The slot loop then carries only O(K) counters, the (W,) in-window
decisions ``w_label`` and a (K,) ``remap`` composing scale-in merges over
committed labels.

``make_slot_step`` is that loop's body in plain PyTorch, op for op the
windowed engine's journal step; ``ref.fused_window_choose_ref`` drives it
in a Python loop, and the CUDA kernel runs the same arithmetic in one
CTA. The kernel replaces ``repro.kernels.fused_chooser.fused_chooser
.fused_window_choose`` (the Pallas TPU kernel at ``fused_chooser.py:245``),
which held the window in VMEM and walked the slots in a ``fori_loop``.
On Hopper the window's counters, decisions and cut matrix live in shared
memory; a slot's (D,) rows stream from global memory while all threads
resolve labels and histogram them, and one thread runs the policy and the
scalar merge in the plain version's exact op order. It is bound by
latency — W dependent slots, each with a few block barriers — not by its
~W·(9 + 2D + K)·4 bytes.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import transition as tx
from repro_torch.graph.stream import EVENT_ADD, EVENT_DEL_VERTEX
from repro_torch.kernels.common import (
    check_input, check_launch, label_histogram, load_kernel, on_cuda,
    stream_ptr,
)

# per-slot scalar row layout (ops._prepare_window packs, the kernel unpacks)
EV_ET, EV_V, EV_FRESH, EV_WAS, EV_EXISTS = 0, 1, 2, 3, 4
EV_VLBL, EV_VTOUCH, EV_ULBL, EV_UTOUCH = 5, 6, 7, 8
EV_COLS = 9

# scalar-counter vector layout (window in/out)
SCAL_NP, SCAL_TOTAL, SCAL_CUT, SCAL_DENIED, SCAL_SCALE = 0, 1, 2, 3, 4
SCAL_N = 5

_I32 = torch.int32


def _scale_in_touch(small, w_label, remap, kn, gate):
    """transition.scale_in on the touch-table representation: the trigger
    and counter merges are the faithful engine's; only the relabel target
    differs — the (W,) in-window decisions and the (K,) committed-label
    remap instead of the O(n) journal. Future slots' w_label entries are
    -1 and src is a valid partition id, so the select cannot touch them."""
    src, dst, do = tx.scale_in_trigger(small, kn)
    do = do & gate
    return (tx.merge_counters(small, src, dst, do),
            torch.where(do & (w_label == src), dst, w_label),
            torch.where(do & (remap == src), dst, remap))


def make_slot_step(*, k_max: int, n: int, choose, autoscaling: bool):
    """One window slot on the touch-table representation. ``choose`` is a
    ``transition.make_table_chooser`` chooser. The body mirrors
    ``windowed._window_mixed_lane``'s step op for op (same cores, same
    masked counter merge, same scale gates) with the journal gathers
    replaced by touch-table lookups. ``w_label`` is updated in place."""

    def slot_step(small, w_label, remap, kn, i, ev, src_lbl, touch,
                  rand_row):
        et = ev[EV_ET]
        v = ev[EV_V]
        fresh = ev[EV_FRESH] != 0
        was = ev[EV_WAS] != 0
        exists = ev[EV_EXISTS] != 0
        add_i = et == EVENT_ADD
        dv_i = et == EVENT_DEL_VERTEX

        # --- scale-out before the ADD decision (faithful apply_add) ---
        if autoscaling:
            small = tx.scale_out(small, kn, add_i)

        def label_at(lbl_c, touch_i):
            """Current label: last in-window decision if touched, else the
            committed label pushed through the scale-in remap."""
            in_win = w_label[torch.clamp(touch_i, min=0)]
            committed = torch.where(lbl_c >= 0,
                                    remap[torch.clamp(lbl_c, min=0)], -1)
            return torch.where(touch_i >= 0, in_win, committed)

        # --- effective neighbour labels + affinity (paper Eq. 1) ---
        eff = label_at(src_lbl, touch)                        # (D,)
        sc_eff, deg_eff = label_histogram(eff, k_max)
        ridx = tx._take(rand_row, torch.clamp(small.num_partitions, min=1) - 1)
        p = choose(small, sc_eff, deg_eff, v, ridx, kn, n)

        # --- DEL_VERTEX / DEL_EDGE subjects, then the masked merge ---
        vl = label_at(ev[EV_VLBL:EV_VLBL + 1], ev[EV_VTOUCH:EV_VTOUCH + 1])[0]
        ul = label_at(ev[EV_ULBL:EV_ULBL + 1], ev[EV_UTOUCH:EV_UTOUCH + 1])[0]
        small = tx.merge_slot(small, sc_eff, deg_eff, p, fresh,
                              torch.clamp(vl, min=0), was,
                              torch.clamp(ul, min=0), exists)

        # --- record the slot's label decision (add/dv touch the subject;
        # del_edge leaves labels unchanged, so its slot stays -1 and no
        # later touch index ever points at it) ---
        new_lbl = torch.where(add_i, torch.where(fresh, p, vl),
                              torch.where(dv_i, -1, vl))
        w_label[i] = torch.where(add_i | dv_i, new_lbl, -1)

        # --- scale-in after DEL_VERTEX (faithful apply_del_vertex) ---
        if autoscaling:
            small, w_label, remap = _scale_in_touch(small, w_label, remap,
                                                    kn, dv_i)
        return small, w_label, remap, p

    return slot_step


def _lib():
    fn = load_kernel("fused_chooser").fused_chooser_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 17
                       + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def fused_window_choose(ev, src_lbl, touch, rand_tab, active, edge_load,
                        vertex_count, cut_matrix, scalars, knobs, *, n: int,
                        policy: str, balance_guard: str, autoscaling: bool):
    """One whole mixed window: returns (w_label (W,), p_sel (W,), remap
    (K,), active (K,) int32, loads (2, K) [edge_load; vertex_count],
    cut_matrix (K, K), scalars (5,)), all int32.

    Inputs are the prep tables (``ops._prepare_window``), the per-slot
    random table (``transition.rand_index_table``), the O(K) counter slice
    and the (7,) f32 knobs. CUDA tensors launch the kernel (counted in
    ``fused_window_choose.launches``); CPU tensors run the plain loop."""
    if not on_cuda(ev, src_lbl, touch, rand_tab, active, edge_load,
                   vertex_count, cut_matrix, scalars, knobs):
        from repro_torch.kernels.fused_chooser.ref import fused_window_choose_ref
        return fused_window_choose_ref(
            ev, src_lbl, touch, rand_tab, active, edge_load, vertex_count,
            cut_matrix, scalars, knobs, n=n, policy=policy,
            balance_guard=balance_guard, autoscaling=autoscaling)
    w, d = src_lbl.shape
    k = rand_tab.shape[1]
    dev = ev.device
    check_input(ev, "ev", _I32, (w, EV_COLS))
    check_input(src_lbl, "src_lbl", _I32, (w, d))
    check_input(touch, "touch", _I32, (w, d))
    check_input(rand_tab, "rand_tab", _I32, (w, k))
    check_input(active, "active", torch.bool, (k,))
    for name, t, shape in (("edge_load", edge_load, (k,)),
                           ("vertex_count", vertex_count, (k,)),
                           ("cut_matrix", cut_matrix, (k, k)),
                           ("scalars", scalars, (SCAL_N,))):
        check_input(t, name, _I32, shape)
    check_input(knobs, "knobs", torch.float32, (7,))
    if balance_guard not in ("text", "alg1"):
        raise ValueError(f"balance_guard={balance_guard!r} is unknown")
    active_i = active.to(_I32)
    out = (torch.empty((w,), dtype=_I32, device=dev),          # w_label
           torch.empty((w,), dtype=_I32, device=dev),          # p_sel
           torch.empty((k,), dtype=_I32, device=dev),          # remap
           torch.empty((k,), dtype=_I32, device=dev),          # active
           torch.empty((2, k), dtype=_I32, device=dev),        # loads
           torch.empty((k, k), dtype=_I32, device=dev),        # cut_matrix
           torch.empty((SCAL_N,), dtype=_I32, device=dev))     # scalars
    ptrs = [t.data_ptr() for t in (ev, src_lbl, touch, rand_tab, active_i,
                                   edge_load, vertex_count, cut_matrix,
                                   scalars, knobs) + out]
    err = _lib()(*ptrs, w, d, k, tx.POLICY_INDEX[policy],
                 int(balance_guard == "alg1"), int(autoscaling),
                 stream_ptr(dev))
    check_launch(err, "fused_chooser")
    fused_window_choose.launches += 1
    return out


fused_window_choose.launches = 0
