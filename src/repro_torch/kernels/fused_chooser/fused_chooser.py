"""Fused window chooser: gather → score → choose → commit for a whole mixed
window in one CUDA kernel (``csrc/fused_chooser.cu``), its slot step, and
its wrapper.

Which labels a slot of a mixed window can observe does not depend on the
partition choices — presence, adjacency, freshness, and "which earlier
slot last touched this vertex" follow from the event structure alone. So
a choice-independent prep pass (``ops._prepare_window``, the
``window_prep`` kernel) reduces the O(n)
label journal to window-local **touch tables**: ``src_lbl[i, d]``, the
committed label of slot i's d-th score source, and ``touch[i, d]``, the
last earlier slot that relabelled it (-1 if none), plus a per-slot scalar
row. The slot loop then carries only O(K) counters, the (W,) in-window
decisions ``w_label`` and a (K,) ``remap`` composing scale-in merges over
committed labels.

``make_slot_step`` is that loop's body in plain PyTorch, op for op the
windowed engine's journal step; ``ref.fused_window_choose_ref`` drives it
in a Python loop, and the CUDA kernel runs the same arithmetic in one
warp. The kernel replaces ``repro.kernels.fused_chooser.fused_chooser
.fused_window_choose`` (the Pallas TPU kernel at ``fused_chooser.py:245``),
which held the window in VMEM and walked the slots in a ``fori_loop``.
On Hopper one warp carries the window's chain of dependent slots with no
block barrier: partition j lives on lane j % 32 (its counters and slot
histogram in registers), the K-wide loops are warp reductions that keep
the plain version's answers (``ref.warp_argmin``, ``ref.warp_nth_active``
model them), and the cut matrix, ``w_label`` and ``remap`` sit in shared
memory. Two producer warps count each slot's histogram one slot ahead,
leaving out the entries the slot being decided touches, which the decider
adds once their label is known. It is bound by that chain's latency, not
by its ~W·(9 + 2D + K)·4 bytes. That is the **lanes** kernel, for K <= 192
(six partitions a lane). Above that, ``dispatch`` takes the **large**
kernel: the same slot loop with the decider's K-vectors in shared memory
and the cut matrix in device memory, for any K up to ``large_max_k(W)``
(9,587 at W = 256), where its 4·(32 + W + 6K + ⌈K/32⌉) bytes of shared
memory reach the 232,448 a block can have.

``fused_window_choose_lanes`` is the sweep form of both kernels (the
Pallas kernel's traced-policy form, ``policy=None``, which the JAX sweep
vmaps over lanes): one window of each of L sweep lanes in one launch, lane
b on block b, under the policy and scale gate of its ``flags`` row. A
block runs the single-session kernel's code for that policy, so every lane
is bit-equal to a single-session launch on its inputs; W, D, K and the
balance guard are shared by the lanes.

``add_window_choose`` runs a pure-ADD window's slot loop (the JAX
package's ``lax.scan`` at ``src/repro/core/windowed.py:167``; no Pallas
kernel) from ``partition_affinity``'s committed scores and the window's
neighbour positions, on the same two layouts (``add_dispatch``): the
lanes kernel up to K = 192 — the decider's code, two producer warps that
load slot s and count its earlier neighbours' labels while the decider
decides s − 1 — and above it one decider warp on the large kernel's
layout, up to ``add_max_k(W)``. Its plain version is
``windowed.add_window_fixup_ref``.
"""
from __future__ import annotations

import bisect
import ctypes

import torch

from repro_torch.core import transition as tx
from repro_torch.graph.stream import EVENT_ADD, EVENT_DEL_VERTEX
from repro_torch.kernels.common import (
    SMEM_MAX, check_input, check_launch, label_histogram, load_kernel,
    on_cuda, stream_ptr,
)

# per-slot scalar row layout (the prep scan packs, the kernel unpacks)
EV_ET, EV_V, EV_FRESH, EV_WAS, EV_EXISTS = 0, 1, 2, 3, 4
EV_VLBL, EV_VTOUCH, EV_ULBL, EV_UTOUCH = 5, 6, 7, 8
EV_COLS = 9

# the scalar counters a window takes and returns, in ``windowed._SCALARS``
# order (num_partitions, total_edges, cut_edges, denied_scaleout,
# scale_events; the csrc's enum Scal)
SCAL_N = 5

_I32 = torch.int32

KERNELS = ("lanes", "large")
# the sweep form of each (one window of every sweep lane a launch); "lanes"
# in KERNELS is the layout (partition j on warp lane j % 32), not a sweep lane
SWEEP_KERNELS = ("sweep_lanes", "sweep_large")
LANES_MAX_K = 192            # csrc's 32 * kMaxKt: six partitions a lane
EV_PAD = 12                  # csrc's kEvPad: a scalar row's ints in smem


def large_smem_bytes(w: int, k: int) -> int:
    """Shared memory of the large kernel at a window of ``w`` slots and
    ``k`` partitions (csrc's ``large_smem_bytes``): 8 flags, two scalar
    rows, ``w_label``, six K-vectors and the active bits."""
    return 4 * (8 + 2 * EV_PAD + w + 6 * k + -(-k // 32))


def large_max_k(w: int) -> int:
    """The most partitions the large kernel takes at a window of ``w``:
    the largest K whose ``large_smem_bytes`` fit SMEM_MAX."""
    return bisect.bisect_right(range(1, SMEM_MAX), SMEM_MAX,
                               key=lambda k: large_smem_bytes(w, k))


def add_smem_bytes(w: int, k: int) -> int:
    """Shared memory of the large pure-ADD kernel (csrc's
    ``add_smem_bytes``): ``w_assign``, four K-vectors and the active
    bits."""
    return 4 * (w + 4 * k + -(-k // 32))


def add_lanes_smem_bytes(w: int, k: int) -> int:
    """Shared memory of the lanes pure-ADD kernel (csrc's
    ``add_lanes_smem_bytes``): 8 flags, two scalar rows, ``w_assign``, two
    score and two random rows, the f32 stage and the padded cut matrix."""
    return 4 * (8 + 2 * EV_PAD + w + 5 * k + k * (k + 1))


def add_max_k(w: int) -> int:
    """The most partitions the large pure-ADD kernel takes at a window of
    ``w``."""
    return bisect.bisect_right(range(1, SMEM_MAX), SMEM_MAX,
                               key=lambda k: add_smem_bytes(w, k))


def add_dispatch(w: int, k: int) -> str:
    """Which kernel the pure-ADD window of ``w`` slots over ``k``
    partitions takes: ``lanes`` up to LANES_MAX_K (where its shared memory
    fits), ``large`` above — by shape, never on failure. Raises where
    neither takes it."""
    if k < 1:
        raise ValueError(f"k_max must be >= 1, got {k}")
    if k <= LANES_MAX_K and add_lanes_smem_bytes(w, k) <= SMEM_MAX:
        return "lanes"
    if k > add_max_k(w):
        raise ValueError(
            f"k_max={k} is above the {add_max_k(w)} partitions the large "
            f"pure-ADD kernel takes at a window of {w}: its "
            f"{add_smem_bytes(w, k)} bytes of shared memory pass the "
            f"{SMEM_MAX} a block can have")
    return "large"


def dispatch(w: int, k: int) -> str:
    """Which kernel a window of ``w`` slots over ``k`` partitions takes:
    ``lanes`` up to LANES_MAX_K, ``large`` above — by shape, never on
    failure. Raises where neither takes it."""
    if k < 1:
        raise ValueError(f"k_max must be >= 1, got {k}")
    if k <= LANES_MAX_K:
        return "lanes"
    if k > large_max_k(w):
        raise ValueError(
            f"k_max={k} is above the {large_max_k(w)} partitions the large "
            f"fused_chooser kernel takes at a window of {w}: its "
            f"{large_smem_bytes(w, k)} bytes of shared memory pass the "
            f"{SMEM_MAX} a block can have")
    return "large"


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
    lib = load_kernel("fused_chooser")
    fn = lib.fused_chooser_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 17
                       + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        large = lib.fused_chooser_large_launch
        large.argtypes, large.restype = fn.argtypes, fn.restype
        lib.fused_chooser_max_k.restype = ctypes.c_int
        lib.fused_chooser_large_max_k.argtypes = [ctypes.c_int]
        lib.fused_chooser_large_max_k.restype = ctypes.c_int
        for add in (lib.add_window_launch, lib.add_window_lanes_launch):
            add.argtypes, add.restype = fn.argtypes, fn.restype
        for sweep in (lib.fused_chooser_sweep_launch,
                      lib.fused_chooser_large_sweep_launch):
            sweep.argtypes = ([ctypes.c_void_p] * 18 + [ctypes.c_int] * 6
                              + [ctypes.c_void_p])
            sweep.restype = ctypes.c_int
    return lib


def fused_window_choose(ev, src_lbl, touch, rand_tab, active, edge_load,
                        vertex_count, cut_matrix, scalars, knobs, *, n: int,
                        policy: str, balance_guard: str, autoscaling: bool):
    """One whole mixed window: returns (w_label (W,), p_sel (W,), remap
    (K,), active (K,) int32, loads (2, K) [edge_load; vertex_count],
    cut_matrix (K, K), scalars (5,)), all int32.

    Inputs are the prep tables (``ops._prepare_window``), the per-slot
    random table (``window_rng``), the O(K) counter slice
    and the (7,) f32 knobs. CUDA tensors launch the kernel that
    ``dispatch`` names (counted in ``fused_window_choose.launches`` and,
    by kernel, in ``fused_window_choose.kernel_launches``); CPU tensors run
    the plain loop."""
    if not on_cuda(ev, src_lbl, touch, rand_tab, active, edge_load,
                   vertex_count, cut_matrix, scalars, knobs):
        from repro_torch.kernels.fused_chooser.ref import fused_window_choose_ref
        return fused_window_choose_ref(
            ev, src_lbl, touch, rand_tab, active, edge_load, vertex_count,
            cut_matrix, scalars, knobs, n=n, policy=policy,
            balance_guard=balance_guard, autoscaling=autoscaling)
    w, d = src_lbl.shape
    k = rand_tab.shape[1]
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
    kernel = dispatch(w, k)
    out = launch(kernel, ev, src_lbl, touch, rand_tab, active, edge_load,
                 vertex_count, cut_matrix, scalars, knobs, policy=policy,
                 balance_guard=balance_guard, autoscaling=autoscaling)
    fused_window_choose.launches += 1
    fused_window_choose.kernel_launches[kernel] += 1
    return out


def launch(kernel, ev, src_lbl, touch, rand_tab, active, edge_load,
           vertex_count, cut_matrix, scalars, knobs, *, policy: str,
           balance_guard: str, autoscaling: bool):
    """Launches ``kernel`` (one of KERNELS) on checked CUDA inputs and
    returns ``fused_window_choose``'s outputs, uncounted: the wrapper's
    launch, and the sweep's, which times the large kernel at shapes the
    wrapper sends to the lanes kernel."""
    if not on_cuda(ev, src_lbl, touch, rand_tab, active, edge_load,
                   vertex_count, cut_matrix, scalars, knobs):
        raise ValueError("launch takes CUDA tensors")
    w, d = src_lbl.shape
    k = rand_tab.shape[1]
    dev = ev.device
    lib = _lib()
    fn = (lib.fused_chooser_launch if kernel == "lanes"
          else lib.fused_chooser_large_launch)
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
    err = fn(*ptrs, w, d, k, tx.POLICY_INDEX[policy],
             int(balance_guard == "alg1"), int(autoscaling), stream_ptr(dev))
    check_launch(err, f"fused_chooser ({kernel})")
    return out


fused_window_choose.launches = 0
fused_window_choose.kernel_launches = dict.fromkeys(KERNELS, 0)


def fused_window_choose_lanes(ev, src_lbl, touch, rand_tab, active,
                              edge_load, vertex_count, cut_matrix, scalars,
                              knobs, flags, *, n: int, balance_guard: str,
                              dynamic: bool):
    """The sweep form: one window of each of L sweep lanes in one launch.
    Every input is ``fused_window_choose``'s with a leading lane axis —
    ``ev`` (L, W, 9), ``src_lbl`` / ``touch`` (L, W, D), ``rand_tab`` (L,
    W, K), the counters (L, K), (L, K, K), (L, 5), ``knobs`` (L, 7) — plus
    ``flags`` (L, 2) int32, each lane's ``[policy index, scale gate]``
    (the JAX kernel's ``flags_ref``): lane b runs policy
    ``POLICIES[flags[b, 0]]`` and scales out and in where ``dynamic and
    flags[b, 1]``. W, D, K and ``balance_guard`` are shared. Returns the
    seven outputs of ``fused_window_choose`` with a leading L.

    CUDA tensors launch the sweep form of the kernel that ``dispatch(W,
    K)`` names, lanes on ``grid.x`` (counted in
    ``fused_window_choose_lanes.launches`` and, by kernel, in its
    ``kernel_launches`` as ``sweep_lanes`` / ``sweep_large``); a lane
    whose policy index names no policy traps the launch (a device-side
    error at the next synchronisation; the flags stay on the card, so the
    wrapper does not read them). CPU tensors run
    ``ref.fused_window_choose_lanes_ref``, which raises ``ValueError``
    there."""
    tensors = (ev, src_lbl, touch, rand_tab, active, edge_load,
               vertex_count, cut_matrix, scalars, knobs, flags)
    if not on_cuda(*tensors):
        from repro_torch.kernels.fused_chooser.ref import (
            fused_window_choose_lanes_ref,
        )
        return fused_window_choose_lanes_ref(
            *tensors, n=n, balance_guard=balance_guard, dynamic=dynamic)
    lanes, w, d = src_lbl.shape
    k = rand_tab.shape[2]
    check_input(ev, "ev", _I32, (lanes, w, EV_COLS))
    check_input(touch, "touch", _I32, (lanes, w, d))
    check_input(active, "active", torch.bool, (lanes, k))
    for name, t, shape in (("src_lbl", src_lbl, (lanes, w, d)),
                           ("rand_tab", rand_tab, (lanes, w, k)),
                           ("edge_load", edge_load, (lanes, k)),
                           ("vertex_count", vertex_count, (lanes, k)),
                           ("cut_matrix", cut_matrix, (lanes, k, k)),
                           ("scalars", scalars, (lanes, SCAL_N)),
                           ("flags", flags, (lanes, 2))):
        check_input(t, name, _I32, shape)
    check_input(knobs, "knobs", torch.float32, (lanes, 7))
    if balance_guard not in ("text", "alg1"):
        raise ValueError(f"balance_guard={balance_guard!r} is unknown")
    if lanes < 1:
        raise ValueError("fused_window_choose_lanes needs at least one lane")
    kernel = dispatch(w, k)
    out = sweep_launch(kernel, *tensors, balance_guard=balance_guard,
                       dynamic=dynamic)
    fused_window_choose_lanes.launches += 1
    fused_window_choose_lanes.kernel_launches[f"sweep_{kernel}"] += 1
    return out


def sweep_launch(kernel, ev, src_lbl, touch, rand_tab, active, edge_load,
                 vertex_count, cut_matrix, scalars, knobs, flags, *,
                 balance_guard: str, dynamic: bool):
    """Launches the sweep form of ``kernel`` (one of KERNELS) on checked
    CUDA inputs and returns ``fused_window_choose_lanes``' outputs,
    uncounted (the wrapper's launch, and the timing and card tests')."""
    tensors = (ev, src_lbl, touch, rand_tab, active, edge_load,
               vertex_count, cut_matrix, scalars, knobs, flags)
    if not on_cuda(*tensors):
        raise ValueError("sweep_launch takes CUDA tensors")
    lanes, w, d = src_lbl.shape
    k = rand_tab.shape[2]
    dev = ev.device
    lib = _lib()
    fn = (lib.fused_chooser_sweep_launch if kernel == "lanes"
          else lib.fused_chooser_large_sweep_launch)
    active_i = active.to(_I32)
    out = (torch.empty((lanes, w), dtype=_I32, device=dev),       # w_label
           torch.empty((lanes, w), dtype=_I32, device=dev),       # p_sel
           torch.empty((lanes, k), dtype=_I32, device=dev),       # remap
           torch.empty((lanes, k), dtype=_I32, device=dev),       # active
           torch.empty((lanes, 2, k), dtype=_I32, device=dev),    # loads
           torch.empty((lanes, k, k), dtype=_I32, device=dev),    # cut_matrix
           torch.empty((lanes, SCAL_N), dtype=_I32, device=dev))  # scalars
    ptrs = [t.data_ptr() for t in (ev, src_lbl, touch, rand_tab, active_i,
                                   edge_load, vertex_count, cut_matrix,
                                   scalars, knobs, flags) + out]
    err = fn(*ptrs, lanes, w, d, k, int(balance_guard == "alg1"),
             int(dynamic), stream_ptr(dev))
    check_launch(err, f"fused_chooser (sweep, {kernel})")
    return out


fused_window_choose_lanes.launches = 0
fused_window_choose_lanes.kernel_launches = dict.fromkeys(SWEEP_KERNELS, 0)


def add_window_choose(scores_c, deg_c, win_pos, fresh_c, vs, rand_tab, active,
                      edge_load, vertex_count, cut_matrix, scalars, knobs, *,
                      n: int, policy: str, balance_guard: str,
                      autoscaling: bool):
    """The slot loop of one pure-ADD window: returns (w_assign (W,),
    active (K,) int32, loads (2, K) [edge_load; vertex_count], cut_matrix
    (K, K), scalars (5,)), all int32.

    Inputs are the window's committed scores (W, K) and degrees (W,)
    (``partition_affinity``), ``win_pos`` (W, D), the window slot of each
    row entry's vertex (-1 for none), ``fresh_c`` (W,) bool, the subjects
    ``vs`` (W,) (-1 pads), the random table (W, K)
    (``window_rng``), the O(K) counter slice and the (7,) f32 knobs (see
    ``windowed.prepare_add_window``). CUDA tensors launch the pure-ADD
    kernel that ``add_dispatch`` names (counted in
    ``add_window_choose.launches`` and, by kernel, in
    ``add_window_choose.kernel_launches``); CPU tensors run the plain loop,
    ``windowed.add_window_fixup_ref``."""
    tensors = (scores_c, deg_c, win_pos, fresh_c, vs, rand_tab, active,
               edge_load, vertex_count, cut_matrix, scalars, knobs)
    if not on_cuda(*tensors):
        from repro_torch.core.windowed import add_window_fixup_ref
        return add_window_fixup_ref(
            *tensors, n=n, policy=policy, balance_guard=balance_guard,
            autoscaling=autoscaling)
    w, d = win_pos.shape
    k = rand_tab.shape[1]
    for name, t, shape in (("scores_c", scores_c, (w, k)),
                           ("deg_c", deg_c, (w,)), ("win_pos", win_pos, (w, d)),
                           ("vs", vs, (w,)), ("rand_tab", rand_tab, (w, k)),
                           ("edge_load", edge_load, (k,)),
                           ("vertex_count", vertex_count, (k,)),
                           ("cut_matrix", cut_matrix, (k, k)),
                           ("scalars", scalars, (SCAL_N,))):
        check_input(t, name, _I32, shape)
    check_input(fresh_c, "fresh_c", torch.bool, (w,))
    check_input(active, "active", torch.bool, (k,))
    check_input(knobs, "knobs", torch.float32, (7,))
    if balance_guard not in ("text", "alg1"):
        raise ValueError(f"balance_guard={balance_guard!r} is unknown")
    if w < 1 or d < 1:
        raise ValueError(f"add_window_choose needs a window of at least one "
                         f"slot and one column, got win_pos of shape "
                         f"{(w, d)}")
    kernel = add_dispatch(w, k)
    out = add_launch(kernel, *tensors, policy=policy,
                     balance_guard=balance_guard, autoscaling=autoscaling)
    add_window_choose.launches += 1
    add_window_choose.kernel_launches[kernel] += 1
    return out


def add_launch(kernel, scores_c, deg_c, win_pos, fresh_c, vs, rand_tab,
               active, edge_load, vertex_count, cut_matrix, scalars, knobs, *,
               policy: str, balance_guard: str, autoscaling: bool):
    """Launches the pure-ADD ``kernel`` (one of KERNELS) on checked CUDA
    inputs and returns ``add_window_choose``'s outputs, uncounted: the
    wrapper's launch, and the sweep's and the card tests', which launch the
    large kernel at shapes the wrapper sends to the lanes kernel."""
    tensors = (scores_c, deg_c, win_pos, fresh_c, vs, rand_tab, active,
               edge_load, vertex_count, cut_matrix, scalars, knobs)
    if not on_cuda(*tensors):
        raise ValueError("add_launch takes CUDA tensors")
    w, d = win_pos.shape
    k = rand_tab.shape[1]
    dev = win_pos.device
    lib = _lib()
    fn = (lib.add_window_lanes_launch if kernel == "lanes"
          else lib.add_window_launch)
    active_i = active.to(_I32)
    out = (torch.empty((w,), dtype=_I32, device=dev),          # w_assign
           torch.empty((k,), dtype=_I32, device=dev),          # active
           torch.empty((2, k), dtype=_I32, device=dev),        # loads
           torch.empty((k, k), dtype=_I32, device=dev),        # cut_matrix
           torch.empty((SCAL_N,), dtype=_I32, device=dev))     # scalars
    ptrs = [t.data_ptr() for t in (scores_c, deg_c, win_pos, fresh_c, vs,
                                   rand_tab, active_i, edge_load,
                                   vertex_count, cut_matrix, scalars, knobs)
            + out]
    err = fn(*ptrs, w, d, k, tx.POLICY_INDEX[policy],
             int(balance_guard == "alg1"), int(autoscaling), stream_ptr(dev))
    check_launch(err, f"fused_chooser (add_window, {kernel})")
    return out


add_window_choose.launches = 0
add_window_choose.kernel_launches = dict.fromkeys(KERNELS, 0)
