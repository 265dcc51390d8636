"""The mixed window's prep scan as one CUDA kernel (``csrc/window_prep.cu``)
and its wrapper.

Which labels a slot of a mixed window can observe does not depend on the
partition choices (``fused_chooser`` module docstring), so a prep scan
turns the window's events into the fused chooser's touch tables — per
slot the scalar row, the (D,) committed labels of its score sources and
the last earlier slot that relabelled each — and makes the window's
adjacency row writes. The JAX package runs it as a ``lax.scan`` inside the
jitted window program (``src/repro/kernels/fused_chooser/ops.py:113``); its
plain version here is ``ref.prepare_window_ref``, a Python loop. The kernel
runs a block a slot: presence and touch indices come from the event list
alone, and each adjacency row touched by the window is walked through its
own chain of slots by the block of the first of them (see the source for
why that equals the serial scan; ``ref.prepare_window_chains`` is a CPU
model of the same decomposition). It also writes the committed journal
``label0`` and the final ``last_touch``. Like the plain version it updates
``state.adj`` in place and leaves ``state.present`` unwritten.

``window_prep_rows`` is the kernel's row-block form, round 1 of the
vertex-sharded window (``repro_torch.runtime.shard_session``): one block of
rows against the whole window, its plain version ``ref.prepare_rows_ref``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.state import PartitionState
from repro_torch.kernels.common import (
    SMEM_MAX, check_input, check_launch, load_kernel, on_cuda, stream_ptr,
)
from repro_torch.kernels.fused_chooser.fused_chooser import EV_COLS
from repro_torch.kernels.fused_chooser.ref import (
    RowPrep, WindowPrep, prepare_rows_ref, prepare_window_ref,
)

_I32 = torch.int32


def prep_smem_bytes(w: int) -> int:
    """Shared memory of the kernel at a window of ``w`` slots (csrc's
    ``smem_bytes``): five (W,) slot arrays and a five-array hash table of
    the least power of two >= 4 W entries."""
    return 4 * (5 * w + 5 * (1 << max(2, (4 * w - 1).bit_length())))


@functools.cache
def prep_max_w() -> int:
    """The longest window the kernel takes (2,048 slots)."""
    w = 1
    while prep_smem_bytes(w + 1) <= SMEM_MAX:
        w += 1
    return w


def _lib(entry: str = "window_prep_launch", pointers: int = 11,
         ints: int = 3):
    fn = getattr(load_kernel("window_prep"), entry)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * ints \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check_window(w: int, d: int, n: int) -> None:
    if w < 1 or d < 1 or n < 1:
        raise ValueError(f"window_prep needs a window of at least one slot, "
                         f"one column and one vertex, got rows of shape "
                         f"{(w, d)} over {n} vertices")
    if w > prep_max_w():
        raise ValueError(
            f"window_prep takes windows of up to {prep_max_w()} slots: at "
            f"{w} its {prep_smem_bytes(w)} bytes of shared memory pass the "
            f"{SMEM_MAX} a block can have")


def window_prep(state: PartitionState, ets, vs, rows) -> WindowPrep:
    """The prep tables of one mixed window of ``ets``, ``vs`` (W,) and
    ``rows`` (W, D) against ``state``, whose adjacency becomes the
    post-window one in place. CUDA tensors launch the kernel (counted in
    ``window_prep.launches``); CPU tensors run the plain loop."""
    if not on_cuda(state.adj, state.present, ets, vs, rows):
        return prepare_window_ref(state, ets, vs, rows)
    w, d = rows.shape
    n = state.assignment.shape[0]
    for name, t, shape in (("ets", ets, (w,)), ("vs", vs, (w,)),
                           ("rows", rows, (w, d)),
                           ("assignment", state.assignment, (n,)),
                           ("adj", state.adj, (n, d))):
        check_input(t, name, _I32, shape)
    check_input(state.present, "present", torch.bool, (n,))
    _check_window(w, d, n)
    dev = vs.device
    label0 = torch.empty((n,), dtype=_I32, device=dev)
    last_touch = torch.empty((n,), dtype=_I32, device=dev)
    ev = torch.empty((w, EV_COLS), dtype=_I32, device=dev)
    src_lbl = torch.empty((w, d), dtype=_I32, device=dev)
    touch = torch.empty((w, d), dtype=_I32, device=dev)
    err = _lib()(
        ets.data_ptr(), vs.data_ptr(), rows.data_ptr(),
        state.assignment.data_ptr(), state.present.data_ptr(),
        state.adj.data_ptr(), label0.data_ptr(), last_touch.data_ptr(),
        ev.data_ptr(), src_lbl.data_ptr(), touch.data_ptr(), w, d, n,
        stream_ptr(dev))
    check_launch(err, "window_prep")
    window_prep.launches += 1
    return WindowPrep(ev, src_lbl, touch, label0, last_touch, state.adj)


window_prep.launches = 0


def window_prep_rows(adj, present, ets, vs, rows, lo: int) -> RowPrep:
    """Round 1 of a vertex-sharded window on one row block: rows ``lo`` ..
    ``lo + n_loc - 1`` (``adj`` (n_loc, D), updated in place; ``present``
    (n_loc,), not written) against the window ``ets``, ``vs`` (W,), ``rows``
    (W, D). CUDA tensors launch the kernel's row-block form (counted in
    ``window_prep_rows.launches``); CPU tensors run the plain loop."""
    if not on_cuda(adj, present, ets, vs, rows):
        return prepare_rows_ref(adj, present, ets, vs, rows, lo)
    w, d = rows.shape
    n_loc = adj.shape[0]
    for name, t, shape in (("ets", ets, (w,)), ("vs", vs, (w,)),
                           ("rows", rows, (w, d)), ("adj", adj, (n_loc, d))):
        check_input(t, name, _I32, shape)
    check_input(present, "present", torch.bool, (n_loc,))
    _check_window(w, d, n_loc)
    if lo < 0:
        raise ValueError(f"window_prep_rows: the block's first row lo={lo} "
                         "must be >= 0")
    dev = vs.device
    rows_dv = torch.empty((w, d), dtype=_I32, device=dev)
    flags = torch.empty((w, 4), dtype=_I32, device=dev)
    err = _lib("window_prep_rows_launch", 7, 4)(
        ets.data_ptr(), vs.data_ptr(), rows.data_ptr(), present.data_ptr(),
        adj.data_ptr(), rows_dv.data_ptr(), flags.data_ptr(), w, d, int(lo),
        n_loc, stream_ptr(dev))
    check_launch(err, "window_prep_rows")
    window_prep_rows.launches += 1
    return RowPrep(rows_dv, flags)


window_prep_rows.launches = 0
