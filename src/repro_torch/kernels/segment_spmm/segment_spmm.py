"""Segment SpMM (ELL aggregation) — the CUDA kernel ``csrc/segment_spmm.cu``
and its wrapper.

For node features x (M, F) in f32 or bf16 and an ELL adjacency (N, Dmax)
int32, padded with -1:

    out[v] = Σ_{d : adj[v,d] >= 0} float(x[adj[v,d]])      (mode "sum")
    out[v] = that sum / max(#valid, 1)                     (mode "mean")

Replaces ``repro.kernels.segment_spmm.segment_spmm`` (the Pallas TPU kernel
at ``segment_spmm.py:48``). The gather runs column slab by column slab
(the built kernel's ``segment_spmm_slab_bytes()`` of each row), one warp
per output row of a slab, each lane reading 16 bytes of every gathered row
with the widest loads the row's alignment allows and adding the valid
slots in order 0..Dmax-1 in f32 — bit-equal to ``segment_spmm_ref``. Where
F spans several slabs, a first kernel compacts each row's valid ids into
scratch (``plan``), so each slab walks only those: such a call launches
two kernels. It is bound by bytes. Ids >= M
are a precondition (not read back to the host to check), as in the Pallas
kernel.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels.common import (
    check_input, check_launch, load_kernel, on_cuda, stream_ptr,
)
from repro_torch.kernels.segment_spmm.ref import segment_spmm_ref

X_DTYPES = (torch.float32, torch.bfloat16)
KERNELS = ("compact", "gather")
_INT32_MAX = 2 ** 31 - 1
_GRID_Y_MAX = 65_535


class SpmmPlan(NamedTuple):
    """What a launch needs from the host: the gather's slab count (its
    ``grid.y``) and the int32 scratch of the compaction pass (packed ids,
    counts), which runs only when F spans several slabs (None else)."""
    slabs: int
    packed: tuple | None
    count: tuple | None


def plan(n: int, dmax: int, f: int, elem_size: int,
         slab_bytes: int) -> SpmmPlan:
    """The scratch and slab split for an (N, Dmax) adjacency over (M, F)
    features of ``elem_size`` bytes; raises where the grid cannot hold it."""
    if n > _INT32_MAX - 32:
        raise ValueError(f"{n} rows do not fit the kernel's int32 grid")
    cols = slab_bytes // elem_size
    slabs = -(-f // cols)
    if slabs > _GRID_Y_MAX:
        raise ValueError(f"F = {f} needs {slabs} column slabs of {cols}; the "
                         f"grid holds {_GRID_Y_MAX}")
    if slabs == 1:
        return SpmmPlan(slabs, None, None)
    return SpmmPlan(slabs, (n, dmax), (n,))


def _lib():
    lib = load_kernel("segment_spmm")
    fn = lib.segment_spmm_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.segment_spmm_slab_bytes.restype = ctypes.c_int
    return lib


def segment_spmm(x: torch.Tensor, adj_ell: torch.Tensor, *,
                 mode: str = "sum") -> torch.Tensor:
    """(N, F) f32 aggregation of ``x`` rows over ``adj_ell`` (-1 = padding).

    A CUDA tensor launches the kernel (and counts the call in
    ``segment_spmm.launches``, and each kernel it launches — the gather,
    and the compaction where F spans several slabs — in
    ``segment_spmm.kernel_launches``); a CPU tensor runs the plain version.
    """
    if mode not in ("sum", "mean"):
        raise ValueError(f"mode must be 'sum' or 'mean', got {mode!r}")
    if not on_cuda(x, adj_ell):
        return segment_spmm_ref(x, adj_ell, mode=mode)
    if x.dtype not in X_DTYPES:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    m, f = x.shape
    n, dmax = adj_ell.shape
    check_input(x, "x", x.dtype, (m, f))
    check_input(adj_ell, "adj_ell", torch.int32, (n, dmax))
    lib = _lib()
    p = plan(n, dmax, f, x.element_size(), lib.segment_spmm_slab_bytes())
    out = torch.empty((n, f), dtype=torch.float32, device=x.device)
    if n == 0 or f == 0:
        return out
    scratch = (None, None)                 # NULL: the gather reads adj_ell
    if p.packed is not None:
        scratch = tuple(torch.empty(shape, dtype=torch.int32, device=x.device)
                        for shape in (p.packed, p.count))
    err = lib.segment_spmm_launch(
        x.data_ptr(), adj_ell.data_ptr(),
        *(None if t is None else t.data_ptr() for t in scratch),
        out.data_ptr(), n, f, dmax, int(x.dtype == torch.bfloat16),
        int(mode == "mean"), stream_ptr(x.device))
    check_launch(err, "segment_spmm")
    segment_spmm.launches += 1
    segment_spmm.kernel_launches["gather"] += 1
    if p.packed is not None:
        segment_spmm.kernel_launches["compact"] += 1
    return out


segment_spmm.launches = 0
segment_spmm.kernel_launches = dict.fromkeys(KERNELS, 0)
