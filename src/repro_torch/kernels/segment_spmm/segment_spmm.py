"""Segment SpMM (ELL aggregation) — the CUDA kernel ``csrc/segment_spmm.cu``
and its wrapper.

For node features x (M, F) in f32 or bf16 and an ELL adjacency (N, Dmax)
int32, padded with -1:

    out[v] = Σ_{d : adj[v,d] >= 0} float(x[adj[v,d]])      (mode "sum")
    out[v] = that sum / max(#valid, 1)                     (mode "mean")

Replaces ``repro.kernels.segment_spmm.segment_spmm`` (the Pallas TPU kernel
at ``segment_spmm.py:48``). One warp owns one row and walks its slot list
32 ids at a time (so Dmax is unbounded), its lanes striding over F and
adding the slots in order 0..Dmax-1 in f32 — bit-equal to
``segment_spmm_ref``. It is bound by bytes: the valid slots' rows, the ids
and the output, each moved once. Ids >= M are a precondition (not read
back to the host to check), as in the Pallas kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.common import (
    check_input, check_launch, load_kernel, on_cuda, stream_ptr,
)
from repro_torch.kernels.segment_spmm.ref import segment_spmm_ref

X_DTYPES = (torch.float32, torch.bfloat16)
_INT32_MAX = 2 ** 31 - 1


def _lib():
    fn = load_kernel("segment_spmm").segment_spmm_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def segment_spmm(x: torch.Tensor, adj_ell: torch.Tensor, *,
                 mode: str = "sum") -> torch.Tensor:
    """(N, F) f32 aggregation of ``x`` rows over ``adj_ell`` (-1 = padding).

    A CUDA tensor launches the kernel (and counts the launch in
    ``segment_spmm.launches``); a CPU tensor runs the plain version.
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
    if n > _INT32_MAX - 8:
        raise ValueError(f"{n} rows do not fit the kernel's int32 grid")
    out = torch.empty((n, f), dtype=torch.float32, device=x.device)
    if n == 0 or f == 0:
        return out
    err = _lib()(x.data_ptr(), adj_ell.data_ptr(), out.data_ptr(), n, f, dmax,
                 int(x.dtype == torch.bfloat16), int(mode == "mean"),
                 stream_ptr(x.device))
    check_launch(err, "segment_spmm")
    segment_spmm.launches += 1
    return out


segment_spmm.launches = 0
