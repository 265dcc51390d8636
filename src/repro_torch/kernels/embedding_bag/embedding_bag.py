"""EmbeddingBag (gather + bag reduce) — the CUDA kernel
``csrc/embedding_bag.cu`` and its wrapper.

For a table (V, D) in f32 or bf16 and bags of indices (B, L) int32,
padded with -1:

    out[b] = Σ_{l : idx[b,l] >= 0} float(table[idx[b,l]])      (mode "sum")
    out[b] = that sum / max(#valid, 1)                          (mode "mean")

Replaces ``repro.kernels.embedding_bag.embedding_bag`` (the Pallas TPU
kernel at ``embedding_bag.py:49``). The TPU version scalar-prefetched the
indices and gathered one row tile per step of a sequential slot grid
axis; on Hopper one warp owns one bag, reads its L indices once, and its
lanes stride over D summing the slots in order 0..L-1 in f32, so it is
bit-equal to ``embedding_bag_ref``. It is bound by bytes — L·D table
elements, L indices and D output floats per bag, each moved once. Indices
>= V are a precondition (not read back to the host to check), as in the
Pallas kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.common import (
    check_input, check_launch, load_kernel, on_cuda, stream_ptr,
)
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref

_WARPS_PER_BLOCK = 8
_SMEM_LIMIT = 48 * 1024      # default dynamic shared memory per block
_INT32_MAX = 2 ** 31 - 1
TABLE_DTYPES = (torch.float32, torch.bfloat16)


def _lib():
    lib = load_kernel("embedding_bag")
    fn = lib.embedding_bag_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def embedding_bag(table: torch.Tensor, indices: torch.Tensor, *,
                  mode: str = "sum") -> torch.Tensor:
    """(B, D) f32 bags of ``table`` rows over ``indices`` (-1 = padding).

    A CUDA tensor launches the kernel (and counts the launch in
    ``embedding_bag.launches``); a CPU tensor runs the plain version.
    """
    if mode not in ("sum", "mean"):
        raise ValueError(f"mode must be 'sum' or 'mean', got {mode!r}")
    if not on_cuda(table, indices):
        return embedding_bag_ref(table, indices, mode=mode)
    if table.dtype not in TABLE_DTYPES:
        raise ValueError(f"table must be float32 or bfloat16, got {table.dtype}")
    v, d = table.shape
    b, l = indices.shape
    check_input(table, "table", table.dtype, (v, d))
    check_input(indices, "indices", torch.int32, (b, l))
    if _WARPS_PER_BLOCK * l * 4 > _SMEM_LIMIT or b > _INT32_MAX - 32:
        raise ValueError(
            f"bags ({b}, {l}) do not fit the kernel: L <= "
            f"{_SMEM_LIMIT // (4 * _WARPS_PER_BLOCK)} slots (per-warp shared "
            f"index lists) and B < 2^31")
    out = torch.empty((b, d), dtype=torch.float32, device=table.device)
    if b == 0 or d == 0:
        return out
    err = _lib()(table.data_ptr(), indices.data_ptr(), out.data_ptr(), b, l,
                 d, int(table.dtype == torch.bfloat16), int(mode == "mean"),
                 stream_ptr(table.device))
    check_launch(err, "embedding_bag")
    embedding_bag.launches += 1
    return out


embedding_bag.launches = 0
