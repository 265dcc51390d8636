"""EmbeddingBag (gather + bag reduce) — the CUDA kernel
``csrc/embedding_bag.cu`` and its wrapper.

For a table (V, D) in f32 or bf16 and bags of indices (B, L) int32,
padded with -1:

    out[b] = Σ_{l : idx[b,l] >= 0} float(table[idx[b,l]])      (mode "sum")
    out[b] = that sum / max(#valid, 1)                          (mode "mean")

Replaces ``repro.kernels.embedding_bag.embedding_bag`` (the Pallas TPU
kernel at ``embedding_bag.py:49``). The TPU version scalar-prefetched the
indices and gathered one row tile per step of a sequential slot grid
axis; on Hopper one warp owns one bag: its ids come in with one load and
reach the lanes by shuffles, each lane loads ``load_width`` bytes of every
row (16 where the row width and the table's base allow: a bf16 row of
D = 256 is one warp-wide load), a chunk of rows is in flight before any is
added, and the slots are summed in order 0..L-1 in f32, so it is bit-equal
to ``embedding_bag_ref``. Any L. It is bound by bytes — every valid slot's
row, the ids and the output floats. Indices >= V are a precondition (not
read back to the host to check), as in the Pallas kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.common import (
    check_input, check_launch, load_kernel, on_cuda, stream_ptr,
)
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref

_INT32_MAX = 2 ** 31 - 1
TABLE_DTYPES = (torch.float32, torch.bfloat16)
LOAD_WIDTHS = (16, 8, 4, 2)        # bytes a lane loads of a row
KERNELS = tuple(f"load{w}" for w in LOAD_WIDTHS)


def load_width(d: int, elem_size: int, base: int) -> int:
    """The bytes a lane loads of a row: the widest of 16, 8 and 4 that
    divides both the row's ``d * elem_size`` bytes and the table's base
    address ``base``, else the element's own width."""
    for width in LOAD_WIDTHS[:-1]:
        if width >= elem_size and (d * elem_size) % width == 0 \
                and base % width == 0:
            return width
    return elem_size


def _lib():
    lib = load_kernel("embedding_bag")
    fn = lib.embedding_bag_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def embedding_bag(table: torch.Tensor, indices: torch.Tensor, *,
                  mode: str = "sum") -> torch.Tensor:
    """(B, D) f32 bags of ``table`` rows over ``indices`` (-1 = padding).

    A CUDA tensor launches the kernel at the ``load_width`` of the table
    (the call counted in ``embedding_bag.launches``, the width in
    ``embedding_bag.kernel_launches``); a CPU tensor runs the plain
    version.
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
    if b > _INT32_MAX - 32:
        raise ValueError(f"{b} bags do not fit the kernel: B < 2^31")
    out = torch.empty((b, d), dtype=torch.float32, device=table.device)
    if b == 0 or d == 0:
        return out
    width = load_width(d, table.element_size(), table.data_ptr())
    err = _lib()(table.data_ptr(), indices.data_ptr(), out.data_ptr(), b, l,
                 d, int(table.dtype == torch.bfloat16), int(mode == "mean"),
                 width, stream_ptr(table.device))
    check_launch(err, "embedding_bag")
    embedding_bag.launches += 1
    embedding_bag.kernel_launches[f"load{width}"] += 1
    return out


embedding_bag.launches = 0
embedding_bag.kernel_launches = dict.fromkeys(KERNELS, 0)
