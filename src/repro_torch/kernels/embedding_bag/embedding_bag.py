"""EmbeddingBag (gather + bag reduce) and its backward — the CUDA kernels
of ``csrc/embedding_bag.cu`` and their wrappers.

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

``embedding_bag_backward`` is the dense (V, D) f32 table gradient of a
bag lookup: each row the sum of its slots' bag gradients (divided by the
bag's count of valid slots for ``mean``) in ascending flat position
order from +0.0 — the order of JAX's scatter in ``bag_lookup``'s backward
(``repro.kernels.embedding_bag.ops._bwd``) and of ``index_add_`` on the
host, so it is bit-equal to ``embedding_bag_backward_ref``. The wrapper
sorts int64 keys ``row << 32 | position`` on the card (``torch.sort``:
index preparation, the order the kernel follows) and zero-fills the
output; one warp a row then walks its run of positions in order
(``csrc/embedding_bag.cu``'s note says why).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.common import (
    check_input, check_launch, load_kernel, on_cuda, stream_ptr,
)
from repro_torch.kernels.embedding_bag.ref import (
    embedding_bag_backward_ref, embedding_bag_ref,
)

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


def _backward_lib():
    fn = load_kernel("embedding_bag").embedding_bag_backward_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def backward_order(indices: torch.Tensor, num_rows: int):
    """The backward kernel's index preparation: the flat (row, position)
    keys ``row << 32 | position`` of (B, L) ``indices``, sorted (a -1 slot
    keyed to the sentinel row ``num_rows``, after every real row), and each
    bag's count of valid slots as int32."""
    valid = indices >= 0
    rows = torch.where(valid, indices, num_rows).reshape(-1).to(torch.int64)
    pos = torch.arange(rows.numel(), dtype=torch.int64, device=rows.device)
    keys = torch.sort(torch.bitwise_or(torch.bitwise_left_shift(rows, 32),
                                       pos)).values
    return keys, valid.sum(dim=1, dtype=torch.int32)


def backward_launch(g: torch.Tensor, keys: torch.Tensor, counts: torch.Tensor,
                    out: torch.Tensor, slots: int, mean: bool) -> None:
    """One launch of the backward kernel into the zero-filled ``out``, on
    the order ``backward_order`` built; not counted (``chip_smoke.py``
    times and re-checks the kernel through it)."""
    v, d = out.shape
    err = _backward_lib()(g.data_ptr(), keys.data_ptr(), counts.data_ptr(),
                          out.data_ptr(), keys.numel(), slots, d, v,
                          int(mean), stream_ptr(g.device))
    check_launch(err, "embedding_bag_backward")


def embedding_bag_backward(g: torch.Tensor, indices: torch.Tensor,
                           num_rows: int, *, mode: str = "sum") -> torch.Tensor:
    """The (num_rows, D) f32 table gradient of ``embedding_bag(table,
    indices, mode=mode)`` for the (B, D) f32 bag gradient ``g``.

    CUDA tensors launch the kernel (counted in
    ``embedding_bag_backward.launches``) after the wrapper has sorted the
    order and zero-filled the output; CPU tensors run the plain version.
    """
    if mode not in ("sum", "mean"):
        raise ValueError(f"mode must be 'sum' or 'mean', got {mode!r}")
    if not on_cuda(g, indices):
        return embedding_bag_backward_ref(g, indices, num_rows, mode=mode)
    b, l = indices.shape
    d = g.shape[1] if g.dim() == 2 else -1
    check_input(g, "g", torch.float32, (b, d))
    check_input(indices, "indices", torch.int32, (b, l))
    if not 0 < num_rows <= _INT32_MAX - 1:
        raise ValueError(f"num_rows={num_rows} must be in [1, 2^31 - 1)")
    if b * l > _INT32_MAX:
        raise ValueError(f"{b} x {l} slots do not fit the kernel: B * L "
                         "< 2^31")
    out = torch.zeros((num_rows, d), dtype=torch.float32, device=g.device)
    if b * l == 0 or d == 0:
        return out
    keys, counts = backward_order(indices, num_rows)
    backward_launch(g, keys, counts, out, l, mode == "mean")
    embedding_bag_backward.launches += 1
    return out


embedding_bag_backward.launches = 0
