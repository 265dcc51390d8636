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
host, so it is bit-equal to ``embedding_bag_backward_ref``. On the card
it is an order and a pass (``csrc/embedding_bag.cu``'s note says why):
``backward_order`` builds int32 CSR runs of positions by row (counts,
a scan to offsets, positions placed by atomic cursors, the runs of more
than 32 sorted), then one row-major pass writes every row of the dense
gradient once — zeros where no slot points, else the run's sum in
ascending position order (a row whose run is one slot is written from
its bag, which reads the bag's gradient row once for all such rows). No
int64 keys are sorted and nothing is zero-filled first.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.common import (
    check_input, check_launch, load_kernel, on_cuda, stream_ptr,
)
from repro_torch.kernels.embedding_bag.ref import (
    BackwardOrder, backward_order_ref, embedding_bag_backward_ref,
    embedding_bag_ref,
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


def _backward_fns():
    lib = load_kernel("embedding_bag")
    order, walk = (lib.embedding_bag_backward_order,
                   lib.embedding_bag_backward_pass)
    if order.argtypes is None:
        order.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p] * 7
        order.restype = ctypes.c_int
        walk.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        walk.restype = ctypes.c_int
        lib.embedding_bag_backward_scan_tile.restype = ctypes.c_int
    return order, walk, lib.embedding_bag_backward_scan_tile()


def backward_order(indices: torch.Tensor, num_rows: int) -> BackwardOrder:
    """The backward's order of (B, L) int32 ``indices`` over ``num_rows``
    rows, as int32 arrays: ``offsets`` (V + 1,), the CSR offsets of each
    row's run of flat positions; ``perm`` (B * L,), the runs (its first
    ``offsets[V]`` entries); ``counts`` (B,), each bag's valid slots. On
    the card (``csrc/embedding_bag.cu``, step (a)) a run of more than 32
    positions is ascending and a shorter one in no fixed order (the pass
    sorts it); on the CPU every run is ascending
    (``ref.backward_order_ref``)."""
    if not on_cuda(indices):
        return backward_order_ref(indices, num_rows)
    b, l = indices.shape
    check_input(indices, "indices", torch.int32, (b, l))
    order_fn, _, tile = _backward_fns()
    dev = indices.device
    n = b * l

    def ints(size):
        return torch.empty(size, dtype=torch.int32, device=dev)
    cnt = torch.zeros(num_rows, dtype=torch.int32, device=dev)
    out = BackwardOrder(ints(num_rows + 1), ints(n), ints(b))
    part, long_rows = ints(-(-num_rows // tile) + 2), ints(n // 33 + 1)
    err = order_fn(indices.data_ptr(), b, l, num_rows, cnt.data_ptr(),
                   out.offsets.data_ptr(), out.perm.data_ptr(),
                   out.counts.data_ptr(), part.data_ptr(),
                   long_rows.data_ptr(), stream_ptr(dev))
    check_launch(err, "embedding_bag_backward (order)")
    return out


def backward_launch(g: torch.Tensor, indices: torch.Tensor,
                    order: BackwardOrder, out: torch.Tensor,
                    mean: bool) -> None:
    """The pass over ``order`` (``backward_order(indices, V)``'s) into
    ``out`` (V, D), every row written: the rows of a one-slot run from
    their bags, the others row-major; not counted (``chip_smoke.py`` times
    and re-checks the pass through it)."""
    v, d = out.shape
    b, l = indices.shape
    _, walk, _ = _backward_fns()
    vec = 4 if d % 4 == 0 and g.data_ptr() % 16 == 0 \
        and out.data_ptr() % 16 == 0 else 1
    err = walk(g.data_ptr(), indices.data_ptr(), order.offsets.data_ptr(),
               order.perm.data_ptr(), order.counts.data_ptr(),
               out.data_ptr(), b, v, l, d, int(mean), vec,
               stream_ptr(g.device))
    check_launch(err, "embedding_bag_backward")


def embedding_bag_backward(g: torch.Tensor, indices: torch.Tensor,
                           num_rows: int, *, mode: str = "sum") -> torch.Tensor:
    """The (num_rows, D) f32 table gradient of ``embedding_bag(table,
    indices, mode=mode)`` for the (B, D) f32 bag gradient ``g``.

    CUDA tensors build the order (``backward_order``) and launch the pass
    that writes every row once (the call counted in
    ``embedding_bag_backward.launches``); CPU tensors run the plain
    version."""
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
    out = torch.empty((num_rows, d), dtype=torch.float32, device=g.device)
    if d == 0:
        return out
    backward_launch(g, indices, backward_order(indices, num_rows), out,
                    mode == "mean")
    embedding_bag_backward.launches += 1
    return out


embedding_bag_backward.launches = 0
