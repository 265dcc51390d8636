"""The window RNG kernel (``csrc/window_rng.cu``) and its wrapper.

The window engines draw one random number per event: ``randint(fold_in(key,
t0 + i), (), 0, m)``, with ``m`` the number of active partitions when the
event is decided. ``window_rng`` computes, in one launch, the (W, K) table
of that draw for every ``m`` in 1..K, which the window kernels index at
``num_partitions - 1`` — or, for (L, 2) keys, the (L, W, K) block of L such
tables (a sweep step's lanes): integers, bit-equal to the plain version
(``ref.window_rng_ref``, a loop over ``transition.rand_index_table``). A
table's rows are independent of one another, so one draw of W = n × 256
rows is the tables of n consecutive 256-event windows
(``fused_chooser.ops.WindowTables``). No Pallas kernel corresponds: the
JAX package draws them with XLA ops inside its jitted window programs.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.common import (
    check_input, check_launch, load_kernel, on_cuda, stream_ptr,
)
from repro_torch.kernels.window_rng.ref import window_rng_ref

_M32 = 0xFFFFFFFF
MAX_TABLES = 65535                 # the kernel's grid.y


def _lib():
    lib = load_kernel("window_rng")
    fn = lib.window_rng_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_uint, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def window_rng(key: torch.Tensor, t0: int, w: int, k: int) -> torch.Tensor:
    """The (w, k) int32 table of the draws for 1..k partitions of the
    window of ``w`` events starting at global event ``t0`` (taken modulo
    2^32) under the (2,) uint32 ``key``; for (L, 2) keys the (L, w, k)
    tables of L windows from the same ``t0``, table j under ``key[j]``
    (a sweep step's lanes). A key on the card launches
    the kernel once (counted in ``window_rng.launches``) and reads nothing
    back to the host; a key on the CPU runs the plain version."""
    if not on_cuda(key):
        return window_rng_ref(key, t0, w, k)
    lanes = 1 if key.dim() == 1 else key.shape[0]
    check_input(key, "key", torch.uint32,
                (2,) if key.dim() == 1 else (lanes, 2))
    if w < 1 or k < 1 or not 1 <= lanes <= MAX_TABLES:
        raise ValueError(f"window_rng needs w >= 1, k >= 1 and 1..{MAX_TABLES}"
                         f" keys, got w={w}, k={k}, {lanes} keys")
    shape = (w, k) if key.dim() == 1 else (lanes, w, k)
    table = torch.empty(shape, dtype=torch.int32, device=key.device)
    err = _lib()(key.data_ptr(), int(t0) & _M32, table.data_ptr(), lanes, w,
                 k, stream_ptr(key.device))
    check_launch(err, "window_rng")
    window_rng.launches += 1
    return table


window_rng.launches = 0
