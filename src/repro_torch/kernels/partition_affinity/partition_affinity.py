"""Partition-affinity scoring (paper Eq. 1, batched) — the CUDA kernel
``csrc/partition_affinity.cu`` and its wrapper.

For a window of W arriving vertices with already gathered neighbour
partition labels ``labels[w, d] ∈ {-1, 0..K-1}``:

    scores[w, k] = |{d : labels[w, d] == k}|      (|E(v) ∩ P_k|)
    deg[w]       = |{d : labels[w, d] >= 0}|

Replaces ``repro.kernels.partition_affinity.partition_affinity`` (the
Pallas TPU kernel at ``partition_affinity.py:47``). The TPU version tiled
(W, D) into VMEM blocks and reduced over a sequential D grid axis; on
Hopper one warp owns one window row and issues all its loads of the row
at once (16-byte loads where the row is aligned), then counts: for
K <= 32 in registers, a byte a bin and four bins to a register, added
over the warp with two reductions a register; else in a per-warp
shared-memory histogram with integer atomics, as many rows a block as
shared memory holds — any K up to ``MAX_K`` (58,112). It is bound by
bytes — (W·D + W·K + W)·4 read and written once — which at the session's
shapes is far below a microsecond of HBM time, so launch latency sets its
time. The gather ``assignment[rows]`` stays outside the kernel, as in the
JAX package (``ops.gather_labels``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.common import (
    SMEM_MAX, check_input, check_launch, load_kernel, on_cuda, stream_ptr,
)
from repro_torch.kernels.partition_affinity.ref import partition_affinity_ref

MAX_K = SMEM_MAX // 4        # one row's histogram in a block's shared memory


def _lib():
    lib = load_kernel("partition_affinity")
    fn = lib.partition_affinity_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.partition_affinity_max_k.argtypes = []
        lib.partition_affinity_max_k.restype = ctypes.c_int
    return fn


def partition_affinity(labels: torch.Tensor, *, k_max: int):
    """(scores (W, K) int32, deg (W,) int32) from labels (W, D) int32.

    A CUDA tensor launches the kernel (and counts the launch in
    ``partition_affinity.launches``); a CPU tensor runs the plain version.
    """
    if not on_cuda(labels):
        return partition_affinity_ref(labels, k_max=k_max)
    w, d = labels.shape
    check_input(labels, "labels", torch.int32, (w, d))
    if not 1 <= k_max <= MAX_K:
        raise ValueError(
            f"k_max={k_max} is outside the kernel's 1..{MAX_K} partitions "
            f"(one row's int32 histogram in a block's {SMEM_MAX} bytes of "
            f"shared memory)")
    scores = torch.empty((w, k_max), dtype=torch.int32, device=labels.device)
    deg = torch.empty((w,), dtype=torch.int32, device=labels.device)
    if w == 0:
        return scores, deg
    err = _lib()(labels.data_ptr(), scores.data_ptr(), deg.data_ptr(),
                 w, d, k_max, stream_ptr(labels.device))
    check_launch(err, "partition_affinity")
    partition_affinity.launches += 1
    return scores, deg


partition_affinity.launches = 0
