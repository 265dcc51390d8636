"""Partition-affinity scoring (paper Eq. 1, batched) — the CUDA kernel
``csrc/partition_affinity.cu`` and its wrapper.

For a window of W arriving vertices with already gathered neighbour
partition labels ``labels[w, d] ∈ {-1, 0..K-1}``:

    scores[w, k] = |{d : labels[w, d] == k}|      (|E(v) ∩ P_k|)
    deg[w]       = |{d : labels[w, d] >= 0}|

Replaces ``repro.kernels.partition_affinity.partition_affinity`` (the
Pallas TPU kernel at ``partition_affinity.py:47``). The TPU version tiled
(W, D) into VMEM blocks and reduced over a sequential D grid axis; on
Hopper, one warp owns one window row, its lanes stride over D, and the K
counts live in a per-warp shared-memory histogram (integer atomics, so
the order of the adds does not matter). It is bound by bytes —
(W·D + W·K + W)·4 read and written once — which at the session's shapes
is far below a microsecond of HBM time, so launch latency sets its time.
The gather ``assignment[rows]`` stays outside the kernel, as in the JAX
package (``ops.gather_labels``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.common import (
    check_input, check_launch, load_kernel, on_cuda, stream_ptr,
)
from repro_torch.kernels.partition_affinity.ref import partition_affinity_ref

_WARPS_PER_BLOCK = 8
_SMEM_LIMIT = 48 * 1024      # default dynamic shared memory per block


def _lib():
    lib = load_kernel("partition_affinity")
    fn = lib.partition_affinity_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
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
    if k_max < 1 or _WARPS_PER_BLOCK * k_max * 4 > _SMEM_LIMIT:
        raise ValueError(
            f"k_max={k_max} does not fit the kernel's per-warp shared "
            f"histograms ({_WARPS_PER_BLOCK} x k_max int32 <= "
            f"{_SMEM_LIMIT} bytes)")
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
