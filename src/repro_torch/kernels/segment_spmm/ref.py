"""Plain PyTorch version of the segment_spmm kernel: the same function as
``repro.kernels.segment_spmm.ref.segment_spmm_ref``, in the Pallas
kernel's order of operations (slots added in order into a zeroed f32
accumulator), so that the CUDA kernel agrees with it bit for bit."""
from __future__ import annotations

import torch


def segment_spmm_ref(x: torch.Tensor, adj_ell: torch.Tensor, *,
                     mode: str = "sum") -> torch.Tensor:
    """(N, F) f32: ``out[v] = Σ`` (or the mean) over ``adj_ell[v, d] >= 0``
    of ``x[adj_ell[v, d]]`` widened to f32.

    The Dmax slots are added in order 0..Dmax-1 into an f32 accumulator
    that starts at zero, a ``-1`` slot adding 0.0 (its fetch reads row 0);
    ``mean`` divides by ``max(count, 1)`` as an f32 tensor.
    """
    if mode not in ("sum", "mean"):
        raise ValueError(f"mode must be 'sum' or 'mean', got {mode!r}")
    valid = adj_ell >= 0
    safe = torch.where(valid, adj_ell, 0).to(torch.int64)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    out = torch.zeros((adj_ell.shape[0], x.shape[1]), dtype=torch.float32,
                      device=x.device)
    for slot in range(adj_ell.shape[1]):
        row = x[safe[:, slot]].to(torch.float32)
        out = out + torch.where(valid[:, slot, None], row, zero)
    if mode == "mean":
        cnt = valid.sum(dim=1, keepdim=True, dtype=torch.int32)
        out = out / torch.clamp(cnt, min=1).to(torch.float32)
    return out
