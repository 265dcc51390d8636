"""Plain PyTorch version of the embedding_bag kernel: the same function as
``repro.kernels.embedding_bag.ref.embedding_bag_ref``, in the Pallas
kernel's order of operations, so that both frameworks and the CUDA kernel
agree bit for bit."""
from __future__ import annotations

import torch


def embedding_bag_ref(table: torch.Tensor, indices: torch.Tensor, *,
                      mode: str = "sum") -> torch.Tensor:
    """(B, D) f32 bags: ``out[b] = Σ`` (or the mean) over ``indices[b, l]
    >= 0`` of ``table[indices[b, l]]`` widened to f32.

    The L slots are added in order 0..L-1 into an f32 accumulator that
    starts at zero, a ``-1`` slot adding 0.0 (its fetch reads row 0, never
    row -1); ``mean`` divides by ``max(count, 1)`` as an f32 tensor.
    """
    if mode not in ("sum", "mean"):
        raise ValueError(f"mode must be 'sum' or 'mean', got {mode!r}")
    valid = indices >= 0
    safe = torch.where(valid, indices, 0).to(torch.int64)
    zero = torch.zeros((), dtype=torch.float32, device=table.device)
    out = torch.zeros((indices.shape[0], table.shape[1]), dtype=torch.float32,
                      device=table.device)
    for slot in range(indices.shape[1]):
        row = table[safe[:, slot]].to(torch.float32)
        out = out + torch.where(valid[:, slot, None], row, zero)
    if mode == "mean":
        cnt = valid.sum(dim=1, keepdim=True, dtype=torch.int32)
        out = out / torch.clamp(cnt, min=1).to(torch.float32)
    return out
