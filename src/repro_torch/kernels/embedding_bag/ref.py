"""Plain PyTorch versions of the embedding_bag kernels: the forward, the
same function as ``repro.kernels.embedding_bag.ref.embedding_bag_ref`` in
the Pallas kernel's order of operations, and the backward, JAX's
``bag_lookup`` backward (``repro.kernels.embedding_bag.ops._bwd``) written
out literally — so that both frameworks and the CUDA kernels agree bit for
bit."""
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


def embedding_bag_backward_ref(g: torch.Tensor, indices: torch.Tensor,
                               num_rows: int, *,
                               mode: str = "sum") -> torch.Tensor:
    """The (num_rows, D) table gradient of a bag lookup for the (B, D) bag
    gradient ``g``, as JAX's ``_bwd``: for ``mean`` ``g`` divided by each
    bag's ``max(#valid, 1)``, broadcast to every slot, zeroed on -1 slots
    (whose index becomes 0), and scatter-added in one ``index_add_`` into a
    zero table. On the host ``index_add_`` adds a row's contributions in
    ascending slot position order, as XLA's scatter does."""
    if mode not in ("sum", "mean"):
        raise ValueError(f"mode must be 'sum' or 'mean', got {mode!r}")
    d = g.shape[1]
    valid = indices >= 0
    if mode == "mean":
        cnt = torch.clamp(valid.sum(dim=1, keepdim=True, dtype=torch.int32),
                          min=1)
        g = g / cnt.to(g.dtype)
    gl = torch.broadcast_to(g[:, None, :], tuple(indices.shape) + (d,))
    gl = torch.where(valid[..., None], gl, 0.0)
    safe = torch.where(valid, indices, 0)
    dtable = torch.zeros((num_rows, d), dtype=g.dtype, device=g.device)
    return dtable.index_add_(0, safe.reshape(-1).to(torch.int64),
                             gl.reshape(-1, d))
