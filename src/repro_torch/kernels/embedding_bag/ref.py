"""Plain PyTorch versions of the embedding_bag kernels: the forward, the
same function as ``repro.kernels.embedding_bag.ref.embedding_bag_ref`` in
the Pallas kernel's order of operations, and the backward, JAX's
``bag_lookup`` backward (``repro.kernels.embedding_bag.ops._bwd``) written
out literally, and the order the backward kernel walks
(``backward_order_ref``) — so that both frameworks and the CUDA kernels
agree bit for bit."""
from __future__ import annotations

from typing import NamedTuple

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


class BackwardOrder(NamedTuple):
    """The backward kernel's order of (B, L) bag ids over V rows, int32:
    row r's run of flat positions ``b * L + l`` is ``perm[offsets[r]:
    offsets[r + 1]]``; ``counts`` is each bag's number of valid slots."""
    offsets: torch.Tensor      # (V + 1,)
    perm: torch.Tensor         # (B * L,), the first offsets[V] used
    counts: torch.Tensor       # (B,)


def backward_order_ref(indices: torch.Tensor, num_rows: int) -> BackwardOrder:
    """The order of ``embedding_bag.backward_order`` with every run in
    ascending position order: the per-row counts of the valid slots, their
    exclusive prefix sums as CSR offsets, and the valid positions stably
    sorted by row (-1 slots in no run)."""
    flat = indices.reshape(-1)
    valid = flat >= 0
    pos = torch.nonzero(valid).reshape(-1)
    rows = flat[pos].to(torch.int64)
    run_len = torch.bincount(rows, minlength=num_rows)
    offsets = torch.zeros(num_rows + 1, dtype=torch.int64,
                          device=indices.device)
    offsets[1:] = torch.cumsum(run_len, 0)
    perm = torch.zeros(flat.numel(), dtype=torch.int32, device=indices.device)
    perm[:pos.numel()] = pos[torch.sort(rows, stable=True).indices].to(
        torch.int32)
    counts = (indices >= 0).sum(dim=1, dtype=torch.int32)
    return BackwardOrder(offsets.to(torch.int32), perm, counts)
