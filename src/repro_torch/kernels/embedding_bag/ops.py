"""EmbeddingBag as the models call it: ``bag_lookup``, with its backward.

The JAX package's ``bag_lookup`` is a ``jax.custom_vjp`` whose backward
scatters the bag gradient into the table rows (``repro.kernels.
embedding_bag.ops``); here it is a ``torch.autograd.Function`` whose
backward is ``embedding_bag_backward``, the dense f32 table gradient.
Dispatch is by device, as for every kernel of the port: CUDA tensors
launch the kernels (``embedding_bag`` forward, ``embedding_bag_backward``
backward), CPU tensors run their plain versions. The indices get no
gradient.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.embedding_bag.embedding_bag import (
    embedding_bag, embedding_bag_backward,
)


class _BagLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, indices, mode):
        ctx.save_for_backward(indices)
        ctx.num_rows, ctx.mode = table.shape[0], mode
        return embedding_bag(table, indices, mode=mode)

    @staticmethod
    def backward(ctx, g):
        (indices,) = ctx.saved_tensors
        return embedding_bag_backward(g.contiguous(), indices, ctx.num_rows,
                                      mode=ctx.mode), None, None


def bag_lookup(table: torch.Tensor, indices: torch.Tensor,
               mode: str = "sum") -> torch.Tensor:
    """(B, D) f32 bags of ``table`` rows over (B, L) int32 ``indices``.

    A table that needs a gradient must be f32, as the training config
    holds it: JAX gives a bf16 table an f32 gradient, which autograd would
    cast back to bf16."""
    if torch.is_grad_enabled() and table.requires_grad \
            and table.dtype != torch.float32:
        raise ValueError(
            f"bag_lookup's backward takes float32 tables, got {table.dtype}: "
            "its gradient is the dense f32 table of JAX's bag_lookup")
    return _BagLookup.apply(table, indices, mode)
