"""EmbeddingBag as the models call it: ``bag_lookup``, forward only.

The JAX package's ``bag_lookup`` is a ``jax.custom_vjp`` whose backward
scatters the bag gradient into the table rows (``repro.kernels.
embedding_bag.ops``); the port's backward, an ``autograd.Function``, comes
with the recsys training slice (ROADMAP A18.2). Dispatch is by device, as
for every kernel of the port: a CUDA tensor launches the kernel, a CPU
tensor runs the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.embedding_bag.embedding_bag import embedding_bag


def bag_lookup(table: torch.Tensor, indices: torch.Tensor,
               mode: str = "sum") -> torch.Tensor:
    """(B, D) f32 bags of ``table`` rows over (B, L) int32 ``indices``."""
    if torch.is_grad_enabled() and table.requires_grad:
        raise NotImplementedError(
            "bag_lookup has no backward yet: it comes with the recsys "
            "training slice (ROADMAP A18.2)")
    return embedding_bag(table, indices, mode=mode)
