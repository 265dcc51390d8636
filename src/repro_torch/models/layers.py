"""Shared neural layers of the port (the part of ``repro.models.layers``
that the recsys towers use: ``dense``, ``mlp_init``, ``mlp_apply``).

Params are nested dicts of tensors, laid out as in the JAX package
(``{"l0": {"w": (d_in, d_out)}, ...}``), so a JAX params pytree carries
over leaf for leaf. The rest of ``layers.py`` (norms, rope, attention)
comes with the LM slice (ROADMAP A18.4).
"""
from __future__ import annotations

import torch


def dense_init(generator: torch.Generator, d_in: int, d_out: int, *,
               device):
    w = torch.randn((d_in, d_out), generator=generator, device=device)
    return {"w": w * d_in ** -0.5}


def dense(p, x):
    return x @ p["w"]


def mlp_init(generator: torch.Generator, dims: list[int], *, device):
    """f32 weights, N(0, 1/d_in), as the JAX package draws them."""
    return {f"l{i}": dense_init(generator, dims[i], dims[i + 1],
                                device=device)
            for i in range(len(dims) - 1)}


def mlp_apply(p, x, act=torch.relu):
    """Dense layers with ``act`` between them (none after the last)."""
    n = len(p)
    for i in range(n):
        x = dense(p[f"l{i}"], x)
        if i < n - 1:
            x = act(x)
    return x
