"""Differentiable attention: the kernel forward, a backward that
recomputes through the plain version with autograd — exactly what the JAX
package's ``custom_vjp`` does (``repro.kernels.flash_attention.ops``; JAX
has no backward Pallas kernel, so the port has no backward kernel)."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, q_offset, use_kernel):
        ctx.save_for_backward(q, k, v)
        ctx.kw = dict(causal=causal, window=window, softcap=softcap,
                      q_offset=q_offset)
        fn = flash_attention if use_kernel else attention_ref
        return fn(q, k, v, **ctx.kw)

    @staticmethod
    def backward(ctx, g):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = attention_ref(q, k, v, **ctx.kw)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
        return dq, dk, dv, None, None, None, None, None


def attention(q, k, v, causal=True, window=0, softcap=0.0, q_offset=0,
              use_kernel=True):
    """q (B, H, Sq, D), k/v (B, Hkv, Sk, D) → (B, H, Sq, D). ``use_kernel``
    takes ``flash_attention`` (the kernel for CUDA tensors, the plain
    version for CPU ones); ``False`` takes the plain version on any device
    (the card's reference)."""
    return _Attention.apply(q, k, v, causal, int(window), float(softcap),
                            int(q_offset), use_kernel)
