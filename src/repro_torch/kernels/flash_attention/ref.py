"""Plain PyTorch version of the flash_attention kernel: the same function as
``repro.kernels.flash_attention.ref.attention_ref`` — dense attention with
GQA, a sliding window, a logit softcap and a query position offset, all in
f32, cast to ``q.dtype``. It is also the differentiable path that
``ops.attention``'s backward recomputes through."""
from __future__ import annotations

import torch

NEG_INF = -1e30      # the masked logit of the JAX package


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  softcap: float = 0.0, q_offset: int = 0):
    """q: (B, H, Sq, D); k, v: (B, Hkv, Sk, D) → (B, H, Sq, D).

    Query i sits at position ``q_offset + i``, key j at position j; a key
    is visible if ``q_pos >= k_pos`` (``causal``) and ``q_pos - k_pos <
    window`` (``window > 0``). Views with any strides are accepted.
    """
    b, h, sq, d = q.shape
    group = h // k.shape[1]
    kk = k.repeat_interleave(group, dim=1)
    vv = v.repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk.float()) * (d ** -0.5)
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    q_pos = q_offset + torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(k.shape[2], device=q.device)[None, :]
    mask = torch.ones((sq, k.shape[2]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window > 0:
        mask &= (q_pos - k_pos) < window
    s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    p = p / torch.sum(p, dim=-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", p, vv.float()).to(q.dtype)
