"""Plain PyTorch versions of the flash_attention kernels.

``attention_ref`` is the same function as
``repro.kernels.flash_attention.ref.attention_ref`` — dense attention with
GQA, a sliding window, a logit softcap and a query position offset, all in
f32, cast to ``q.dtype``. It is also the differentiable path that
``ops.attention``'s backward recomputes through.

``attention_split_ref`` is the bf16 decode kernel's math: the visible keys
cut into chunks by ``split_plan`` (the one place that arithmetic lives; the
wrapper launches by it), a partial softmax per chunk and a log-sum-exp
combine."""
from __future__ import annotations

import torch

NEG_INF = -1e30      # the masked logit of the JAX package
MIN_CHUNK = 64       # keys: a split streams at least this many
CTAS_PER_SM = 4      # the split grid's CTAs per SM (all resident: one wave)


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


def attention_lse_ref(q, k, v, *, causal: bool = True, window: int = 0,
                      softcap: float = 0.0, q_offset: int = 0):
    """``attention_ref``'s output and each row's log-sum-exp of its visible
    logits, ``(B, H, Sq)`` f32 (the quantity a merge of attention over
    disjoint key blocks weighs each block's output by). A row that sees no
    key gets an output of 0 and a log-sum-exp of -inf, so that such a
    block weighs nothing in a merge."""
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
    s = torch.where(mask, s, torch.full((), float("-inf"), device=q.device))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - torch.where(torch.isinf(lse), 0.0, lse)[..., None])
    out = torch.einsum("bhqk,bhkd->bhqd", p, vv.float()).to(q.dtype)
    return out, lse


def split_plan(sq: int, sk: int, *, causal: bool = True, window: int = 0,
               q_offset: int = 0, pairs: int = 1, n_split: int | None = None,
               num_sms: int = 132) -> tuple[int, int, int, int]:
    """How the decode kernel cuts the keys: ``(lo, hi, chunk, n_split)``.

    ``[lo, hi)`` are the keys that any of the ``sq`` query positions
    ``q_offset ..`` can see (the same arithmetic as the prefill kernel's
    tile range); split s covers ``[lo + s*chunk, min(lo + (s+1)*chunk,
    hi))``. With ``n_split=None`` the count is chosen so that the grid of
    ``pairs`` (batch × kv head) CTAs per split puts ``CTAS_PER_SM`` CTAs on
    each of ``num_sms`` SMs, with at least ``MIN_CHUNK`` keys a split and
    no split empty. A given ``n_split`` is kept as it is, and splits past
    the visible keys are then empty.
    """
    lo = max(0, q_offset - window + 1) if window > 0 else 0
    hi = min(q_offset + sq, sk) if causal else sk
    hi = max(hi, lo)
    n_vis = hi - lo
    if n_split is None:
        want = -(-CTAS_PER_SM * num_sms // max(pairs, 1))
        n_split = max(1, min(want, -(-n_vis // MIN_CHUNK)))
        chunk = max(1, -(-n_vis // n_split))
        n_split = max(1, -(-n_vis // chunk))
    else:
        chunk = max(1, -(-n_vis // n_split))
    return lo, hi, chunk, n_split


def attention_split_ref(q, k, v, n_split: int | None, *, causal: bool = True,
                        window: int = 0, softcap: float = 0.0,
                        q_offset: int = 0):
    """``attention_ref``'s function computed as the decode kernel does: per
    split of ``split_plan`` the running max ``m``, the sum ``l`` and the
    unnormalised ``acc`` over its keys (a masked key weighs exactly 0, so
    a split no row can see gives ``l = 0``), then ``sum(acc · e^(m - M)) /
    sum(l · e^(m - M))`` with ``M`` the largest ``m``. f32 inside, cast to
    ``q.dtype``. One difference: a row that sees no key (a window that
    ends before the first key) gets 0 here and from the kernel, where
    ``attention_ref`` gives the mean of all of V, as JAX's does."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = h // hkv
    lo, hi, chunk, n_split = split_plan(
        sq, sk, causal=causal, window=window, q_offset=q_offset,
        pairs=b * hkv, n_split=n_split)
    kk = k.repeat_interleave(group, dim=1).float()
    vv = v.repeat_interleave(group, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * (d ** -0.5)
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    q_pos = q_offset + torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(sk, device=q.device)[None, :]
    vis = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        vis &= q_pos >= k_pos
    if window > 0:
        vis &= (q_pos - k_pos) < window
    ms, ls, accs = [], [], []
    for i in range(n_split):
        c0, c1 = lo + i * chunk, min(lo + (i + 1) * chunk, hi)
        part = vis & (k_pos >= c0) & (k_pos < c1)
        x = torch.where(part, s, torch.full((), float("-inf"),
                                            device=q.device))
        m = torch.clamp(torch.amax(x, dim=-1, keepdim=True), min=NEG_INF)
        p = torch.exp(x - m)
        ms.append(m)
        ls.append(p.sum(dim=-1, keepdim=True))
        accs.append(torch.einsum("bhqk,bhkd->bhqd", p, vv))
    m_all = torch.stack(ms)
    w = torch.exp(m_all - torch.amax(m_all, dim=0))
    l_tot = (torch.stack(ls) * w).sum(dim=0)
    acc = (torch.stack(accs) * w).sum(dim=0)
    return (acc / torch.where(l_tot == 0, 1.0, l_tot)).to(q.dtype)
