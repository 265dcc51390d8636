"""Shared neural layers of the port (the counterpart of
``repro.models.layers``): the recsys towers' and the GNNs' ``dense`` /
``mlp``, the GNNs' ``layernorm``, the LM's norms, rotary embeddings,
attention, gated MLP and layer stacking, the token cross-entropy
``softmax_xent`` (the two-tower loss's) and the LM loss's vocab-chunked
``chunked_softmax_xent``.

Params are nested dicts of tensors, laid out as in the JAX package
(``{"l0": {"w": (d_in, d_out)}, ...}``; an LM's or a GNN's layer stack
carries a leading ``(L,)`` axis), so a JAX params pytree carries over leaf
for leaf.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.flash_attention.ops import attention as _attention


def _from_numpy(a) -> torch.Tensor:
    a = np.array(a, order="C")              # a writable copy torch may own
    if a.dtype.name == "bfloat16":          # ml_dtypes' numpy bf16: same bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def leaves(tree: dict, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def params_from_numpy(np_params: dict, specs: dict, name: str,
                      device) -> dict:
    """A JAX params pytree with numpy leaves as the port's dict of tensors
    on ``device`` (bf16 leaves carried as their 16-bit patterns), checked
    leaf for leaf against ``specs`` = {leaf path: (shape, dtype)}."""
    def convert(tree):
        return {k: convert(v) if isinstance(v, dict)
                else _from_numpy(v).to(device) for k, v in tree.items()}

    out = convert(np_params)
    got = {k: (tuple(t.shape), t.dtype) for k, t in leaves(out)}
    if got != specs:
        raise ValueError(f"params do not fit {name}: got {got}, "
                         f"expected {specs}")
    return out


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


def mlp_apply(p, x, act=torch.relu, final_act: bool = False):
    """Dense layers with ``act`` between them, and after the last one too
    when ``final_act``."""
    n = len(p)
    for i in range(n):
        x = dense(p[f"l{i}"], x)
        if i < n - 1 or final_act:
            x = act(x)
    return x


def layernorm_init(d: int, *, device):
    return {"g": torch.ones((d,), dtype=torch.float32, device=device),
            "b": torch.zeros((d,), dtype=torch.float32, device=device)}


def layernorm(p, x, eps=1e-5):
    """The JAX package's formula: the mean of squared deviations, then
    ``rsqrt(v + eps)`` (``F.layer_norm`` computes its variance another
    way)."""
    m = x.mean(-1, keepdim=True)
    d = x - m
    v = (d * d).mean(-1, keepdim=True)
    return d * torch.rsqrt(v + eps) * p["g"] + p["b"]


def normal(generator, shape, scale, dtype, device):
    """N(0, scale²) drawn in f32 and stored in ``dtype``."""
    return (torch.randn(shape, generator=generator, device=device)
            * scale).to(dtype)


def rmsnorm_init(d: int, *, device):
    """The gain is f32 whatever the model's dtype, as in the JAX package."""
    return {"g": torch.ones((d,), dtype=torch.float32, device=device)}


def rmsnorm(p, x, eps=1e-6):
    """Computed in f32, cast back to ``x.dtype``."""
    xf = x.float()
    v = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(v + eps) * p["g"]).to(x.dtype)


def rope(x, positions, theta: float = 10000.0):
    """x: (..., S, H, D). positions: (..., S). Angles in f32; a bf16 ``x``
    is promoted to f32 by the rotation and cast back."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., :, None, None].to(torch.float32) * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def attention(q, k, v, *, q_offset: int, window: int, softcap: float,
              use_kernel: bool = True, chunk: int = 0):
    """The LM's attention in the model's layout: q (B, Sq, H, D), k/v
    (B, Sk, Hkv, D) → (B, Sq, H, D). Query i sits at position
    ``q_offset + i`` and key j at position j; causal, with a sliding
    ``window`` (0 = none) and a logit ``softcap`` (0 = none).

    The JAX package's ``attention_traced``, ``attention_chunked`` and
    ``attention_kv_chunked`` are one function (numerically the same math,
    ``layers.py:121-122, 146-153``); here every call goes through
    ``flash_attention.ops.attention`` on (B, H, S, D) views of the same
    memory — no transpose copy of q, k, v or a cache. ``chunk > 0`` splits
    the plain version (``use_kernel=False``) over query chunks, as
    ``attention_chunked`` does, to bound its (Sq, Sk) score memory.
    """
    qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    sq = q.shape[1]
    if use_kernel or chunk <= 0 or sq <= chunk:
        out = _attention(qh, kh, vh, True, window, softcap, q_offset,
                         use_kernel)
        return out.transpose(1, 2)
    parts = [_attention(qh[:, :, c:c + chunk], kh, vh, True, window, softcap,
                        q_offset + c, False).transpose(1, 2)
             for c in range(0, sq, chunk)]
    return torch.cat(parts, dim=1)


def attn_init(generator, d_model: int, n_heads: int, n_kv: int,
              head_dim: int, dtype, *, device):
    """Projections stored 2D (d, H*hd), as the JAX package stores them."""
    s = d_model ** -0.5
    return {
        "wq": normal(generator, (d_model, n_heads * head_dim), s, dtype, device),
        "wk": normal(generator, (d_model, n_kv * head_dim), s, dtype, device),
        "wv": normal(generator, (d_model, n_kv * head_dim), s, dtype, device),
        "wo": normal(generator, (n_heads * head_dim, d_model),
                     (n_heads * head_dim) ** -0.5, dtype, device),
    }


def gated_mlp_init(generator, d_model: int, d_ff: int, dtype, *, device):
    return {
        "wi": normal(generator, (d_model, d_ff), d_model ** -0.5, dtype, device),
        "wg": normal(generator, (d_model, d_ff), d_model ** -0.5, dtype, device),
        "wo": normal(generator, (d_ff, d_model), d_ff ** -0.5, dtype, device),
    }


def gelu(x):
    """``jax.nn.gelu``'s default, the tanh approximation (not PyTorch's
    default erf form)."""
    return F.gelu(x, approximate="tanh")


def gated_mlp(p, x, act=F.silu):
    """SwiGLU (silu) / GeGLU (gelu)."""
    return (act(x @ p["wg"]) * (x @ p["wi"])) @ p["wo"]


def stack_layer_params(init_fn, n_layers: int) -> dict:
    """Per-layer params stacked with a leading (L,) axis, as the JAX
    package's vmap-stacked ones. ``init_fn(i)`` makes layer i's dict in
    its final dtypes; the layers are made one at a time and copied into
    the stack, so only one layer's f32 draws exist at once."""
    stacked = None

    def alloc(leaf):
        return torch.empty((n_layers, *leaf.shape), dtype=leaf.dtype,
                           device=leaf.device)

    def fill(dst, src, i):
        for k, v in src.items():
            if isinstance(v, dict):
                fill(dst[k], v, i)
            else:
                dst[k][i].copy_(v)

    def tree_map(fn, tree):
        return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v)
                for k, v in tree.items()}

    for i in range(n_layers):
        layer = init_fn(i)
        if stacked is None:
            stacked = tree_map(alloc, layer)
        fill(stacked, layer, i)
    return stacked


def layer_slice(stacked: dict, i: int) -> dict:
    """Layer ``i``'s params: views into stacked ``(L, ...)`` leaves."""
    return {k: layer_slice(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------

def softmax_xent(logits, labels, *, label_mask=None):
    """Token cross-entropy; logits (..., V) f32-accumulated."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].to(torch.int64))[..., 0]
    nll = lse - ll
    if label_mask is not None:
        return torch.sum(nll * label_mask) / torch.clamp(
            torch.sum(label_mask), min=1)
    return torch.mean(nll)


def chunked_softmax_xent(x, head, labels, *, label_mask=None,
                         final_softcap: float = 0.0, chunk: int = 8192):
    """Cross-entropy over a huge vocab without materialising (T, V) logits.

    x: (T, d) final hidden states; head: (d, V); labels: (T,). A T that
    ``chunk`` divides (and that exceeds it) runs chunk by chunk, each
    chunk's logits recomputed in the backward pass (``checkpoint``, JAX's
    ``jax.checkpoint``), so one chunk × V of logits is live at a time;
    any other T is one block, as in the JAX package.
    """
    t = x.shape[0]
    mask = (torch.ones((t,), dtype=torch.float32, device=x.device)
            if label_mask is None else label_mask.float())
    if t <= chunk or t % chunk != 0:
        return _xent_block(x, head, labels, mask, final_softcap)
    nll, cnt = [], []
    for c in range(0, t, chunk):
        args = (x[c:c + chunk], head, labels[c:c + chunk],
                mask[c:c + chunk], final_softcap, False)
        if torch.is_grad_enabled():
            n, m = checkpoint(_xent_block, *args, use_reentrant=False)
        else:
            n, m = _xent_block(*args)
        nll.append(n)
        cnt.append(m)
    return torch.sum(torch.stack(nll)) / torch.clamp(
        torch.sum(torch.stack(cnt)), min=1.0)


def _xent_block(x, head, labels, mask, final_softcap, mean: bool = True):
    logits = (x @ head).float()
    if final_softcap > 0:
        logits = final_softcap * torch.tanh(logits / final_softcap)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = (lse - ll) * mask
    if mean:
        return torch.sum(nll) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.sum(nll), torch.sum(mask)
