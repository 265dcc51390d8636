"""Decoder-only LM of the port: ``repro.models.transformer`` for the five
LM archs (gemma2, phi3, deepseek-coder and the MoE archs moonshot and
llama4) in PyTorch.

GQA + RoPE, SwiGLU/GeGLU, attention and final logit soft-capping, sliding-
window layers (gemma2's alternating local 4096 / global, llama4's chunked
8192 with every 4th layer global), the MoE FFN (``moe.py``: top-k routing,
capacity-based dispatch), the forward, the training loss over a
vocab-chunked head, prefill (returning the KV cache) and the production
decode step that writes one slot of a preallocated cache in place. Every
attention call goes through ``flash_attention.ops.attention`` — the CUDA
kernel on the card, forward and training alike (its backward recomputes
through the plain version, as the JAX package's ``custom_vjp`` does).
Params are a dict laid out as the JAX package's pytree (layer stack with
a leading ``(L,)`` axis, projections 2-D ``(d, H*hd)``);
``params_from_jax`` carries one across.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.state import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.moe import MoEConfig, moe_apply, moe_init

# rows of the embedding drawn per step of init_params (an f32 copy of the
# whole 256,000 x 3584 gemma2 table would take 3.67 GB)
_INIT_CHUNK_ROWS = 1 << 16


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """The JAX package's ``LMConfig`` without the fields that steer XLA
    (``remat``, ``act_pspec``, ``kv_pspec``, ``kv_chunk``);
    ``attn_chunk`` bounds the plain attention's score memory,
    ``xent_chunk`` the loss's live logits."""
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    rope_theta: float = 10000.0
    act: str = "silu"              # 'silu' (SwiGLU) | 'gelu' (GeGLU)
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    window_pattern: tuple[int, ...] = (0,)   # cycled; 0 = global
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    moe: Optional[MoEConfig] = None
    dtype: str = "bfloat16"
    attn_chunk: int = 512     # query-chunk size of the plain attention
    xent_chunk: int = 8192    # token-chunk size for vocab cross-entropy

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    @property
    def windows(self) -> np.ndarray:
        pat = self.window_pattern
        return np.asarray([pat[i % len(pat)] for i in range(self.n_layers)],
                          np.int32)

    def param_count(self) -> int:
        d, h, kv, hd, f, v = (self.d_model, self.n_heads, self.n_kv_heads,
                              self.head_dim, self.d_ff, self.vocab)
        attn = d * hd * (h + 2 * kv) + h * hd * d
        if self.moe is not None:
            m = self.moe
            ffn = d * m.n_experts + 3 * m.n_experts * d * m.d_ff_expert
        else:
            ffn = 3 * d * f
        per_layer = attn + ffn + 2 * d
        emb = v * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + emb + d

    def active_param_count(self) -> int:
        """6·N_active·D convention for MoE rooflines."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        m = self.moe
        attn = d * self.head_dim * (self.n_heads + 2 * self.n_kv_heads) \
            + self.n_heads * self.head_dim * d
        ffn = d * m.n_experts + 3 * m.top_k * d * m.d_ff_expert
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * (attn + ffn + 2 * d) + emb + d


def _act(cfg: LMConfig):
    return torch.nn.functional.silu if cfg.act == "silu" else L.gelu


def _matrix(generator, rows: int, cols: int, scale: float, dtype, dev):
    """N(0, scale²) drawn in f32 a chunk of rows at a time, stored in
    ``dtype``."""
    out = torch.empty((rows, cols), dtype=dtype, device=dev)
    for r in range(0, rows, _INIT_CHUNK_ROWS):
        n = min(_INIT_CHUNK_ROWS, rows - r)
        out[r:r + n].copy_(torch.randn((n, cols), generator=generator,
                                       device=dev) * scale)
    return out


def init_params(cfg: LMConfig, *, generator: torch.Generator,
                device=None) -> dict:
    """Random params on ``device`` (None: the CUDA card) from ``generator``,
    which must live on that device: weights in ``cfg.dtype``, norm gains
    f32, an MoE router f32, the JAX package's scales and layout. Each
    layer is drawn in f32 and stored before the next is drawn (moonshot's
    expert stack is 553.6 M params a layer)."""
    dev = resolve_device(device)
    dt = cfg.torch_dtype
    d = cfg.d_model

    def layer(_):
        p = {
            "attn": L.attn_init(generator, d, cfg.n_heads, cfg.n_kv_heads,
                                cfg.head_dim, dt, device=dev),
            "ln1": L.rmsnorm_init(d, device=dev),
            "ln2": L.rmsnorm_init(d, device=dev),
        }
        if cfg.moe is not None:
            p["moe"] = moe_init(generator, d, cfg.moe, dt, device=dev)
        else:
            p["mlp"] = L.gated_mlp_init(generator, d, cfg.d_ff, dt,
                                        device=dev)
        return p

    params = {
        "embed": _matrix(generator, cfg.vocab, d, d ** -0.5, dt, dev),
        "layers": L.stack_layer_params(layer, cfg.n_layers),
        "ln_f": L.rmsnorm_init(d, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = _matrix(generator, d, cfg.vocab, d ** -0.5, dt,
                                    dev)
    return params


def param_specs(cfg: LMConfig) -> dict:
    """{leaf path: (shape, dtype)} of the params ``init_params`` makes."""
    d, n, dt, f32 = cfg.d_model, cfg.n_layers, cfg.torch_dtype, torch.float32
    hq, hkv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    specs = {
        "embed": ((cfg.vocab, d), dt),
        "layers/attn/wq": ((n, d, hq), dt), "layers/attn/wk": ((n, d, hkv), dt),
        "layers/attn/wv": ((n, d, hkv), dt), "layers/attn/wo": ((n, hq, d), dt),
        "layers/ln1/g": ((n, d), f32), "layers/ln2/g": ((n, d), f32),
        "ln_f/g": ((d,), f32),
    }
    if cfg.moe is not None:
        e, f = cfg.moe.n_experts, cfg.moe.d_ff_expert
        specs.update({
            "layers/moe/router": ((n, d, e), f32),
            "layers/moe/wi": ((n, e, d, f), dt),
            "layers/moe/wg": ((n, e, d, f), dt),
            "layers/moe/wo": ((n, e, f, d), dt)})
    else:
        specs.update({
            "layers/mlp/wi": ((n, d, cfg.d_ff), dt),
            "layers/mlp/wg": ((n, d, cfg.d_ff), dt),
            "layers/mlp/wo": ((n, cfg.d_ff, d), dt)})
    if not cfg.tie_embeddings:
        specs["lm_head"] = ((d, cfg.vocab), dt)
    return specs


def params_from_jax(np_params: dict, cfg: LMConfig, device) -> dict:
    """The port's params from a JAX ``init_params`` pytree with numpy
    leaves (bf16 leaves carried as their 16-bit patterns). The layout is
    the JAX one, so nothing is transposed."""
    return L.params_from_numpy(np_params, param_specs(cfg), cfg.name,
                               resolve_device(device))


def layer_params(params: dict, i: int) -> dict:
    """Layer ``i``'s params: views into the stacked ``(L, ...)`` leaves."""
    return L.layer_slice(params["layers"], i)


def project_qkv(cfg: LMConfig, h, wq, wk, wv, positions):
    """The q/k/v projections of the normed ``h`` and rope: (B, S, heads,
    hd) each, the head counts read from the weights' columns (a mesh
    entry's weights hold some of the heads)."""
    b, s, _ = h.shape
    hd = cfg.head_dim
    q = (h @ wq).reshape(b, s, -1, hd)
    k = (h @ wk).reshape(b, s, -1, hd)
    v = (h @ wv).reshape(b, s, -1, hd)
    return (L.rope(q, positions, cfg.rope_theta),
            L.rope(k, positions, cfg.rope_theta), v)


def _qkv(cfg: LMConfig, lp, x, positions):
    """ln1, the q/k/v projections and rope: (B, S, H|Hkv, hd) each."""
    h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
    a = lp["attn"]
    return project_qkv(cfg, h, a["wq"], a["wk"], a["wv"], positions)


def _ffn(cfg: LMConfig, lp, h):
    """The layer's FFN on the ln2 output: ``(y, aux)``, aux the MoE
    layer's load-balancing loss (None for a dense layer)."""
    if cfg.moe is not None:
        y, aux, _ = moe_apply(lp["moe"], h, cfg.moe)
        return y, aux
    return L.gated_mlp(lp["mlp"], h, _act(cfg)), None


def _layer_out(cfg: LMConfig, lp, x, o):
    """The attention output's projection, ln2 and the FFN, with both
    residual adds: ``(x, aux)``."""
    b, s = x.shape[:2]
    x = x + o.reshape(b, s, cfg.n_heads * cfg.head_dim) @ lp["attn"]["wo"]
    h = L.rmsnorm(lp["ln2"], x, cfg.norm_eps)
    y, aux = _ffn(cfg, lp, h)
    return x + y, aux


def _layer_fwd(cfg: LMConfig, lp, x, window: int, *, use_kernel=True):
    """One block over a whole sequence (positions 0..S-1). Returns the new
    residual stream, the layer's aux loss (None for a dense layer) and its
    (k, v), each (B, S, Hkv, hd)."""
    s = x.shape[1]
    pos = torch.arange(s, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(cfg, lp, x, pos)
    o = L.attention(q, k, v, q_offset=0, window=window,
                    softcap=cfg.attn_softcap, use_kernel=use_kernel,
                    chunk=cfg.attn_chunk)
    x, aux = _layer_out(cfg, lp, x, o)
    return x, aux, (k, v)


def backbone(params, tokens, cfg: LMConfig, *, collect_cache: bool = False,
             use_kernel: bool = True):
    """Shared trunk. tokens (B, S) → (x (B, S, d) post-ln_f, extra), where
    extra is the stacked (L, B, S, Hkv, hd) K and V if ``collect_cache``,
    else the layers' summed MoE aux loss (an f32 0 for a dense model)."""
    x = params["embed"][tokens.long()]
    windows = cfg.windows
    cache, auxes = None, []
    for i in range(cfg.n_layers):
        x, aux, (k, v) = _layer_fwd(cfg, layer_params(params, i), x,
                                    int(windows[i]), use_kernel=use_kernel)
        if not collect_cache:
            auxes.append(aux)
            continue
        if cache is None:   # written layer by layer: one copy of the cache
            cache = tuple(torch.empty((cfg.n_layers, *k.shape),
                                      dtype=k.dtype, device=k.device)
                          for _ in range(2))
        cache[0][i] = k
        cache[1][i] = v
    x = L.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    if collect_cache:
        return x, cache
    if cfg.moe is None:
        return x, torch.zeros((), dtype=torch.float32, device=x.device)
    return x, torch.sum(torch.stack(auxes))


def _head(params, cfg: LMConfig):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def final_logits(cfg: LMConfig, x, head):
    """f32 logits of ``x`` through ``head`` (the whole head or a mesh
    entry's columns of it), with the final softcap."""
    logits = (x @ head).float()
    if cfg.final_softcap > 0:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits


def _logits(params, x, cfg: LMConfig):
    return final_logits(cfg, x, _head(params, cfg))


def forward(params, tokens, cfg: LMConfig, *, collect_cache: bool = False,
            use_kernel: bool = True):
    """Train / prefill forward. tokens (B, S) → logits (B, S, V) f32, and
    the stacked KV cache if ``collect_cache`` (else the summed aux loss)."""
    x, cache = backbone(params, tokens, cfg, collect_cache=collect_cache,
                        use_kernel=use_kernel)
    return _logits(params, x, cfg), cache


def loss_fn(params, batch, cfg: LMConfig, *, use_kernel: bool = True):
    """Token cross-entropy via the vocab-chunked head (never materialises
    more than ``cfg.xent_chunk`` × V logits) plus the MoE aux loss:
    ``(loss + aux, {"xent": loss, "aux": aux})``. ``use_kernel=False``
    runs the plain attention (query-chunked by ``cfg.attn_chunk``)."""
    x, aux = backbone(params, batch["tokens"], cfg, use_kernel=use_kernel)
    b, s, d = x.shape
    mask = batch.get("mask")
    loss = L.chunked_softmax_xent(
        x.reshape(b * s, d), _head(params, cfg),
        batch["labels"].reshape(b * s),
        label_mask=None if mask is None else mask.reshape(b * s),
        final_softcap=cfg.final_softcap, chunk=cfg.xent_chunk,
    )
    return loss + aux, {"xent": loss, "aux": aux}


def prefill_step(params, tokens, cfg: LMConfig, *, use_kernel: bool = True):
    """Serving prefill: last-position logits (B, V) f32 and the KV cache
    (L, B, S, Hkv, hd) × 2."""
    x, (ck, cv) = backbone(params, tokens, cfg, collect_cache=True,
                           use_kernel=use_kernel)
    return _logits(params, x[:, -1], cfg), ck, cv


def decode_step_inplace(params, token, cache_k, cache_v, cache_len: int,
                        cfg: LMConfig, *, use_kernel: bool = True):
    """Production decode: preallocated cache, in-place slot write.

    token (B, 1); cache_[kv] (L, B, S_max, Hkv, hd) with positions
    0..cache_len-1 valid. The new token's K and V are written at slot
    ``cache_len`` of every batch row **in place** (the port updates the
    given tensors where the JAX package returns updated copies); attention
    runs over all S_max slots with the causal mask at q_pos == cache_len
    hiding whatever lies beyond the write point. Returns (logits (B, V)
    f32, cache_k, cache_v) — the same cache tensors.
    """
    b = token.shape[0]
    x = params["embed"][token.long()]
    pos = torch.full((b, 1), cache_len, dtype=torch.int32, device=x.device)
    windows = cfg.windows
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        q, k1, v1 = _qkv(cfg, lp, x, pos)
        cache_k[i, :, cache_len] = k1[:, 0].to(cache_k.dtype)
        cache_v[i, :, cache_len] = v1[:, 0].to(cache_v.dtype)
        o = L.attention(q, cache_k[i], cache_v[i], q_offset=cache_len,
                        window=int(windows[i]), softcap=cfg.attn_softcap,
                        use_kernel=use_kernel)
        x, _ = _layer_out(cfg, lp, x, o)      # decode ignores the aux loss
    x = L.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    return _logits(params, x[:, 0], cfg), cache_k, cache_v
