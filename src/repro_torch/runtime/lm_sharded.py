"""The LM's per-entry program on a (data [x pod], model) mesh: what XLA's
SPMD partitioner makes of the JAX package's LM steps under
``runtime.sharding.lm_param_rules`` (FSDP over the data axes, Megatron
tensor parallelism over ``model``, expert parallelism for the MoE),
written out on the port's mesh (``launch.mesh``), with every collective
an explicit call of ``runtime.collectives``.

Every sharded value is a list of per-entry tensors in the mesh's row-major
order; entry ``e`` computes on its own shards (``SpecBlocks.shards[e]``)
on its own device. The pieces are the port's one-card model
(``models.transformer``, ``models.moe``, ``models.layers``):

* **Embedding** ``P("model", da)``: the entry's rows gathered over the
  data axes, the tokens looked up in its vocabulary rows (other tokens
  give 0), then summed over ``model``. A tied embedding is also the head.
* **Attention**: ``wq`` / ``wk`` / ``wv`` gathered over the data axes one
  layer at a time; each entry takes its ``H / tp`` query heads
  (column-parallel) and runs the ``flash_attention`` kernel on them. Where
  ``tp`` does not divide ``Hkv``, ``wk`` and ``wv`` are also gathered over
  ``model`` (every entry computes every KV head; each query head still
  reads its own GQA group); where it does not divide ``H`` (a query head
  would straddle two entries' columns), ``wq`` is too, every entry
  computes every head and keeps its ``H·hd / tp`` columns of the output.
  ``wo`` is row-parallel, its partial products summed over ``model``.
* **Dense MLP**: ``wi`` / ``wg`` column-parallel, ``wo`` row-parallel.
* **MoE**: the router gathered (every model entry of a data group routes
  the same tokens); one dispatch group per data rank (the JAX package's
  ``dispatch_groups = n_dp``); each entry runs its ``E / tp`` experts'
  buffer rows and combines over them, and a sum over ``model`` adds the
  entries. The aux loss is a product of two global means: the sums are
  summed over the data axes first, then multiplied.
* **Loss**: vocabulary-parallel cross-entropy over the entry's ``V / tp``
  columns (the final softcap applied), the max and the sum of
  exponentials reduced over ``model``, the label's logit from the entry
  that holds it; the mean over the global token count.
* **AdamW** on shards (``launch.steps``): each entry updates its own
  slices; the global norm (``mesh_ctx.global_norm``) sums each block's
  squares once (a replicated leaf's copies are counted once, not once an
  entry) and all-reduces over every axis.
* **Prefill** returns the caches in ``launch.steps._lm_cache_sharding``'s
  layout (sequence on ``model``): the head-sliced K / V the attention made
  are redistributed with ``all_to_all``.
* **Decode** writes the new K / V in place at slot ``cache_len`` of the
  entry whose block holds it. A sequence-sharded cache is attended block
  by block, each entry over its own keys, and the partial (max, sum,
  output) results merge across entries in rank order — the combine the
  split decode kernel does across its key splits within a card.

Replicated parameter copies pass through ``collectives.copy_to``, so each
copy's gradient is the sum of all copies'; a loss is differentiated from
the first entry's copy (``collectives``' docstring).

Row-parallel partial products summed in rank order are not bit-equal to
one matmul: a sharded step agrees with the one-card step to a tolerance,
never bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.flash_attention.flash_attention import flash_attention
from repro_torch.launch.mesh import Mesh, _spec_axes
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.runtime import collectives as C
from repro_torch.runtime.mesh_ctx import MeshCtx
from repro_torch.runtime.sharding import lm_param_rules


class Ctx(MeshCtx):
    """A mesh and an LM config: the axes, each entry's coordinates, and
    how the heads split over ``model``; ``rules`` the param rules
    (``lm_param_rules`` unless given: ``runtime.lm_seqpar`` passes
    ``lm_param_rules_zero``)."""

    def __init__(self, mesh: Mesh, cfg: T.LMConfig, rules: list = None):
        super().__init__(mesh, lm_param_rules(mesh) if rules is None
                         else rules)
        self.cfg = cfg
        self.tp = mesh.shape["model"]
        self.m = self.at["model"]
        h, hkv = cfg.n_heads, cfg.n_kv_heads
        self.all_heads = h % self.tp != 0
        self.all_kv = self.all_heads or hkv % self.tp != 0


def local(ctx: Ctx, shards: list, spec, *, model: bool = False,
          every: bool = False) -> list:
    """A leaf's per-entry tensor for the matmuls: its copies passed through
    ``copy_to`` over the axes its spec does not name, then gathered over
    the data axes on the dim the spec splits over them (FSDP), with
    ``model`` over ``model`` too, and with ``every`` on every dim the spec
    splits, whatever its axes (ZeRO-3: the whole leaf). ``spec`` is the
    leaf's (a layer slice's without the leading layer entry)."""
    xs = list(shards)
    unnamed = ctx.unnamed(spec)
    if ctx.size(unnamed) > 1:
        xs = C.copy_to(xs, ctx.mesh, unnamed)
    for dim, entry in enumerate(spec):
        axes = _spec_axes(entry)
        if axes and ctx.size(axes) > 1 and (
                every or set(axes) <= set(ctx.da)
                or (model and axes == ("model",))):
            xs = C.all_gather(xs, ctx.mesh, axes, dim)
    return xs


def _model_sum(ctx: Ctx, xs: list) -> list:
    return C.all_reduce(xs, ctx.mesh, "model") if ctx.tp > 1 else list(xs)


def _data_sum(ctx: Ctx, xs: list) -> list:
    return C.all_reduce(xs, ctx.mesh, ctx.da) if ctx.n_dp > 1 else list(xs)


def _layer_leaf(ctx: Ctx, lps: list, path: str, *, model: bool = False,
                every: bool = False):
    a, b = path.split("/")
    spec = ctx.spec(f"layers/{path}")[1:]
    return local(ctx, [lp[a][b] for lp in lps], spec, model=model,
                 every=every)


def _norm(ctx: Ctx, lps: list, name: str, xs: list) -> list:
    gs = local(ctx, [lp[name]["g"] for lp in lps], ())
    return [L.rmsnorm({"g": g}, x, ctx.cfg.norm_eps) for g, x in zip(gs, xs)]


# --------------------------------------------------------------------------
# embedding, head
# --------------------------------------------------------------------------

def embed_table(ctx: Ctx, params: list) -> list:
    """Each entry's ``(V / tp, d)`` rows of the embedding."""
    return local(ctx, [p["embed"] for p in params], ctx.spec("embed"))


def lookup(ctx: Ctx, table: list, tokens: list) -> list:
    """Each entry's lookup of ``tokens`` in its vocabulary rows (other
    tokens give 0): summed over ``model``, the embedding."""
    xs = []
    for e, (t, tok) in enumerate(zip(table, tokens)):
        rows = t.shape[0]
        idx = tok.long() - ctx.m[e] * rows
        ok = (idx >= 0) & (idx < rows)
        x = t[torch.clamp(idx, 0, rows - 1)]
        xs.append(torch.where(ok[..., None], x, torch.zeros((), dtype=x.dtype,
                                                            device=x.device)))
    return xs


def embed(ctx: Ctx, table: list, tokens: list) -> list:
    return _model_sum(ctx, lookup(ctx, table, tokens))


def head(ctx: Ctx, params: list, table: list) -> list:
    """Each entry's ``(d, V / tp)`` columns of the head."""
    if ctx.cfg.tie_embeddings:
        return [t.T for t in table]
    return local(ctx, [p["lm_head"] for p in params], ctx.spec("lm_head"))


def logits(ctx: Ctx, heads: list, xs: list) -> list:
    return [T.final_logits(ctx.cfg, x, w) for x, w in zip(xs, heads)]


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------

def _qkv_weights(ctx: Ctx, lps: list, all_heads: bool):
    wq = _layer_leaf(ctx, lps, "attn/wq", model=all_heads)
    wk = _layer_leaf(ctx, lps, "attn/wk", model=all_heads or ctx.all_kv)
    wv = _layer_leaf(ctx, lps, "attn/wv", model=all_heads or ctx.all_kv)
    return wq, wk, wv


def _kv_for_heads(ctx: Ctx, e: int, k, v, all_heads: bool):
    """The K / V (B, S, n, hd) that entry ``e``'s query heads read: all of
    them where every head is computed, else the KV heads of its ``H / tp``
    query heads (a contiguous slice where its heads cover whole GQA groups
    or lie in one, else one KV head a query head)."""
    cfg = ctx.cfg
    if all_heads or not ctx.all_kv:
        return k, v
    nq = cfg.n_heads // ctx.tp
    g = cfg.n_heads // cfg.n_kv_heads
    h0 = ctx.m[e] * nq
    if nq % g == 0:
        sl = slice(h0 // g, (h0 + nq) // g)
        return k[:, :, sl], v[:, :, sl]
    if g % nq == 0:
        sl = slice(h0 // g, h0 // g + 1)
        return k[:, :, sl], v[:, :, sl]
    idx = torch.tensor([(h0 + j) // g for j in range(nq)], device=k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


def _own_columns(ctx: Ctx, e: int, o, all_heads: bool):
    """Entry ``e``'s ``H·hd / tp`` columns of the attention output (B, S,
    H_e, hd), flattened, for its row-parallel ``wo``."""
    b, s = o.shape[:2]
    o = o.reshape(b, s, -1)
    if not all_heads:
        return o
    w = o.shape[-1] // ctx.tp
    return o[..., ctx.m[e] * w:(ctx.m[e] + 1) * w]


def _attn_out(ctx: Ctx, lps: list, xs: list, cols: list) -> list:
    """The row-parallel ``wo`` over each entry's output columns, summed
    over ``model``, added to the residual stream."""
    wo = _layer_leaf(ctx, lps, "attn/wo")
    ys = _model_sum(ctx, [c @ w for c, w in zip(cols, wo)])
    return [x + y for x, y in zip(xs, ys)]


# --------------------------------------------------------------------------
# FFN
# --------------------------------------------------------------------------

def _moe_cfg(ctx: Ctx, sharded_batch: bool) -> M.MoEConfig:
    """The dispatch an entry runs: one group (its data rank's) where the
    batch is split over the data axes, else the global groups."""
    mcfg = ctx.cfg.moe
    if sharded_batch:
        return dataclasses.replace(mcfg, dispatch_groups=1)
    return mcfg


def _moe(ctx: Ctx, lps: list, hs: list, sharded_batch: bool, n_tokens: int,
         with_aux: bool):
    """The MoE FFN over each entry's ``E / tp`` experts, summed over
    ``model``: ``(ys, auxes)`` (auxes None without ``with_aux``)."""
    mcfg = ctx.cfg.moe
    e_all = mcfg.n_experts
    e_loc = e_all // ctx.tp
    router = _layer_leaf(ctx, lps, "moe/router")
    wi = _layer_leaf(ctx, lps, "moe/wi")
    wg = _layer_leaf(ctx, lps, "moe/wg")
    wo = _layer_leaf(ctx, lps, "moe/wo")
    local_cfg = _moe_cfg(ctx, sharded_batch)
    parts, dens, means = [], [], []
    for e, h in enumerate(hs):
        b, s, d = h.shape
        xf = h.reshape(b * s, d)
        probs, gate, expert = M.route({"router": router[e]}, xf, mcfg)
        if with_aux:
            dens.append(torch.sum(torch.nn.functional.one_hot(
                expert[:, 0], e_all).float(), dim=0))
            means.append(torch.sum(probs, dim=0))
        plan = M.dispatch_plan(expert, b * s, local_cfg)
        e0 = ctx.m[e] * e_loc
        loc = plan.idx_e - e0
        mine = plan.keep & (loc >= 0) & (loc < e_loc)
        idx_e = torch.where(mine, loc, e_loc)
        idx_c = torch.where(mine, plan.idx_c, 0)
        own = M.Plan(plan.groups, plan.cap, plan.pos, mine, idx_e, idx_c)
        buf = M.dispatch(xf, own, dataclasses.replace(local_cfg,
                                                      n_experts=e_loc))
        out = M.experts({"wi": wi[e], "wg": wg[e], "wo": wo[e]}, buf)
        parts.append(M.combine(out, own, gate, dataclasses.replace(
            local_cfg, n_experts=e_loc)))
    ys = _model_sum(ctx, parts)
    ys = [y.reshape(h.shape).to(h.dtype) for y, h in zip(ys, hs)]
    if not with_aux:
        return ys, None
    if sharded_batch:
        dens, means = _data_sum(ctx, dens), _data_sum(ctx, means)
    auxes = []
    for dn, mn in zip(dens, means):
        t = torch.full((), float(n_tokens), dtype=torch.float32,
                       device=dn.device)
        auxes.append(mcfg.aux_loss_coef * e_all
                     * torch.sum((dn / t) * (mn / t)))
    return ys, auxes


def _mlp(ctx: Ctx, lps: list, hs: list) -> list:
    act = T._act(ctx.cfg)
    w = {k: _layer_leaf(ctx, lps, f"mlp/{k}") for k in ("wi", "wg", "wo")}
    return _model_sum(ctx, [
        L.gated_mlp({k: v[e] for k, v in w.items()}, h, act)
        for e, h in enumerate(hs)])


def _ffn(ctx: Ctx, lps, xs, sharded_batch, n_tokens, with_aux):
    hs = _norm(ctx, lps, "ln2", xs)
    if ctx.cfg.moe is not None:
        ys, auxes = _moe(ctx, lps, hs, sharded_batch, n_tokens, with_aux)
    else:
        ys, auxes = _mlp(ctx, lps, hs), None
    return [x + y for x, y in zip(xs, ys)], auxes


# --------------------------------------------------------------------------
# a layer over whole sequences (train, prefill)
# --------------------------------------------------------------------------

def _layer(ctx: Ctx, lps, xs, window: int, sharded_batch: bool,
           n_tokens: int, with_aux: bool):
    """One block on every entry: ``(xs, auxes, kvs)``, kvs each entry's
    (k, v) (B_e, S, Hkv_e, hd) as its attention computed them."""
    cfg = ctx.cfg
    hs = _norm(ctx, lps, "ln1", xs)
    wq, wk, wv = _qkv_weights(ctx, lps, ctx.all_heads)
    cols, kvs = [], []
    for e, h in enumerate(hs):
        pos = torch.arange(h.shape[1], dtype=torch.int32, device=h.device)
        q, k, v = T.project_qkv(cfg, h, wq[e], wk[e], wv[e], pos)
        kk, vv = _kv_for_heads(ctx, e, k, v, ctx.all_heads)
        o = L.attention(q, kk, vv, q_offset=0, window=window,
                        softcap=cfg.attn_softcap)
        cols.append(_own_columns(ctx, e, o, ctx.all_heads))
        kvs.append((k, v))
    xs = _attn_out(ctx, lps, xs, cols)
    xs, auxes = _ffn(ctx, lps, xs, sharded_batch, n_tokens, with_aux)
    return xs, auxes, kvs


def _layer_train(ctx: Ctx, i: int, params, xs, sharded_batch, n_tokens):
    lps = [T.layer_params(p, i) for p in params]
    xs, auxes, _ = _layer(ctx, lps, xs, int(ctx.cfg.windows[i]),
                          sharded_batch, n_tokens, ctx.cfg.moe is not None)
    return xs, auxes


def backbone_train(ctx: Ctx, params: list, table: list, tokens: list,
                   sharded_batch: bool, n_tokens: int):
    """The trunk of a training step: each layer checkpointed as a whole
    (its gathers re-run in the backward, as the JAX package's remat), so a
    layer's gathered weights live only while the layer runs. Returns
    ``(xs post ln_f, auxes)``, auxes each entry's summed aux loss."""
    cfg = ctx.cfg
    xs = embed(ctx, table, tokens)
    aux_sum = [torch.zeros((), dtype=torch.float32, device=x.device)
               for x in xs]
    for i in range(cfg.n_layers):
        args = (ctx, i, params, xs, sharded_batch, n_tokens)
        xs, auxes = (checkpoint(_layer_train, *args, use_reentrant=False)
                     if torch.is_grad_enabled() else _layer_train(*args))
        if auxes is not None:
            aux_sum = [a + b for a, b in zip(aux_sum, auxes)]
    gs = local(ctx, [p["ln_f"]["g"] for p in params], ())
    xs = [L.rmsnorm({"g": g}, x, cfg.norm_eps) for g, x in zip(gs, xs)]
    return xs, aux_sum


# --------------------------------------------------------------------------
# the loss
# --------------------------------------------------------------------------

def _xent_block(ctx: Ctx, heads, xs, labels):
    """Each entry's summed token NLL of its rows (its data rank's tokens),
    vocabulary-parallel over ``model``."""
    lg = logits(ctx, heads, xs)
    top = C.all_reduce_max([torch.amax(z, dim=-1) for z in lg], ctx.mesh,
                           "model") if ctx.tp > 1 else \
        [torch.amax(z, dim=-1).detach() for z in lg]
    se = _model_sum(ctx, [torch.sum(torch.exp(z - t[:, None]), dim=-1)
                          for z, t in zip(lg, top)])
    picked = []
    for e, (z, lab) in enumerate(zip(lg, labels)):
        cols = z.shape[1]
        idx = lab.long() - ctx.m[e] * cols
        ok = (idx >= 0) & (idx < cols)
        val = torch.gather(z, 1, torch.clamp(idx, 0, cols - 1)[:, None])[:, 0]
        picked.append(torch.where(ok, val, torch.zeros((), device=z.device)))
    ll = _model_sum(ctx, picked)
    return [torch.sum(torch.log(s) + t - p) for s, t, p in zip(se, top, ll)]


def xent_sums(ctx: Ctx, heads: list, xs: list, labels: list) -> list:
    """``_xent_block`` over chunks of ``cfg.xent_chunk`` rows where the
    chunk divides the rows (each chunk recomputed in the backward, as
    ``layers.chunked_softmax_xent`` does), else as one block."""
    chunk = ctx.cfg.xent_chunk
    t = xs[0].shape[0]
    if t <= chunk or t % chunk:
        return _xent_block(ctx, heads, xs, labels)
    tot = None
    for c in range(0, t, chunk):
        args = (ctx, heads, [x[c:c + chunk] for x in xs],
                [lab[c:c + chunk] for lab in labels])
        part = (checkpoint(_xent_block, *args, use_reentrant=False)
                if torch.is_grad_enabled() else _xent_block(*args))
        tot = part if tot is None else [a + b for a, b in zip(tot, part)]
    return tot


def loss(ctx: Ctx, params: list, tokens: list, labels: list,
         sharded_batch: bool, n_tokens: int):
    """Each entry's copy of ``(loss, xent, aux)``: the mean token NLL over
    the global batch plus the layers' summed aux loss."""
    table = embed_table(ctx, params)
    xs, auxes = backbone_train(ctx, params, table, tokens, sharded_batch,
                               n_tokens)
    heads = head(ctx, params, table)
    d = ctx.cfg.d_model
    sums = xent_sums(ctx, heads, [x.reshape(-1, d) for x in xs],
                     [lab.reshape(-1) for lab in labels])
    if sharded_batch:
        sums = _data_sum(ctx, sums)
    out = []
    for s, a in zip(sums, auxes):
        n = torch.full((), float(n_tokens), dtype=torch.float32,
                       device=s.device)
        xent = s / n
        out.append((xent + a, xent, a))
    return out


# --------------------------------------------------------------------------
# prefill, decode
# --------------------------------------------------------------------------

def _cache_blocks(ctx: Ctx, kvs: list, cache_spec, seq: int) -> list:
    """Each entry's (k, v) in the cache layout ``cache_spec`` (sequence
    split over its third entry's axes), from the (k, v) the attention made
    (all KV heads, or the entry's ``Hkv / tp``)."""
    seq_axes = _spec_axes(cache_spec[2])
    if ctx.all_kv:
        return [(k[:, sl], v[:, sl]) for e, (k, v) in enumerate(kvs)
                for sl in [ctx.entry_slice(seq_axes, seq, e)]]
    out = []
    for which in (0, 1):
        xs = [kv[which] for kv in kvs]
        if seq_axes != ("model",):      # sequence over every axis
            xs = [x[:, ctx.entry_slice(ctx.da, seq, e)]
                  for e, x in enumerate(xs)]
        out.append(C.all_to_all(xs, ctx.mesh, "model", 1, 2)
                   if ctx.tp > 1 else xs)
    return list(zip(*out))


def prefill(ctx: Ctx, params: list, tokens: list, cache_spec,
            sharded_batch: bool) -> tuple:
    """Last-position logits (B_e, V / tp) and the caches, each entry's
    (L, B_e, S_e, Hkv, hd) block of ``cache_spec``; ``sharded_batch``:
    the tokens are split over the data axes."""
    cfg = ctx.cfg
    table = embed_table(ctx, params)
    xs = embed(ctx, table, tokens)
    seq = xs[0].shape[1]
    ck = cv = None
    for i in range(cfg.n_layers):
        lps = [T.layer_params(p, i) for p in params]
        xs, _, kvs = _layer(ctx, lps, xs, int(cfg.windows[i]),
                            sharded_batch, 0, False)
        blocks = _cache_blocks(ctx, kvs, cache_spec, seq)
        del kvs
        if ck is None:
            ck = [torch.empty((cfg.n_layers, *k.shape), dtype=k.dtype,
                              device=k.device) for k, _ in blocks]
            cv = [torch.empty_like(c) for c in ck]
        for e, (k, v) in enumerate(blocks):
            ck[e][i] = k
            cv[e][i] = v
    gs = local(ctx, [p["ln_f"]["g"] for p in params], ())
    last = [L.rmsnorm({"g": g}, x[:, -1], cfg.norm_eps)
            for g, x in zip(gs, xs)]
    return logits(ctx, head(ctx, params, table), last), ck, cv


def _merge(ctx: Ctx, parts: list, axes) -> list:
    """Attention over disjoint key blocks merged across ``axes`` in rank
    order: each block's output (B, H, 1, hd) weighed by ``exp(lse - max
    lse)``; a block no row sees weighs 0."""
    top = C.all_reduce_max([lse for _, lse in parts], ctx.mesh, axes)
    ws = [torch.exp(lse - t) for (_, lse), t in zip(parts, top)]
    num = C.all_reduce([o.float() * w[..., None]
                        for (o, _), w in zip(parts, ws)], ctx.mesh, axes)
    den = C.all_reduce(ws, ctx.mesh, axes)
    return [n / dd[..., None] for n, dd in zip(num, den)]


def _block_attention(cfg, q, ck, cv, blk: slice, cache_len: int,
                     window: int):
    """Attention of the new token's q (B, 1, H, hd) over one entry's key
    block ``blk`` of the cache (ck, cv its (B, S_blk, Hkv, hd)): the
    output (B, H, 1, hd) and its log-sum-exp (B, H, 1) from
    ``flash_attention``; a block no key of which is visible gives 0 and
    -inf without a launch."""
    lo = max(0, cache_len - window + 1) if window > 0 else 0
    qh = q.transpose(1, 2)
    if max(lo, blk.start) >= min(cache_len + 1, blk.stop):
        return (torch.zeros(qh.shape, dtype=q.dtype, device=q.device),
                torch.full(qh.shape[:3], float("-inf"), device=q.device))
    return flash_attention(qh, ck.transpose(1, 2), cv.transpose(1, 2),
                           causal=True, window=window,
                           softcap=cfg.attn_softcap,
                           q_offset=cache_len - blk.start, lse=True)


def decode(ctx: Ctx, params: list, tokens: list, cache_k: list,
           cache_v: list, cache_len: int, cache_spec) -> list:
    """One new token a sequence: writes its K / V at slot ``cache_len`` in
    place and returns each entry's logits (B_e, V / tp). A cache split
    over heads (``cache_spec[3]`` is ``model``) is attended head-sliced; a
    cache split over the sequence is attended block by block with every
    head, the blocks merged across the sequence's axes."""
    cfg = ctx.cfg
    heads_split = cache_spec[3] == "model"
    seq_axes = _spec_axes(cache_spec[2])
    seq = cache_k[0].shape[2] * int(np.prod([ctx.mesh.shape[a]
                                             for a in seq_axes]))
    blocks = [ctx.entry_slice(seq_axes, seq, e) for e in range(ctx.n)]
    table = embed_table(ctx, params)
    xs = embed(ctx, table, tokens)
    sharded_batch = cache_spec[1] is not None and ctx.n_dp > 1
    for i in range(cfg.n_layers):
        lps = [T.layer_params(p, i) for p in params]
        hs = _norm(ctx, lps, "ln1", xs)
        ws = _qkv_weights(ctx, lps, not heads_split)
        window = int(cfg.windows[i])
        parts = []
        for e, h in enumerate(hs):
            pos = torch.full((h.shape[0], 1), cache_len, dtype=torch.int32,
                             device=h.device)
            q, k1, v1 = T.project_qkv(cfg, h, ws[0][e], ws[1][e], ws[2][e],
                                     pos)
            ck, cv = cache_k[e][i], cache_v[e][i]
            blk = slice(0, seq) if heads_split else blocks[e]
            if blk.start <= cache_len < blk.stop:
                ck[:, cache_len - blk.start] = k1[:, 0].to(ck.dtype)
                cv[:, cache_len - blk.start] = v1[:, 0].to(cv.dtype)
            if heads_split:
                parts.append(L.attention(q, ck, cv, q_offset=cache_len,
                                         window=window,
                                         softcap=cfg.attn_softcap))
            else:
                parts.append(_block_attention(cfg, q, ck, cv, blk, cache_len,
                                              window))
        if not heads_split:
            parts = [o.to(h.dtype).transpose(1, 2)
                     for o, h in zip(_merge(ctx, parts, seq_axes), hs)]
        cols = [_own_columns(ctx, e, o, not heads_split)
                for e, o in enumerate(parts)]
        xs = _attn_out(ctx, lps, xs, cols)
        xs, _ = _ffn(ctx, lps, xs, sharded_batch, 0, False)
    gs = local(ctx, [p["ln_f"]["g"] for p in params], ())
    last = [L.rmsnorm({"g": g}, x[:, 0], cfg.norm_eps)
            for g, x in zip(gs, xs)]
    return logits(ctx, head(ctx, params, table), last)
