"""The LM ``opt`` scheme's train step on a (data [x pod], model) mesh: what
XLA's SPMD partitioner makes of the JAX package's sequence-parallel step
(``repro.launch.steps.build_lm`` under ``scheme="opt"``: ZeRO-3 weights by
``runtime.sharding.lm_param_rules_zero``, the residual stream at ``(da,
"model", None)``, K / V gathered once a layer, ``dispatch_groups = n_dp ·
tp``, two microbatches), written out on the port's mesh with every
collective an explicit call of ``runtime.collectives``. The baseline
scheme's program is ``runtime.lm_sharded``, whose pieces this one reuses
(the embedding table and head, the norms, the vocabulary-parallel loss).

Every sharded value is a list of per-entry tensors in the mesh's
row-major order. Entry ``e`` has data rank ``r`` and model rank ``m``:

* **Microbatches.** The tokens and labels come split ``(da, "model")``.
  They are all-gathered (int32, a few bytes a token) and microbatch ``i``
  is JAX's rows ``[i·B/2, (i+1)·B/2)``, of which entry ``e`` takes the
  ``R = B / (2·n_dp)`` rows ``i·B/2 + r·R ...`` at full length: every entry
  works on every microbatch, with JAX's row sets.
* **Residual shard.** ``(R, S/tp, d)``: the entry's ``S / tp`` positions
  ``m·S/tp + j`` of its rows. The embedding looks the rows' tokens up in
  the entry's vocabulary rows (others give 0), and a reduce-scatter over
  ``model`` sums the lookups and leaves each entry its positions.
* **ZeRO-3 weights.** ``attn/w[qkvo]`` and ``mlp/w[ig,o]`` are sharded on
  one dim over the whole mesh and all-gathered one layer at a time; the
  adjoint reduce-scatters their gradients. Each layer is checkpointed, so
  the backward's recompute gathers them again.
* **Attention.** Every entry computes its positions' q, k, v with the
  full weights (every head), RoPE at the global positions; k and v are
  all-gathered over ``model`` along the sequence, and the local queries
  run against every key through ``flash_attention`` (``layers.attention``)
  with ``q_offset = m·S/tp``. JAX's online softmax over 512-key chunks
  (``attention_kv_chunked``) is the same function.
* **MoE.** JAX's ``n_dp·tp`` dispatch groups are contiguous spans of the
  microbatch's b-major tokens; a data rank's span is ``tp`` groups of
  ``R·S/tp`` tokens, which the entries' blocks do not line up with once
  ``R > 1``. ``regroup`` moves each group's tokens to one entry
  (``collectives.permute_chunks``: for ``tp | R`` an all-to-all that turns
  the sequence split into a row split, for ``R = 1`` nothing, for ``R |
  tp`` one row segment to each of ``R`` entries), where routing, capacity
  and positions are JAX's per group. The dispatch buffer then goes
  expert-parallel: an all-to-all over ``model`` sends each entry the ``E /
  tp`` experts it holds of its data rank's ``tp`` groups (``buf_pspec``'s
  ``(da, "model")``), the experts run on weights all-gathered over the data
  axes (``P(None, "model", None, da)`` / ``P(None, "model", da, None)``),
  and the reverse all-to-all and ``ungroup`` bring the outputs home. The
  aux loss is the product of the two global means: the sums over every
  entry first.
* **Loss.** The final activations are all-gathered over ``model`` (``R·S·d``
  elements an entry; gathering the ``(d, V)`` head instead would move
  ``V / (R·S)`` times more at moonshot's or gemma2's width) and the
  cross-entropy runs vocabulary-parallel over the entry's ``V / tp``
  columns as the baseline's does (``lm_sharded.xent_sums``); the data
  ranks' sums are summed and divided by the microbatch's token count.

``launch.steps`` sums the two microbatches' gradients in f32, divides
them by 2 and runs AdamW on each entry's ZeRO slices. A layout the
program cannot split evenly — ``S % tp != 0``, or a microbatch whose rows
do not split over the data ranks — raises (ROADMAP A item 3.5).
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.launch.mesh import Mesh
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.runtime import collectives as C
from repro_torch.runtime import lm_sharded as LS
from repro_torch.runtime.sharding import lm_param_rules_zero

MICRO = 2


def make_ctx(mesh: Mesh, cfg: T.LMConfig) -> LS.Ctx:
    """The mesh under the ZeRO-3 rules."""
    return LS.Ctx(mesh, cfg, lm_param_rules_zero(mesh))


def layout_error(ctx: LS.Ctx, batch: int, seq: int) -> str | None:
    """Why the program cannot run a (batch, seq) step on ``ctx``'s mesh,
    or None."""
    if seq % ctx.tp:
        return (f"the sequence ({seq}) does not split over model "
                f"({ctx.tp})")
    if batch % (MICRO * ctx.n_dp):
        return (f"a microbatch's {batch // MICRO} rows do not split over "
                f"the {ctx.n_dp} data ranks")
    return None


def _full(ctx: LS.Ctx, lps: list, path: str) -> list:
    """A layer's ZeRO-3 leaf whole on every entry."""
    return LS._layer_leaf(ctx, lps, path, every=True)


def micro_batches(ctx: LS.Ctx, tokens: list, labels: list,
                  batch: int) -> list:
    """``[{"tokens", "labels"}]`` a microbatch, each a list of the
    entries' ``(R, S)`` rows (see the module's docstring) from the
    ``(da, "model")`` shards."""
    def whole(xs):
        if ctx.n_dp > 1:
            xs = C.all_gather(xs, ctx.mesh, ctx.da, 0)
        if ctx.tp > 1:
            xs = C.all_gather(xs, ctx.mesh, "model", 1)
        return xs

    toks, labs = whole(tokens), whole(labels)
    rows = batch // (MICRO * ctx.n_dp)
    out = []
    for i in range(MICRO):
        starts = [i * (batch // MICRO) + ctx.rank(ctx.da, e) * rows
                  for e in range(ctx.n)]
        out.append({"tokens": [t[s:s + rows] for t, s in zip(toks, starts)],
                    "labels": [t[s:s + rows] for t, s in zip(labs, starts)]})
    return out


# --------------------------------------------------------------------------
# embedding, attention, FFN
# --------------------------------------------------------------------------

def embed(ctx: LS.Ctx, table: list, tokens: list) -> list:
    """Each entry's ``(R, S/tp, d)`` residual shard of its rows' tokens
    ``(R, S)``: the lookups in the entries' vocabulary rows, summed and
    scattered over ``model``."""
    xs = LS.lookup(ctx, table, tokens)
    return C.reduce_scatter(xs, ctx.mesh, "model", 1) if ctx.tp > 1 else xs


def _attention(ctx: LS.Ctx, lps: list, xs: list, window: int) -> list:
    cfg = ctx.cfg
    hs = LS._norm(ctx, lps, "ln1", xs)
    wq, wk, wv = (_full(ctx, lps, f"attn/{w}") for w in ("wq", "wk", "wv"))
    offs = [m * xs[0].shape[1] for m in ctx.m]    # first global positions
    qs, ks, vs = [], [], []
    for e, h in enumerate(hs):
        pos = torch.arange(offs[e], offs[e] + h.shape[1], dtype=torch.int32,
                           device=h.device)
        q, k, v = T.project_qkv(cfg, h, wq[e], wk[e], wv[e], pos)
        qs.append(q)
        ks.append(k)
        vs.append(v)
    del wq, wk, wv
    if ctx.tp > 1:
        ks = C.all_gather(ks, ctx.mesh, "model", 1)
        vs = C.all_gather(vs, ctx.mesh, "model", 1)
    wo = _full(ctx, lps, "attn/wo")
    out = []
    for e, (x, q, k, v) in enumerate(zip(xs, qs, ks, vs)):
        o = L.attention(q, k, v, q_offset=offs[e], window=window,
                        softcap=cfg.attn_softcap)
        out.append(x + o.reshape(*x.shape[:2], -1) @ wo[e])
    return out


def _routes(ctx: LS.Ctx, rows: int, back: bool = False) -> list:
    """``permute_chunks`` routing of a data rank's ``rows`` x ``tp`` row
    segments (segment ``s = row·tp + m``: model rank ``m``'s row ``row``)
    to JAX's groups: model rank ``j`` takes segments ``j·rows ...
    (j+1)·rows - 1`` in order, segment ``s`` its chunk ``s % rows``.
    ``back``: the inverse, each segment home."""
    tp = ctx.tp
    if back:
        return [[((r * tp + m) // rows, (r * tp + m) % rows)
                 for r in range(rows)] for m in range(tp)]
    return [[(s % tp, s // tp) for s in range(j * rows, (j + 1) * rows)]
            for j in range(tp)]


def _identity(routes: list) -> bool:
    return all(src == j for j, route in enumerate(routes) for src, _ in route)


def regroup(ctx: LS.Ctx, hs: list) -> list:
    """Each entry's ``(R, S/tp, d)`` shard → the ``(R·S/tp, d)`` tokens of
    JAX's dispatch group ``r·tp + m``, in b-major order."""
    rows, d = hs[0].shape[0], hs[0].shape[-1]
    routes = _routes(ctx, rows)
    if not _identity(routes):
        hs = C.permute_chunks(hs, ctx.mesh, "model", 0, 1, routes)
    return [h.reshape(-1, d) for h in hs]


def ungroup(ctx: LS.Ctx, ys: list, shape) -> list:
    """``regroup``'s inverse: each group's ``(R·S/tp, d)`` rows back to its
    entries' ``shape`` = ``(R, S/tp, d)`` shards."""
    rows, _, d = shape
    routes = _routes(ctx, rows, back=True)
    if _identity(routes):
        return [y.reshape(shape) for y in ys]
    return C.permute_chunks([y.reshape(1, -1, d) for y in ys], ctx.mesh,
                            "model", 1, 0, routes)


def _moe(ctx: LS.Ctx, lps: list, hs: list, n_tokens: int):
    """The MoE FFN of each entry's shard: ``(ys, auxes)``."""
    mcfg = ctx.cfg.moe
    e_all = mcfg.n_experts
    router = LS._layer_leaf(ctx, lps, "moe/router")
    w = {k: LS._layer_leaf(ctx, lps, f"moe/{k}") for k in ("wi", "wg", "wo")}
    one = dataclasses.replace(mcfg, dispatch_groups=1)
    xg = regroup(ctx, hs)
    bufs, plans, gates, dens, means = [], [], [], [], []
    for e, x in enumerate(xg):
        probs, gate, expert = M.route({"router": router[e]}, x, mcfg)
        dens.append(torch.sum(torch.nn.functional.one_hot(
            expert[:, 0], e_all).float(), dim=0))
        means.append(torch.sum(probs, dim=0))
        plan = M.dispatch_plan(expert, x.shape[0], one)
        bufs.append(M.dispatch(x, plan, one))             # (1, E, C, d)
        plans.append(plan)
        gates.append(gate)
    if ctx.tp > 1:          # (tp groups, E / tp experts, C, d)
        bufs = C.all_to_all(bufs, ctx.mesh, "model", 1, 0)
    outs = [M.experts({k: v[e] for k, v in w.items()}, b)
            for e, b in enumerate(bufs)]
    del bufs
    if ctx.tp > 1:
        outs = C.all_to_all(outs, ctx.mesh, "model", 0, 1)
    ys = [M.combine(o, p, g, one).to(h.dtype)
          for o, p, g, h in zip(outs, plans, gates, hs)]
    ys = ungroup(ctx, ys, tuple(hs[0].shape))
    dens = C.all_reduce(dens, ctx.mesh, ctx.axes)
    means = C.all_reduce(means, ctx.mesh, ctx.axes)
    auxes = []
    for dn, mn in zip(dens, means):
        t = torch.full((), float(n_tokens), dtype=torch.float32,
                       device=dn.device)
        auxes.append(mcfg.aux_loss_coef * e_all
                     * torch.sum((dn / t) * (mn / t)))
    return ys, auxes


def _mlp(ctx: LS.Ctx, lps: list, hs: list) -> list:
    act = T._act(ctx.cfg)
    w = {k: _full(ctx, lps, f"mlp/{k}") for k in ("wi", "wg", "wo")}
    return [L.gated_mlp({k: v[e] for k, v in w.items()}, h, act)
            for e, h in enumerate(hs)]


def _layer(ctx: LS.Ctx, i: int, params: list, xs: list, n_tokens: int):
    cfg = ctx.cfg
    lps = [T.layer_params(p, i) for p in params]
    xs = _attention(ctx, lps, xs, int(cfg.windows[i]))
    hs = LS._norm(ctx, lps, "ln2", xs)
    if cfg.moe is not None:
        ys, auxes = _moe(ctx, lps, hs, n_tokens)
    else:
        ys, auxes = _mlp(ctx, lps, hs), None
    return [x + y for x, y in zip(xs, ys)], auxes


# --------------------------------------------------------------------------
# the loss of one microbatch
# --------------------------------------------------------------------------

def loss(ctx: LS.Ctx, params: list, tokens: list, labels: list,
         n_tokens: int) -> list:
    """Each entry's copy of ``(loss, xent, aux)`` of one microbatch of
    ``n_tokens`` tokens (``micro_batches``' rows): the mean token NLL plus
    the layers' summed aux loss, each layer checkpointed."""
    cfg = ctx.cfg
    table = LS.embed_table(ctx, params)
    xs = embed(ctx, table, tokens)
    aux = [torch.zeros((), dtype=torch.float32, device=x.device) for x in xs]
    for i in range(cfg.n_layers):
        args = (ctx, i, params, xs, n_tokens)
        xs, auxes = (checkpoint(_layer, *args, use_reentrant=False)
                     if torch.is_grad_enabled() else _layer(*args))
        if auxes is not None:
            aux = [a + b for a, b in zip(aux, auxes)]
    gs = LS.local(ctx, [p["ln_f"]["g"] for p in params], ())
    xs = [L.rmsnorm({"g": g}, x, cfg.norm_eps) for g, x in zip(gs, xs)]
    if ctx.tp > 1:
        xs = C.all_gather(xs, ctx.mesh, "model", 1)
    d = cfg.d_model
    sums = LS.xent_sums(ctx, LS.head(ctx, params, table),
                        [x.reshape(-1, d) for x in xs],
                        [lab.reshape(-1) for lab in labels])
    sums = LS._data_sum(ctx, sums)
    out = []
    for s, a in zip(sums, aux):
        n = torch.full((), float(n_tokens), dtype=torch.float32,
                       device=s.device)
        xent = s / n
        out.append((xent + a, xent, a))
    return out
