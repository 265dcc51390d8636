"""Step builders of the port (the counterpart of ``repro.launch.steps``):
one step per (arch x shape) with its shardings, the layer the trainer, the
server and the dry-run share.

``build_step`` gives every cell's ``StepBundle`` — ``build_lm``,
``build_gnn`` / ``build_gnn_halo`` and ``build_recsys`` — as the JAX
package's (``steps.py:41-613``):

  * ``fn``            — the step (train / prefill / decode) on a mesh: it
                        takes its arguments placed as ``in_shardings``
                        (``launch.mesh.place_tree``'s ``SpecBlocks``) and
                        returns them placed as ``out_shardings``; a
                        donated argument is updated in place, and one that
                        is not placed as ``in_shardings`` raises;
  * ``specs``         — tensors on the ``meta`` device for every argument
                        (``ShapeDtypeStruct``'s counterpart: shape and
                        dtype, no allocation);
  * ``in_shardings`` / ``out_shardings`` — ``launch.mesh.Placement(mesh,
                        spec=...)`` trees matching specs;
  * ``donate``        — argument indices donated (params / opt / caches);
  * ``meta``          — model FLOPs and the family's counts.

The step runs each mesh entry on its own shards with explicit collectives
(``runtime.collectives``): for an LM ``runtime.lm_sharded`` (FSDP on data
(x pod), TP on model, EP for MoE experts) or, for the ``opt`` scheme's
train step, ``runtime.lm_seqpar`` (ZeRO-3 weights, sequence parallelism,
two microbatches); for a GNN ``runtime.gnn_mesh`` (graph parallelism over
the flattened mesh) or, under the ``halo`` scheme,
``runtime.gnn_halo_train`` (one SDP block a mesh entry); for the
two-tower model ``runtime.recsys_sharded`` (tables row-sharded over
``model``, or every axis under ``opt``). ``build_step`` builds every cell
of every family.

Beside the bundles: ``train_step`` (the one-card eager step), ``make_opt``
and the FLOP counts of the LM and GNN cells.

Without ``jit`` a step is eager autograd: ``value_and_grad`` runs the loss
on views of the param leaves that require a gradient and takes
``torch.autograd.grad`` over them.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Callable

import torch

from repro_torch.configs import get_arch
from repro_torch.configs.base import ArchDef
from repro_torch.configs.shapes import LMShape
from repro_torch.launch.mesh import (
    Mesh, PartitionSpec as P, Placement, SpecBlocks, _block_slices,
)
from repro_torch.configs.shapes import GNNShape, RecSysShape
from repro_torch.graph.sampler import subgraph_sizes
from repro_torch.models import recsys as RS
from repro_torch.models import transformer as T
from repro_torch.models.gnn import meshgraphnet as MGN
from repro_torch.models.gnn import nequip as NQ
from repro_torch.models.gnn import pna as PNA
from repro_torch.models.gnn import schnet as SCH
from repro_torch.models.gnn import so3
from repro_torch.optim.optimizers import (
    adamw, apply_updates, tree_leaves, tree_map, tree_paths,
)
from repro_torch.runtime import gnn_halo_train as GH
from repro_torch.runtime import gnn_mesh as GM
from repro_torch.runtime import lm_seqpar as SP
from repro_torch.runtime import lm_sharded as LS
from repro_torch.runtime import mesh_ctx as MC
from repro_torch.runtime import recsys_sharded as RSS
from repro_torch.runtime import sharding as SHR


def round_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def make_opt():
    return adamw(1e-4, weight_decay=0.1, clip_norm=1.0)


def value_and_grad(loss_fn, params: dict, batch: dict, cfg):
    """``(loss, metrics, grads)`` of ``loss_fn(params, batch, cfg)`` →
    ``(loss, metrics)``: the values detached, ``grads`` a tree like
    ``params``."""
    paths = [p for p, _ in tree_paths(params)]
    leaves = [x.detach().requires_grad_(True) for x in tree_leaves(params)]
    tree: dict = {}
    for path, leaf in zip(paths, leaves):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    with torch.enable_grad():
        loss, metrics = loss_fn(tree, batch, cfg)
        grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda _: next(it), tree))


def train_step(loss_fn, cfg, opt, micro: int = 1):
    """``step(params, opt_state, batch)`` → ``(params, opt_state,
    metrics)``: one optimizer step of ``opt`` on the loss's gradient,
    accumulated in f32 over ``micro`` equal microbatches (the leading
    axis of every batch leaf split ``micro`` ways) and divided by
    ``micro`` when ``micro > 1``, as the JAX package's scan does."""
    def step(params, opt_state, batch):
        if micro > 1:
            dev = tree_leaves(params)[0].device
            mbs = {k: v.reshape(micro, v.shape[0] // micro, *v.shape[1:])
                   for k, v in batch.items()}
            gsum = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            lsum = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(micro):
                loss, _, g = value_and_grad(
                    loss_fn, params, {k: v[i] for k, v in mbs.items()}, cfg)
                tree_map(lambda a, b: a.add_(b.float()), gsum, g)
                lsum = lsum + loss
                del g
            # divide by a tensor: a Python divisor may become a reciprocal
            # multiply on the card
            n = torch.tensor(float(micro), dtype=torch.float32, device=dev)
            grads = tree_map(lambda g: g.div_(n), gsum)
            loss = lsum / n
            metrics = {}
        else:
            loss, metrics, grads = value_and_grad(loss_fn, params, batch, cfg)
        updates, opt_state = opt.update(grads, opt_state, params)
        del grads
        params = apply_updates(params, updates)
        metrics = dict(metrics, loss=loss, gnorm=opt_state["gnorm"])
        return params, opt_state, metrics

    return step


def _train_step_fn(loss_fn, cfg, micro: int = 1):
    """The JAX package's train step with ``make_opt()``: returns ``(step,
    opt)``."""
    opt = make_opt()
    return train_step(loss_fn, cfg, opt, micro), opt


def _lm_flops_fwd(cfg, tokens: int, kv_len: int | None = None) -> float:
    """2·N_active·tokens + attention score/AV flops."""
    n = cfg.active_param_count()
    kv = kv_len if kv_len is not None else 0
    attn = 0.0
    for w in cfg.windows:
        span = kv if kv else 0
        if w > 0 and span:
            span = min(span, int(w))
        # train/prefill: causal ≈ S/2 per query; decode: full span
        attn += 4.0 * cfg.n_heads * cfg.head_dim * tokens * (span or 0)
    return 2.0 * n * tokens + attn


# ---------------------------------------------------------------------------
# bundles
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StepBundle:
    name: str
    kind: str                      # 'train' | 'prefill' | 'decode'
    fn: Callable
    specs: tuple
    in_shardings: tuple
    out_shardings: Any
    donate: tuple
    meta: dict


def _rep(mesh: Mesh) -> Placement:
    return Placement(mesh, spec=P())


def _sh(mesh: Mesh, *spec) -> Placement:
    return Placement(mesh, spec=P(*spec))


def _n_dp(mesh: Mesh) -> int:
    n = 1
    for a in SHR.batch_axes(mesh):
        n *= mesh.shape[a]
    return n


def _opt_shardings(param_sh, mesh: Mesh) -> dict:
    return {"mu": param_sh, "nu": param_sh,
            "count": _rep(mesh), "gnorm": _rep(mesh)}


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _nest(flat: dict) -> dict:
    """{"a/b": x} → {"a": {"b": x}}."""
    out: dict = {}
    for path, x in flat.items():
        node = out
        keys = path.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = x
    return out


def _unflatten(paths: list, leaves: list) -> dict:
    return _nest(dict(zip(paths, leaves)))


def _check_placed(arg, placement, spec, what: str) -> None:
    """Raise unless ``arg`` is placed as ``placement`` says: a
    ``SpecBlocks`` on the placement's mesh with its spec, the shape and
    dtype of ``spec``, each entry's block on that entry's device."""
    if isinstance(placement, dict):
        if not isinstance(arg, dict) or sorted(arg) != sorted(placement):
            raise ValueError(f"{what}: expected a dict with keys "
                             f"{sorted(placement)}, got "
                             f"{sorted(arg) if isinstance(arg, dict) else type(arg)}")
        for k in placement:
            _check_placed(arg[k], placement[k], spec[k], f"{what}/{k}")
        return
    want = P(*placement.spec)
    if not isinstance(arg, SpecBlocks):
        raise ValueError(f"{what} must be placed as {want!r} on the step's "
                         f"mesh (launch.mesh.place_tree), got "
                         f"{type(arg).__name__}")
    if arg.mesh != placement.mesh or tuple(arg.spec) != tuple(want):
        raise ValueError(f"{what} is placed as {arg.spec!r} on "
                         f"{arg.mesh.shape}, the step takes {want!r} on "
                         f"{placement.mesh.shape}")
    if tuple(arg.shape) != tuple(spec.shape) or arg.dtype != spec.dtype:
        raise ValueError(f"{what} is {tuple(arg.shape)} {arg.dtype}, the "
                         f"step takes {tuple(spec.shape)} {spec.dtype}")
    mesh = placement.mesh
    for i, (sh, sl, dev) in enumerate(zip(
            arg.shards, _block_slices(mesh, want, spec.shape), mesh.devices)):
        block = tuple(x.stop - x.start for x in sl)
        if sh.device != torch.device(dev) or tuple(sh.shape) != block \
                or sh.dtype != spec.dtype:
            raise ValueError(f"{what}: entry {i}'s block is "
                             f"{tuple(sh.shape)} {sh.dtype} on {sh.device}, "
                             f"expected {block} {spec.dtype} on {dev}")


def _check_args(args: tuple, bundle_in: tuple, specs: tuple,
                name: str) -> None:
    if len(args) != len(bundle_in):
        raise ValueError(f"{name} takes {len(bundle_in)} arguments, got "
                         f"{len(args)}")
    for i, (a, pl, sp) in enumerate(zip(args, bundle_in, specs)):
        _check_placed(a, pl, sp, f"{name} argument {i}")


def _placed(placement: Placement, shape, shards) -> SpecBlocks:
    return SpecBlocks(placement.mesh, placement.spec, shape, shards)


def _entry_trees(tree: dict, n: int) -> list:
    """Each entry's tree of its shards of a tree of ``SpecBlocks``."""
    paths = ["/".join(p) for p, _ in tree_paths(tree)]
    blocks = tree_leaves(tree)
    return [_unflatten(paths, [b.shards[e] for b in blocks])
            for e in range(n)]


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------

def _lm_cfg_for_mesh(arch: ArchDef, mesh: Mesh) -> T.LMConfig:
    cfg = arch.config
    if cfg.moe is not None and cfg.moe.dispatch_groups == 1:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, dispatch_groups=_n_dp(mesh)))
    return cfg


def _lm_param_specs(cfg: T.LMConfig) -> dict:
    return _nest({k: _meta(shape, dt)
                  for k, (shape, dt) in T.param_specs(cfg).items()})


def _lm_shardings(params_like, mesh: Mesh, rules: list = None) -> dict:
    """Placements by ``rules`` (``lm_param_rules`` unless given)."""
    return SHR.shardings_from_rules(
        params_like, SHR.lm_param_rules(mesh) if rules is None else rules,
        mesh)


def _lm_cache_sharding(mesh: Mesh, batch: int,
                       n_kv_heads: int = 0) -> Placement:
    da = SHR.batch_axes(mesh)
    if batch % _n_dp(mesh) == 0 and batch >= _n_dp(mesh):
        if n_kv_heads and n_kv_heads % mesh.shape["model"] == 0:
            # KV heads divide the TP axis: heads on model, not the sequence
            return _sh(mesh, None, da, None, "model", None)
        return _sh(mesh, None, da, "model", None, None)
    # tiny batch (long context): the sequence over every axis
    return _sh(mesh, None, None, da + ("model",), None, None)


def _lm_meta(cfg: T.LMConfig, flops: float, tokens: int) -> dict:
    return {"family": "lm", "model_flops": flops,
            "params": cfg.param_count(),
            "active_params": cfg.active_param_count(), "tokens": tokens}


def _sharded_train_fn(ctx: MC.MeshCtx, bundle_in: tuple, specs: tuple,
                      name: str, loss, micro_batches=None):
    """The sharded train step: ``loss(trees, batch)`` — one param tree and
    one batch shard a leaf for each entry → ``(losses, metrics)``, each a
    list over the entries — its gradients from the first entry's loss,
    the global norm, and AdamW on each entry's slices in place. With
    ``micro_batches`` (the batch's shards → a list of such batches, one a
    microbatch) the gradients are summed in f32 over the microbatches and
    divided by their count (a tensor), the loss is their mean and no other
    metric is returned, as the JAX package's ``micro > 1`` step does."""
    opt = make_opt()
    rep = _rep(ctx.mesh)

    def grads_of(blocks: list, paths: list, batch: dict):
        leaves = [[b.shards[e].detach().requires_grad_(True) for b in blocks]
                  for e in range(ctx.n)]
        trees = [_unflatten(paths, lv) for lv in leaves]
        with torch.enable_grad():
            losses, metrics = loss(trees, batch)
            flat = [x for lv in leaves for x in lv]
            grads = torch.autograd.grad(losses[0], flat, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(flat, grads)]
        k = len(paths)
        return ([x.detach() for x in losses],
                {k_: [x.detach() for x in v] for k_, v in metrics.items()},
                [grads[e * k:(e + 1) * k] for e in range(ctx.n)])

    def step(params, opt_state, batch):
        _check_args((params, opt_state, batch), bundle_in, specs, name)
        paths = ["/".join(p) for p, _ in tree_paths(params)]
        blocks = tree_leaves(params)
        shards = {k_: list(v.shards) for k_, v in batch.items()}
        if micro_batches is None:
            losses, metrics, by_entry = grads_of(blocks, paths, shards)
        else:
            by_entry = lsum = None
            mbs = micro_batches(shards)
            for mb in mbs:
                losses, _, grads = grads_of(blocks, paths, mb)
                if by_entry is None:
                    by_entry = [[g.float() for g in ge] for ge in grads]
                    lsum = losses
                else:
                    for acc, ge in zip(by_entry, grads):
                        for a, g in zip(acc, ge):
                            a.add_(g.float())
                    lsum = [a + b for a, b in zip(lsum, losses)]
                del grads
            # divide by a tensor: a Python divisor may become a reciprocal
            # multiply on the card
            ns = [torch.tensor(float(len(mbs)), dtype=torch.float32,
                               device=d) for d in ctx.mesh.devices]
            for acc, n in zip(by_entry, ns):
                for a in acc:
                    a.div_(n)
            losses = [a / n for a, n in zip(lsum, ns)]
            metrics = {}
        gnorm = MC.global_norm(ctx, by_entry, paths)
        mu, nu = _entry_trees(opt_state["mu"], ctx.n), \
            _entry_trees(opt_state["nu"], ctx.n)
        ps = _entry_trees(params, ctx.n)
        for e in range(ctx.n):
            count = opt_state["count"].shards[e]
            state = {"mu": mu[e], "nu": nu[e], "count": count,
                     "gnorm": opt_state["gnorm"].shards[e]}
            g = _unflatten(paths, by_entry[e])
            by_entry[e] = None
            updates, new = opt.update(g, state, ps[e], gnorm=gnorm[e])
            del g
            with torch.no_grad():
                tree_map(lambda p, u: p.add_(u), ps[e], updates)
                count.copy_(new["count"])
                opt_state["gnorm"].shards[e].copy_(new["gnorm"])
            del updates
        out = dict(metrics, loss=losses, gnorm=gnorm)
        return params, opt_state, {
            k_: _placed(rep, (), v) for k_, v in out.items()}

    return step


def _lm_train_fn(ctx: LS.Ctx, bundle_in: tuple, specs: tuple, name: str,
                 sharded_batch: bool, n_tokens: int):
    """The LM's sharded train step (``runtime.lm_sharded.loss``)."""
    def loss(trees, batch):
        out = LS.loss(ctx, trees, batch["tokens"], batch["labels"],
                      sharded_batch, n_tokens)
        return [o[0] for o in out], {"xent": [o[1] for o in out],
                                     "aux": [o[2] for o in out]}

    return _sharded_train_fn(ctx, bundle_in, specs, name, loss)


def _opt_like(params_like: dict) -> dict:
    return {"mu": tree_map(lambda p: _meta(p.shape, torch.float32),
                           params_like),
            "nu": tree_map(lambda p: _meta(p.shape, torch.float32),
                           params_like),
            "count": _meta((), torch.int32),
            "gnorm": _meta((), torch.float32)}


def _lm_opt_cfg(arch: ArchDef, shape: LMShape, mesh: Mesh) -> T.LMConfig:
    """The config of the ``opt`` scheme's train step, as JAX's
    ``build_lm`` makes it (``steps.py:180-196``): query chunking off, MoE
    dispatch groups one an activation shard (``n_dp · tp``) and the
    buffer's spec. JAX's ``act_pspec``, ``kv_pspec`` and ``kv_chunk`` are
    the layout ``runtime.lm_seqpar`` runs (the port's config has no such
    fields)."""
    cfg = _lm_cfg_for_mesh(arch, mesh)
    da = SHR.batch_axes(mesh)
    tp = mesh.shape["model"]
    return dataclasses.replace(
        cfg, attn_chunk=max(cfg.attn_chunk, shape.seq_len),
        moe=None if cfg.moe is None else dataclasses.replace(
            cfg.moe, dispatch_groups=_n_dp(mesh) * tp,
            buf_pspec=(tuple(da), "model", None, None)))


def _lm_opt_train_fn(ctx: LS.Ctx, bundle_in: tuple, specs: tuple, name: str,
                     batch: int, seq: int):
    """The ``opt`` scheme's sharded train step (``runtime.lm_seqpar``):
    two microbatches, their gradients summed in f32. A layout the program
    cannot split evenly raises when the step is called."""
    why = SP.layout_error(ctx, batch, seq)
    n_tokens = batch // SP.MICRO * seq

    def loss(trees, mb):
        out = SP.loss(ctx, trees, mb["tokens"], mb["labels"], n_tokens)
        return [o[0] for o in out], {}

    def micro_batches(shards):
        return SP.micro_batches(ctx, shards["tokens"], shards["labels"],
                                batch)

    step = _sharded_train_fn(ctx, bundle_in, specs, name, loss,
                             micro_batches)
    if why is None:
        return step

    def refuse(*args):
        raise ValueError(f"{name}: the opt scheme's train step needs the "
                         f"batch split evenly over the mesh, and {why} "
                         "(ROADMAP A18.4, the opt scheme: A item 3.5)")
    return refuse


def build_lm(arch: ArchDef, shape: LMShape, mesh: Mesh,
             scheme: str = "baseline") -> StepBundle:
    """The JAX package's ``build_lm`` (``steps.py:175-285``). Under the
    baseline scheme each entry runs ``runtime.lm_sharded``; ``opt``
    changes only the train cells, as in JAX: ZeRO-3 params
    (``lm_param_rules_zero``), the batch at ``(da, "model")`` where the
    sequence splits over ``model``, sequence parallelism and ``micro=2``,
    each entry running ``runtime.lm_seqpar``. On prefill and decode the
    ``opt`` bundle is the baseline's."""
    if scheme == "halo" or scheme not in ("baseline", "opt"):
        raise ValueError(f"scheme {scheme!r} is not an LM scheme of the "
                         "port: the halo scheme is MeshGraphNet's "
                         "(ROADMAP A18.4, build_gnn_halo)")
    opt = scheme == "opt" and shape.kind == "train"
    cfg = _lm_opt_cfg(arch, shape, mesh) if opt \
        else _lm_cfg_for_mesh(arch, mesh)
    ctx = SP.make_ctx(mesh, cfg) if opt else LS.Ctx(mesh, cfg)
    da = SHR.batch_axes(mesh)
    params_like = _lm_param_specs(cfg)
    param_sh = _lm_shardings(params_like, mesh, ctx.rules)
    b, s = shape.global_batch, shape.seq_len
    n_dp = _n_dp(mesh)
    sharded = b % n_dp == 0
    bspec = _sh(mesh, da) if sharded else _rep(mesh)
    name = f"{arch.arch_id}:{shape.name}"
    i32 = torch.int32

    if shape.kind == "train":
        if opt and s % mesh.shape["model"] == 0:
            bspec = _sh(mesh, da, "model")
        opt_like = _opt_like(params_like)
        opt_sh = _opt_shardings(param_sh, mesh)
        batch = {"tokens": _meta((b, s), i32), "labels": _meta((b, s), i32)}
        batch_sh = {"tokens": bspec, "labels": bspec}
        specs = (params_like, opt_like, batch)
        in_sh = (param_sh, opt_sh, batch_sh)
        flops = 3.0 * _lm_flops_fwd(cfg, b * s, kv_len=s // 2)
        fn = _lm_opt_train_fn(ctx, in_sh, specs, name, b, s) if opt else \
            _lm_train_fn(ctx, in_sh, specs, name, sharded and n_dp > 1,
                         b * s)
        return StepBundle(
            name=name, kind="train", fn=fn, specs=specs, in_shardings=in_sh,
            out_shardings=(param_sh, opt_sh, _rep(mesh)),
            donate=(0, 1), meta=_lm_meta(cfg, flops, b * s))

    logits_sh = _sh(mesh, da, "model") if sharded else _sh(mesh, None,
                                                           "model")
    if shape.kind == "prefill":
        cache_sh = _lm_cache_sharding(mesh, b)
        specs = (params_like, _meta((b, s), i32))
        in_sh = (param_sh, bspec)
        cache_shape = (cfg.n_layers, b, s, cfg.n_kv_heads, cfg.head_dim)

        def prefill(params, tokens):
            _check_args((params, tokens), in_sh, specs, name)
            with torch.no_grad():
                lg, ck, cv = LS.prefill(ctx, _entry_trees(params, ctx.n),
                                        list(tokens.shards), cache_sh.spec,
                                        sharded and n_dp > 1)
            return (_placed(logits_sh, (b, cfg.vocab), lg),
                    _placed(cache_sh, cache_shape, ck),
                    _placed(cache_sh, cache_shape, cv))

        flops = _lm_flops_fwd(cfg, b * s, kv_len=s // 2)
        return StepBundle(
            name=name, kind="prefill", fn=prefill, specs=specs,
            in_shardings=in_sh,
            out_shardings=(logits_sh, cache_sh, cache_sh),
            donate=(), meta=_lm_meta(cfg, flops, b * s))

    # decode (decode_32k / long_500k): one new token, an S_max-slot cache
    cache_sh = _lm_cache_sharding(mesh, b, cfg.n_kv_heads)
    cache = _meta((cfg.n_layers, b, s, cfg.n_kv_heads, cfg.head_dim),
                  cfg.torch_dtype)
    specs = (params_like, _meta((b, 1), i32), cache, cache, _meta((), i32))
    in_sh = (param_sh, bspec if b > 1 else _rep(mesh), cache_sh, cache_sh,
             _rep(mesh))

    def decode(params, token, cache_k, cache_v, cache_len):
        _check_args((params, token, cache_k, cache_v, cache_len), in_sh,
                    specs, name)
        n = int(cache_len.shards[0])
        if not 0 <= n < s:
            raise ValueError(f"{name}: cache_len {n} is not a slot of the "
                             f"{s}-slot cache")
        with torch.no_grad():
            lg = LS.decode(ctx, _entry_trees(params, ctx.n),
                           list(token.shards), list(cache_k.shards),
                           list(cache_v.shards), n, cache_sh.spec)
        return _placed(logits_sh, (b, cfg.vocab), lg), cache_k, cache_v

    flops = _lm_flops_fwd(cfg, b, kv_len=s)
    return StepBundle(
        name=name, kind="decode", fn=decode, specs=specs, in_shardings=in_sh,
        out_shardings=(logits_sh, cache_sh, cache_sh), donate=(2, 3),
        meta=_lm_meta(cfg, flops, b))


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------

_GNN_MODELS = {
    "meshgraphnet": MGN,
    "schnet": SCH,
    "nequip": NQ,
    "pna": PNA,
}


def _gnn_flops_fwd(arch, n: int, e: int, d_feat: int) -> float:
    """The JAX package's forward model-FLOP count of a GNN cell, as it is."""
    cfg = arch.config
    if arch.arch_id == "meshgraphnet":
        h = cfg.d_hidden
        per = e * (3 * h * h + h * h) + n * (2 * h * h + h * h)
        enc = n * d_feat * h + e * 4 * h + n * h * cfg.out_dim
        return 2.0 * (cfg.n_layers * per + enc)
    if arch.arch_id == "pna":
        h = cfg.d_hidden
        n_agg = len(cfg.aggregators) * len(cfg.scalers)
        per = e * (2 * h * h) + n * ((n_agg + 1) * h * h)
        return 2.0 * (cfg.n_layers * per + n * d_feat * h)
    if arch.arch_id == "schnet":
        h, r = cfg.d_hidden, cfg.n_rbf
        per = e * (r * h + h * h + h) + n * (2 * h * h)
        return 2.0 * (cfg.n_interactions * per + n * h * h)
    if arch.arch_id == "nequip":
        c = cfg.channels
        # paths for l_max=2: (l1,l2,l3) with |l1-l2|<=l3<=min(l1+l2,lmax)
        paths = so3.paths(cfg.l_max)
        tp = sum((2 * l1 + 1) * (2 * l2 + 1) * (2 * l3 + 1)
                 for (l1, l2, l3) in paths)
        per = e * (cfg.n_rbf * 32 + 32 * len(paths) * c + c * tp) \
            + n * (len(paths) * c * c * 9)
        return 2.0 * cfg.n_layers * per
    raise ValueError(arch.arch_id)


def _all_axes(mesh: Mesh) -> tuple:
    return tuple(mesh.axis_names)


def _n_dev(mesh: Mesh) -> int:
    return len(mesh.devices)


def _gnn_param_specs(arch: ArchDef, d_feat: int) -> dict:
    mod, cfg = _GNN_MODELS[arch.arch_id], arch.config
    specs = mod.param_specs(cfg, d_feat) if arch.arch_id in (
        "meshgraphnet", "pna") else mod.param_specs(cfg)
    return _nest({k: _meta(shape, dt) for k, (shape, dt) in specs.items()})


def _gnn_batch_specs(arch: ArchDef, n: int, e: int, d_feat: int,
                     mol_batch: int = 0) -> dict:
    f32, i32 = torch.float32, torch.int32
    specs = {"senders": _meta((e,), i32), "receivers": _meta((e,), i32),
             "node_mask": _meta((n,), torch.bool)}
    if arch.arch_id in ("meshgraphnet", "pna"):
        specs["node_feat"] = _meta((n, d_feat), f32)
    if "pos" in arch.gnn_inputs or arch.arch_id in ("schnet", "nequip"):
        specs["positions"] = _meta((n, 3), f32)
    if arch.arch_id in ("schnet", "nequip"):
        specs["species"] = _meta((n,), i32)
    if mol_batch:
        specs["graph_id"] = _meta((n,), i32)
        specs["targets"] = _meta((mol_batch, 1), f32)
    else:
        specs["targets"] = _meta((n, 1), f32)
    return specs


def _gnn_meta(flops: float, n: int, e: int, **extra) -> dict:
    return {"family": "gnn", "model_flops": flops, "n_nodes": n,
            "n_edges": e, **extra}


def build_gnn(arch: ArchDef, shape: GNNShape, mesh: Mesh,
              scheme: str = "baseline") -> StepBundle:
    """The JAX package's ``build_gnn`` (``steps.py:351-411``): graph
    parallelism over the flattened mesh (``runtime.gnn_mesh``); the
    ``halo`` scheme is ``build_gnn_halo``, any other the baseline, as in
    JAX."""
    if scheme == "halo":
        return build_gnn_halo(arch, shape, mesh)
    ax, n_dev = _all_axes(mesh), _n_dev(mesh)
    if shape.kind == "molecule":
        mol = shape.mol_batch
        e = round_to(2 * shape.n_edges * mol, n_dev)
        n = round_to(mol * shape.n_nodes, n_dev)
        d_feat = 16
    elif shape.kind == "minibatch":
        n_sub, e_sub = subgraph_sizes(shape.batch_nodes, shape.fanout)
        n, e = round_to(n_sub, n_dev), round_to(e_sub, n_dev)
        d_feat, mol = shape.d_feat, 0
    else:
        n = round_to(shape.n_nodes, n_dev)
        e = round_to(2 * shape.n_edges, n_dev)
        d_feat, mol = shape.d_feat, 0
    params_like = _gnn_param_specs(arch, d_feat)
    param_sh = tree_map(lambda _: _rep(mesh), params_like)
    opt_like, opt_sh = _opt_like(params_like), _opt_shardings(param_sh, mesh)
    batch = _gnn_batch_specs(arch, n, e, d_feat, mol)
    split_targets = bool(mol) and mol % n_dev == 0
    batch_sh = {}
    for k, v in batch.items():
        if k == "targets" and mol:
            batch_sh[k] = _sh(mesh, ax, None) if split_targets \
                else _rep(mesh)
        elif v.dim() == 1:
            batch_sh[k] = _sh(mesh, ax)
        else:
            batch_sh[k] = _sh(mesh, ax, None)
    specs = (params_like, opt_like, batch)
    in_sh = (param_sh, opt_sh, batch_sh)
    name = f"{arch.arch_id}:{shape.name}"
    ctx, mod, cfg = GM.Ctx(mesh), _GNN_MODELS[arch.arch_id], arch.config

    def loss(trees, b):
        return GM.loss(ctx, mod, cfg, trees, b, n, split_targets)

    flops = 3.0 * _gnn_flops_fwd(arch, n, e, d_feat)
    return StepBundle(
        name=name, kind="train",
        fn=_sharded_train_fn(ctx, in_sh, specs, name, loss),
        specs=specs, in_shardings=in_sh,
        out_shardings=(param_sh, opt_sh, _rep(mesh)), donate=(0, 1),
        meta=_gnn_meta(flops, n, e))


HALO_FRAC_PATH = "artifacts/halo_frac.json"


def _halo_frac(shape: GNNShape) -> float:
    """SDP's measured boundary fraction of ``shape`` from
    ``artifacts/halo_frac.json`` (relative to the working directory, as
    the JAX package reads it), else 0.5."""
    frac = 0.5
    if os.path.exists(HALO_FRAC_PATH):
        with open(HALO_FRAC_PATH) as f:
            frac = json.load(f).get(shape.name, {}).get("sdp", frac)
    return frac


def build_gnn_halo(arch: ArchDef, shape: GNNShape, mesh: Mesh,
                   layout=None) -> StepBundle:
    """The JAX package's ``build_gnn_halo`` (``steps.py:414-481``):
    MeshGraphNet over SDP's blocked layout, one block a mesh entry
    (``runtime.gnn_halo_train.mgn_halo_mesh_loss``). Sizes by JAX's rule
    (``B_max`` from the boundary fraction of ``artifacts/halo_frac.json``,
    else 0.5; ``H_max`` 4·frac·Nb; ``E_max`` 1.25× the mean), or, given a
    ``layout`` (a ``graph.halo.HaloSpec`` of P = the mesh's entries), its
    own block, publish, halo and edge sizes rounded up to 8 — a port-only
    argument: JAX's ``H_max`` cannot hold a layout whose halo passes
    4·B_max (twitter's at k = 8). ``models.gnn.common.fit_batch(...,
    axis=1)`` pads a layout's batch to the bundle and raises where it
    does not fit."""
    if arch.arch_id != "meshgraphnet":
        raise ValueError(f"{arch.arch_id}: the halo scheme is implemented "
                         "for the meshgraphnet hillclimb cell")
    if shape.kind != "full":
        raise ValueError(f"{shape.name}: the halo scheme takes a full-graph "
                         f"shape, not {shape.kind!r}")
    ax, n_dev = _all_axes(mesh), _n_dev(mesh)
    e2 = round_to(2 * shape.n_edges, n_dev)
    if layout is None:
        n = round_to(shape.n_nodes, n_dev)
        nb = n // n_dev
        e_max = round_to(int(1.25 * e2 / n_dev), 8)
        frac = _halo_frac(shape)
        b_max = min(nb, round_to(max(8, int(frac * nb)), 8))
        h_max = min(8 * b_max, round_to(max(8, int(frac * nb * 4)), 8))
    else:
        if layout.n_shards != n_dev:
            raise ValueError(f"a layout of {layout.n_shards} blocks on a "
                             f"mesh of {n_dev} entries")
        nb = layout.block_size
        n = nb * n_dev
        b_max = round_to(layout.publish_size, 8)
        h_max = round_to(layout.halo_size, 8)
        e_max = round_to(int(layout.senders.shape[1]), 8)
        frac = layout.publish_size / nb
    cfg, d_feat = arch.config, shape.d_feat
    params_like = _gnn_param_specs(arch, d_feat)
    param_sh = tree_map(lambda _: _rep(mesh), params_like)
    opt_like, opt_sh = _opt_like(params_like), _opt_shardings(param_sh, mesh)
    f32, i32 = torch.float32, torch.int32
    batch = {
        "node_feat": _meta((n_dev, nb, d_feat), f32),
        "targets": _meta((n_dev, nb, 1), f32),
        "node_mask": _meta((n_dev, nb), torch.bool),
        "publish_idx": _meta((n_dev, b_max), i32),
        "halo_map": _meta((n_dev, h_max, 2), i32),
        "senders": _meta((n_dev, e_max), i32),
        "receivers": _meta((n_dev, e_max), i32),
    }
    batch_sh = {k: _sh(mesh, ax) for k in batch}
    specs = (params_like, opt_like, batch)
    in_sh = (param_sh, opt_sh, batch_sh)
    name = f"{arch.arch_id}:{shape.name}:halo"
    ctx = GM.Ctx(mesh)

    def loss(trees, b):
        return GH.mgn_halo_mesh_loss(ctx, cfg, trees, b, nb)

    flops = 3.0 * _gnn_flops_fwd(arch, n, e2, d_feat)
    return StepBundle(
        name=name, kind="train",
        fn=_sharded_train_fn(ctx, in_sh, specs, name, loss),
        specs=specs, in_shardings=in_sh,
        out_shardings=(param_sh, opt_sh, _rep(mesh)), donate=(0, 1),
        meta=_gnn_meta(flops, n, e2, halo_frac=frac, b_max=b_max))


# ---------------------------------------------------------------------------
# RecSys cells
# ---------------------------------------------------------------------------

def _recsys_param_shardings(params_like: dict, mesh: Mesh,
                            all_axes: bool = False) -> dict:
    """Tables row-sharded (model axis, or the whole mesh when all_axes —
    the 'opt' scheme); towers replicated."""
    rows = _all_axes(mesh) if all_axes else "model"
    return SHR._map_paths(params_like, lambda p: _sh(mesh, rows, None)
                          if "table" in p else _rep(mesh))


def _recsys_flops_fwd(cfg: RS.TwoTowerConfig, b: int) -> float:
    d = cfg.embed_dim
    tower = 0.0
    dims_u = [cfg.user_fields * d, *cfg.tower_mlp]
    dims_i = [cfg.item_fields * d, *cfg.tower_mlp]
    for a, bb in zip(dims_u[:-1], dims_u[1:]):
        tower += a * bb
    for a, bb in zip(dims_i[:-1], dims_i[1:]):
        tower += a * bb
    lookups = (cfg.user_fields + cfg.item_fields) * cfg.field_slots * d
    return 2.0 * b * (tower + lookups)


def _recsys_meta(flops: float, b: int) -> dict:
    return {"family": "recsys", "model_flops": flops, "batch": b}


def build_recsys(arch: ArchDef, shape: RecSysShape, mesh: Mesh,
                 scheme: str = "baseline") -> StepBundle:
    """The JAX package's ``build_recsys`` (``steps.py:512-598``): train,
    retrieval and the pairwise serving cells, the tables row-sharded over
    ``model`` (``opt``: every axis; any other scheme the baseline, as in
    JAX), each entry running ``runtime.recsys_sharded`` on its shards."""
    cfg: RS.TwoTowerConfig = arch.config
    params_like = _nest({k: _meta(sh, dt)
                         for k, (sh, dt) in RS.param_specs(cfg).items()})
    param_sh = _recsys_param_shardings(params_like, mesh,
                                       all_axes=scheme == "opt")
    ctx = RSS.Ctx(mesh, cfg, "opt" if scheme == "opt" else "baseline")
    da, ax, n_dev = SHR.batch_axes(mesh), _all_axes(mesh), _n_dev(mesh)
    b = shape.batch
    i32, f32 = torch.int32, torch.float32
    name = f"{arch.arch_id}:{shape.name}"

    def ids_spec(bb, fields):
        return _meta((bb, fields, cfg.field_slots), i32)

    if shape.kind == "train":
        batch = {"user_ids": ids_spec(b, cfg.user_fields),
                 "item_ids": ids_spec(b, cfg.item_fields),
                 "log_q": _meta((b,), f32)}
        batch_sh = {"user_ids": _sh(mesh, da, None, None),
                    "item_ids": _sh(mesh, da, None, None),
                    "log_q": _sh(mesh, da)}
        opt_sh = _opt_shardings(param_sh, mesh)
        specs = (params_like, _opt_like(params_like), batch)
        in_sh = (param_sh, opt_sh, batch_sh)

        def loss(trees, bt):
            return RSS.loss(ctx, trees, bt, b)

        flops = 3.0 * (_recsys_flops_fwd(cfg, b)
                       + 2.0 * b * b * cfg.tower_mlp[-1])
        return StepBundle(
            name=name, kind="train",
            fn=_sharded_train_fn(ctx, in_sh, specs, name, loss),
            specs=specs, in_shardings=in_sh,
            out_shardings=(param_sh, opt_sh, _rep(mesh)), donate=(0, 1),
            meta=_recsys_meta(flops, b))

    def serve_fn(in_sh, specs, out_sh, out_shape, run):
        def step(params, batch):
            _check_args((params, batch), in_sh, specs, name)
            shards = {k: list(v.shards) for k, v in batch.items()}
            with torch.no_grad():
                out = run(_entry_trees(params, ctx.n), shards)
            return _placed(out_sh, out_shape, out)
        return step

    if shape.kind == "retrieval":
        nc = shape.n_candidates
        batch = {"user_ids": ids_spec(b, cfg.user_fields),
                 "cand_item_emb": _meta((nc, cfg.tower_mlp[-1]), f32)}
        batch_sh = {"user_ids": _rep(mesh),
                    "cand_item_emb": _sh(mesh, ax, None)}
        specs, in_sh = (params_like, batch), (param_sh, batch_sh)
        out_sh = _sh(mesh, None, ax)
        flops = _recsys_flops_fwd(cfg, b) + 2.0 * b * nc * cfg.tower_mlp[-1]
        return StepBundle(
            name=name, kind="serve",
            fn=serve_fn(in_sh, specs, out_sh, (b, nc),
                        lambda p, bt: RSS.score_candidates(ctx, p, bt)),
            specs=specs, in_shardings=in_sh, out_shardings=out_sh,
            donate=(), meta=_recsys_meta(flops, b))

    # serve_p99 / serve_bulk: pairwise scores
    wide = b % n_dev == 0
    id_axes = ax if wide else (da if b % _n_dp(mesh) == 0 else ())
    bsh = _sh(mesh, id_axes) if id_axes else _rep(mesh)
    id_sh = _sh(mesh, id_axes, None, None) if id_axes else _rep(mesh)
    batch = {"user_ids": ids_spec(b, cfg.user_fields),
             "item_ids": ids_spec(b, cfg.item_fields)}
    batch_sh = {"user_ids": id_sh, "item_ids": id_sh}
    specs, in_sh = (params_like, batch), (param_sh, batch_sh)
    return StepBundle(
        name=name, kind="serve",
        fn=serve_fn(in_sh, specs, bsh, (b,),
                    lambda p, bt: RSS.serve_score(ctx, p, bt, id_axes)),
        specs=specs, in_shardings=in_sh, out_shardings=bsh, donate=(),
        meta=_recsys_meta(_recsys_flops_fwd(cfg, b), b))


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def build_step(arch_id: str, shape_name: str, mesh: Mesh,
               scheme: str = "baseline") -> StepBundle:
    """The bundle of one (arch x shape) cell on ``mesh``; a skip-marked
    cell raises, as in JAX."""
    arch = get_arch(arch_id)
    shape = arch.shapes[shape_name]
    if shape_name in arch.skip_shapes:
        raise ValueError(
            f"{arch_id}:{shape_name} is skip-marked: "
            f"{arch.skip_shapes[shape_name]}")
    if arch.family == "lm":
        return build_lm(arch, shape, mesh, scheme)
    if arch.family == "gnn":
        return build_gnn(arch, shape, mesh, scheme)
    return build_recsys(arch, shape, mesh, scheme)
