"""Step builders of the port (the counterpart of ``repro.launch.steps``):
one step per (arch x shape) with its shardings, the layer the trainer, the
server and the dry-run share.

For an LM cell ``build_lm`` / ``build_step`` give a ``StepBundle``, as the
JAX package's (``steps.py:41-285, 601-613``):

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
(``runtime.lm_sharded``, ``runtime.collectives``): FSDP on data (x pod),
TP on model, EP for MoE experts. Only the baseline scheme of the LM cells
is built; the GNN and recsys cells and the ``opt`` and ``halo`` schemes
raise, naming their ROADMAP items.

Beside the bundles: ``train_step`` (the one-card eager step), ``make_opt``
and the FLOP counts of the LM and GNN cells.

Without ``jit`` a step is eager autograd: ``value_and_grad`` runs the loss
on views of the param leaves that require a gradient and takes
``torch.autograd.grad`` over them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs import get_arch
from repro_torch.configs.base import ArchDef
from repro_torch.configs.shapes import LMShape
from repro_torch.launch.mesh import (
    Mesh, PartitionSpec as P, Placement, SpecBlocks, _block_slices,
)
from repro_torch.models import transformer as T
from repro_torch.models.gnn import meshgraphnet as MGN
from repro_torch.models.gnn import nequip as NQ
from repro_torch.models.gnn import pna as PNA
from repro_torch.models.gnn import schnet as SCH
from repro_torch.models.gnn import so3
from repro_torch.optim.optimizers import (
    adamw, apply_updates, tree_leaves, tree_map, tree_paths,
)
from repro_torch.runtime import lm_sharded as LS
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


def _lm_shardings(params_like, mesh: Mesh) -> dict:
    return SHR.shardings_from_rules(params_like, SHR.lm_param_rules(mesh),
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


def _lm_train_fn(ctx: LS.Ctx, bundle_in: tuple, specs: tuple, name: str,
                 sharded_batch: bool, n_tokens: int):
    """The sharded train step: every entry's loss and gradients on its
    shards, the global norm, AdamW on each entry's slices in place."""
    opt = make_opt()
    rep = _rep(ctx.mesh)

    def step(params, opt_state, batch):
        _check_args((params, opt_state, batch), bundle_in, specs, name)
        paths = ["/".join(p) for p, _ in tree_paths(params)]
        blocks = tree_leaves(params)
        leaves = [[b.shards[e].detach().requires_grad_(True) for b in blocks]
                  for e in range(ctx.n)]
        trees = [_unflatten(paths, lv) for lv in leaves]
        with torch.enable_grad():
            out = LS.loss(ctx, trees, list(batch["tokens"].shards),
                          list(batch["labels"].shards), sharded_batch,
                          n_tokens)
            flat = [x for lv in leaves for x in lv]
            grads = torch.autograd.grad(out[0][0], flat, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(flat, grads)]
        k = len(paths)
        by_entry = [grads[e * k:(e + 1) * k] for e in range(ctx.n)]
        del leaves, trees, flat, grads
        gnorm = LS.global_norm(ctx, by_entry, paths)
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
        metrics = {
            "xent": [o[1].detach() for o in out],
            "aux": [o[2].detach() for o in out],
            "loss": [o[0].detach() for o in out],
            "gnorm": gnorm}
        return params, opt_state, {
            k_: _placed(rep, (), v) for k_, v in metrics.items()}

    return step


def build_lm(arch: ArchDef, shape: LMShape, mesh: Mesh,
             scheme: str = "baseline") -> StepBundle:
    """The JAX package's ``build_lm`` (``steps.py:175-285``), baseline
    scheme. ``opt`` changes only the train cells there (ZeRO-3 rules,
    ``micro=2``, sequence parallelism) and raises here for them (ROADMAP
    A18.4, the ``opt`` scheme); on prefill and decode its bundle is the
    baseline's, as in JAX."""
    if scheme == "halo" or scheme not in ("baseline", "opt"):
        raise ValueError(f"scheme {scheme!r} is not an LM scheme of the "
                         "port: the halo scheme is MeshGraphNet's "
                         "(ROADMAP A18.4, build_gnn_halo)")
    if scheme == "opt" and shape.kind == "train":
        raise ValueError(f"{arch.arch_id}:{shape.name}: the opt scheme's "
                         "train step (lm_param_rules_zero, micro=2, sequence "
                         "parallelism) is not ported yet (ROADMAP A18.4, the "
                         "opt scheme)")
    cfg = _lm_cfg_for_mesh(arch, mesh)
    ctx = LS.Ctx(mesh, cfg)
    da = SHR.batch_axes(mesh)
    params_like = _lm_param_specs(cfg)
    param_sh = _lm_shardings(params_like, mesh)
    b, s = shape.global_batch, shape.seq_len
    n_dp = _n_dp(mesh)
    sharded = b % n_dp == 0
    bspec = _sh(mesh, da) if sharded else _rep(mesh)
    name = f"{arch.arch_id}:{shape.name}"
    i32 = torch.int32

    if shape.kind == "train":
        opt_like = {"mu": tree_map(lambda p: _meta(p.shape, torch.float32),
                                   params_like),
                    "nu": tree_map(lambda p: _meta(p.shape, torch.float32),
                                   params_like),
                    "count": _meta((), i32), "gnorm": _meta((), torch.float32)}
        opt_sh = _opt_shardings(param_sh, mesh)
        batch = {"tokens": _meta((b, s), i32), "labels": _meta((b, s), i32)}
        batch_sh = {"tokens": bspec, "labels": bspec}
        specs = (params_like, opt_like, batch)
        in_sh = (param_sh, opt_sh, batch_sh)
        flops = 3.0 * _lm_flops_fwd(cfg, b * s, kv_len=s // 2)
        return StepBundle(
            name=name, kind="train",
            fn=_lm_train_fn(ctx, in_sh, specs, name, sharded and n_dp > 1,
                            b * s),
            specs=specs, in_shardings=in_sh,
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


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def build_step(arch_id: str, shape_name: str, mesh: Mesh,
               scheme: str = "baseline") -> StepBundle:
    """The bundle of one (arch x shape) cell on ``mesh``: the LM cells
    (``build_lm``); a skip-marked cell raises, as in JAX, and so do the GNN
    and recsys cells, whose builders are not ported yet."""
    arch = get_arch(arch_id)
    shape = arch.shapes[shape_name]
    if shape_name in arch.skip_shapes:
        raise ValueError(
            f"{arch_id}:{shape_name} is skip-marked: "
            f"{arch.skip_shapes[shape_name]}")
    if arch.family == "lm":
        return build_lm(arch, shape, mesh, scheme)
    what = ("build_gnn and build_gnn_halo" if arch.family == "gnn"
            else "build_recsys")
    raise ValueError(f"{arch_id}:{shape_name}: the {arch.family} bundles "
                     f"({what}) are not ported yet (ROADMAP A18.4, {what})")
