"""Train steps of the port (the counterpart of ``repro.launch.steps``'s
optimizer plumbing, ``steps.py:71-141``): ``round_to``, ``make_opt``,
``_train_step_fn`` with gradient accumulation over microbatches, the LM
cells' model-FLOP count ``_lm_flops_fwd``, and the GNN cells' model
modules ``_GNN_MODELS`` and FLOP count ``_gnn_flops_fwd``
(``steps.py:280-348``).

Without ``jit`` a step is eager autograd: ``value_and_grad`` runs the loss
on views of the param leaves that require a gradient and takes
``torch.autograd.grad`` over them. The JAX package's ``StepBundle`` and
its sharded ``build_*`` step functions come with the training mesh (the
rest of ROADMAP A18.4).
"""
from __future__ import annotations

import torch

from repro_torch.models.gnn import meshgraphnet as MGN
from repro_torch.models.gnn import nequip as NQ
from repro_torch.models.gnn import pna as PNA
from repro_torch.models.gnn import schnet as SCH
from repro_torch.models.gnn import so3
from repro_torch.optim.optimizers import (
    adamw, apply_updates, tree_leaves, tree_map, tree_paths,
)


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
