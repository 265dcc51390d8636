"""Train steps of the port (the counterpart of ``repro.launch.steps``'s
optimizer plumbing, ``steps.py:71-127``): ``round_to``, ``make_opt`` and
``_train_step_fn`` with gradient accumulation over microbatches.

Without ``jit`` a step is eager autograd: ``value_and_grad`` runs the loss
on views of the param leaves that require a gradient and takes
``torch.autograd.grad`` over them. The JAX package's ``StepBundle`` and
its sharded ``build_*`` step functions come with the training mesh (ROADMAP
A18.4 and the A18 tail).
"""
from __future__ import annotations

import torch

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
