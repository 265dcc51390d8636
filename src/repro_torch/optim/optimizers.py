"""Optimizers of the port (the counterpart of ``repro.optim.optimizers``):
AdamW, SGD with momentum, schedules and global-norm clipping over nested
dicts of tensors, with the JAX package's functional API:

    opt = adamw(schedule, ...)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

The math is JAX's, term for term. State is f32 whatever the param dtype;
``count`` is an int32 and ``gnorm`` an f32 0-dim tensor, so a checkpoint
holds the same leaves as the JAX package's (``opt_state_from_jax`` carries
a JAX state across). Two departures, both for memory, neither for the
math: ``update`` writes the moments (``mu``/``nu``, ``mom``) in place and
returns them in the new state — the old state is gone after the call —
and it updates one leaf at a time, dropping each leaf's temporaries before
the next, so at the full two-tower training config (two 4.29 GB tables)
the step needs a few table-sized temporaries, not a copy of every tree.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def tree_paths(tree: dict, prefix: tuple = ()):
    """(path, leaf) pairs of a nested dict in ``jax.tree.leaves`` order
    (keys sorted at every level)."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from tree_paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def tree_leaves(tree: dict) -> list:
    return [v for _, v in tree_paths(tree)]


def tree_map(fn, tree: dict, *rest: dict) -> dict:
    """``fn`` over matching leaves of nested dicts, one leaf at a time in
    sorted key order."""
    return {k: tree_map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
            else fn(v, *(r[k] for r in rest)) for k, v in sorted(tree.items())}


def _as_step(step) -> torch.Tensor:
    """A schedule's step as a tensor (the optimizer passes its int32
    ``count``; a Python int is taken as int32 on the CPU)."""
    if isinstance(step, torch.Tensor):
        return step
    return torch.tensor(step, dtype=torch.int32)


def cosine_schedule(base_lr: float, total_steps: int, final_frac: float = 0.1):
    def lr(step):
        step = _as_step(step)
        t = torch.clamp(step, max=total_steps) / max(total_steps, 1)
        cos = 0.5 * (1 + torch.cos(np.pi * t))
        return base_lr * (final_frac + (1 - final_frac) * cos)
    return lr


def linear_warmup_cosine(base_lr: float, warmup: int, total_steps: int,
                         final_frac: float = 0.1):
    cos = cosine_schedule(base_lr, max(total_steps - warmup, 1), final_frac)

    def lr(step):
        step = _as_step(step)
        w = torch.clamp(step / max(warmup, 1), max=1.0)
        return torch.where(step < warmup, base_lr * w, cos(step - warmup))
    return lr


def global_norm(grads: dict) -> torch.Tensor:
    """sqrt of the sum over leaves, in ``jax.tree.leaves`` order from a
    Python 0, of each leaf's f32 sum of squares."""
    total = 0
    for g in tree_leaves(grads):
        total = total + torch.sum(g.float() ** 2)
    return torch.sqrt(total)


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / (gn + 1e-9), max=1.0)


def clip_by_global_norm(grads: dict, max_norm: float):
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    # a bf16 leaf times the f32 norm's scale is f32, as in JAX
    return tree_map(lambda g: g.float() * scale, grads), gn


def _set(tree: dict, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _get(tree: dict, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def adamw(lr: Callable | float, b1=0.9, b2=0.95, eps=1e-8,
          weight_decay=0.1, clip_norm: float = 1.0) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        first = tree_leaves(params)[0]
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                      device=p.device)
        return {
            "mu": tree_map(zeros, params),
            "nu": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=first.device),
            "gnorm": torch.zeros((), dtype=torch.float32, device=first.device),
        }

    def update(grads, state, params, gnorm=None):
        """``gnorm``: the gradients' global norm where they are one
        entry's shards of a larger tree (computed here when None)."""
        with torch.no_grad():
            if gnorm is None:
                gnorm = global_norm(grads)
            scale = _clip_scale(gnorm, clip_norm) if clip_norm > 0 else None
            c = state["count"] + 1
            step_lr = lr_fn(c)
            bc1, bc2 = 1 - b1 ** c, 1 - b2 ** c
            updates: dict = {}
            for path, g in tree_paths(grads):
                m, v = _get(state["mu"], path), _get(state["nu"], path)
                p = _get(params, path)
                g = g.float() if scale is None else g.float() * scale
                m.mul_(b1).add_(g * (1 - b1))       # b1 * m + (1 - b1) * g
                v.mul_(b2).add_(g.square().mul_(1 - b2))
                del g
                mh = m / bc1
                den = (v / bc2).sqrt_().add_(eps)   # sqrt(vh) + eps
                upd = mh.div_(den)
                del den
                upd.add_(weight_decay * p.float())
                _set(updates, path, upd.mul_(-step_lr).to(p.dtype))
                del upd
        return updates, {"mu": state["mu"], "nu": state["nu"], "count": c,
                         "gnorm": gnorm}

    return Optimizer(init, update)


def sgd_momentum(lr: Callable | float, momentum=0.9,
                 clip_norm: float = 0.0) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        first = tree_leaves(params)[0]
        return {
            "mom": tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params),
            "count": torch.zeros((), dtype=torch.int32, device=first.device),
        }

    def update(grads, state, params):
        with torch.no_grad():
            if clip_norm > 0:
                grads, _ = clip_by_global_norm(grads, clip_norm)
            c = state["count"] + 1
            step_lr = lr_fn(c)
            updates: dict = {}
            for path, g in tree_paths(grads):
                m = _get(state["mom"], path)
                m.mul_(momentum).add_(g.float())    # momentum * m + g
                p = _get(params, path)
                _set(updates, path, (-step_lr * m).to(p.dtype))
        return updates, {"mom": state["mom"], "count": c}

    return Optimizer(init, update)


def apply_updates(params: dict, updates: dict) -> dict:
    with torch.no_grad():
        return tree_map(lambda p, u: p + u, params, updates)


def opt_state_from_jax(np_state: dict, params: dict) -> dict:
    """The port's optimizer state from a JAX AdamW (``mu``, ``nu``,
    ``count``, ``gnorm``) or SGD (``mom``, ``count``) state with numpy
    leaves, on the devices of ``params``' leaves; each moment tree must
    match ``params``' shapes."""
    first = tree_leaves(params)[0]
    out = {}
    for key, val in np_state.items():
        if key in ("mu", "nu", "mom"):
            def carry(a, p, key=key):
                a = np.asarray(a)
                if a.shape != tuple(p.shape):
                    raise ValueError(f"{key} leaf of shape {a.shape} does not "
                                     f"fit a param of {tuple(p.shape)}")
                return torch.from_numpy(
                    np.array(a, dtype=np.float32, order="C")).to(p.device)
            if sorted(val) != sorted(params):
                raise ValueError(f"{key} has leaves {sorted(val)}, the params "
                                 f"{sorted(params)}")
            out[key] = tree_map(carry, val, params)
        elif key in ("count", "gnorm"):
            dtype = torch.int32 if key == "count" else torch.float32
            out[key] = torch.tensor(np.asarray(val).item(), dtype=dtype,
                                    device=first.device)
        else:
            raise ValueError(f"unknown optimizer state leaf {key!r}")
    return out
