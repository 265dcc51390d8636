"""A mesh's entries under a family's parameter rules, and the optimizer's
view of sharded gradients: the pieces every per-entry program of the step
bundles shares (``runtime.lm_sharded``, ``runtime.recsys_sharded``,
``runtime.gnn_mesh``, ``runtime.gnn_halo_train``; ``launch.steps``'
sharded train step).

* ``MeshCtx`` — each entry's coordinate on every axis, and each parameter
  leaf's spec under the rules (``runtime.sharding``);
* ``local_params`` — each replicated leaf's copies passed through
  ``collectives.copy_to``, so its gradient sums every copy's;
* ``global_norm`` — the sharded gradients' norm, each replicated leaf
  counted once, not once an entry.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.launch.mesh import Mesh, _spec_axes
from repro_torch.optim.optimizers import tree_paths
from repro_torch.runtime.collectives import all_reduce, copy_to
from repro_torch.runtime.sharding import _match, batch_axes


class MeshCtx:
    """A mesh and its parameter rules (``runtime.sharding``): each entry's
    coordinate on every axis, and each parameter leaf's spec."""

    def __init__(self, mesh: Mesh, rules: list):
        self.mesh, self.rules = mesh, rules
        self.n = len(mesh.devices)
        self.axes = tuple(mesh.axis_names)
        self.da = batch_axes(mesh)
        self.n_dp = self.size(self.da)
        coords = np.unravel_index(np.arange(self.n), mesh.dims)
        # each axis' coordinate of every entry
        self.at = {a: [int(x) for x in c] for a, c in zip(self.axes, coords)}

    def size(self, axes) -> int:
        return int(np.prod([self.mesh.shape[a] for a in axes], dtype=np.int64))

    def spec(self, path: str) -> tuple:
        """A param leaf's spec under the rules."""
        return tuple(_match(self.rules, path))

    def unnamed(self, spec) -> tuple:
        named = {a for e in spec for a in _spec_axes(e)}
        return tuple(a for a in self.axes if a not in named)

    def rank(self, axes, e: int) -> int:
        """Entry ``e``'s rank over ``axes`` (row-major, a spec entry's
        order)."""
        sizes = [self.mesh.shape[a] for a in axes]
        return int(np.ravel_multi_index([self.at[a][e] for a in axes], sizes))

    def entry_slice(self, axes, n: int, e: int) -> slice:
        """Entry ``e``'s block of ``n`` split over ``axes`` (row-major)."""
        r = n // self.size(axes)
        i = self.rank(axes, e)
        return slice(i * r, (i + 1) * r)


def local_params(ctx: MeshCtx, trees: list) -> list:
    """Each entry's param tree with every leaf's copies passed through
    ``copy_to`` over the axes its spec does not name (its gradient then
    sums every copy's)."""
    paths = ["/".join(p) for p, _ in tree_paths(trees[0])]
    out = [{} for _ in trees]
    for path in paths:
        keys = path.split("/")
        xs = []
        for t in trees:
            for k in keys:
                t = t[k]
            xs.append(t)
        unnamed = ctx.unnamed(ctx.spec(path))
        if ctx.size(unnamed) > 1:
            xs = copy_to(xs, ctx.mesh, unnamed)
        for o, x in zip(out, xs):
            node = o
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = x
    return out


def global_norm(ctx: MeshCtx, grads: list, paths: list) -> list:
    """Each entry's copy of the gradients' global norm: each entry sums the
    squares of the leaves whose block it holds first (coordinate 0 on the
    axes the leaf's spec does not name), then a sum over every axis — a
    replicated leaf counts once, not once an entry."""
    parts = []
    for e, gs in enumerate(grads):
        tot = torch.zeros((), dtype=torch.float32, device=ctx.mesh.devices[e])
        for path, g in zip(paths, gs):
            if all(ctx.at[a][e] == 0 for a in ctx.unnamed(ctx.spec(path))):
                tot = tot + torch.sum(g.float() ** 2)
        parts.append(tot)
    tot = all_reduce(parts, ctx.mesh, ctx.axes)
    return [torch.sqrt(t) for t in tot]
