"""Graph parallelism over the flattened mesh: the per-entry program that
XLA's SPMD partitioner makes of the JAX package's GNN train step under
``launch.steps.build_gnn`` (params replicated; nodes, edges and every
per-node or per-edge batch leaf split over all axes), written out on the
port's mesh with every collective an explicit call of
``runtime.collectives``.

The four models' ``apply`` take a graph object (``models.gnn.common``'s
docstring); :class:`Graph` is the mesh's, on :class:`MeshGraph`'s
per-entry ``map`` and loss, which the halo program's graph shares. Every value is a list of
per-entry tensors, entry ``e`` holding rows ``[e·r, (e+1)·r)`` of each
node tensor and its block of the edges, whose endpoints are global node
ids. The model's local math runs per entry (``Graph.map``); the rest is:

* **a read at edge endpoints** (``gather``): the node tensor all-gathered
  once over every axis, each entry reading its own edges' endpoints;
  backward, each entry's f64 scatter-add of its gradients,
  reduce-scattered in f64 (``collectives.all_gather_rows``);
* **a segment sum into the nodes** (``sum``): each entry's edges summed
  into all ``n`` rows in f64, reduce-scattered in f64 to the node shards
  and rounded once (``collectives.reduce_scatter_segments``): the
  one-card f64 sum rounded once, so the mesh's sums equal the card's up
  to f64 rounding;
* **mean and in-degree**: values and counts summed apart, divided once
  both sums are in;
* **max and min** (PNA; min as −max(−x)): the entries' segment maxima
  combined by ``all_reduce_max``; the value is that exact max, and its
  gradient is shared evenly among the tied edges of every entry, as one
  card's ``scatter_reduce`` shares it — the tied values and their count
  are summed like any segment sum, and the gradient flows through their
  quotient while the value stays the max;
* **the loss**: the masked MSE's numerator and denominator each summed
  over every axis; for a molecule batch the per-molecule readout over
  ``graph_id`` summed in f64 over every axis, then each entry holds its
  block of ``targets`` (or all of them where ``mol % n_dev != 0``).

Replicated params pass through ``collectives.copy_to``: their gradients
are all-reduced over every axis. The loss is differentiated from the
first entry's copy (``collectives``' docstring).
"""
from __future__ import annotations

import torch

from repro_torch.launch.mesh import PartitionSpec as P
from repro_torch.runtime import collectives as C
from repro_torch.runtime.mesh_ctx import MeshCtx, local_params


class Ctx(MeshCtx):
    """A GNN's mesh: every param replicated (``gnn_param_rules``)."""

    def __init__(self, mesh):
        super().__init__(mesh, [(r".*", P())])


def _safe(seg, n: int):
    return torch.where(seg >= 0, seg, n).long()


class MeshGraph:
    """What a mesh program's graph of ``n`` nodes has whatever its layout:
    the model's local math on each entry's values (``map``) and the loss
    summed over every axis. Its subclasses read node rows at edges
    (``gather``) and sum edges into nodes (``sum``)."""

    def __init__(self, ctx: MeshCtx, n: int, targets_split: bool = False):
        self.ctx, self.n = ctx, n
        self.mesh, self.axes = ctx.mesh, ctx.axes
        # a molecule batch's targets split over the entries (build_gnn's
        # rule: when the molecules divide the mesh), else whole on each
        self.targets_split = targets_split

    def map(self, fn, *xs):
        outs = [fn(*a) for a in zip(*xs)]
        if outs and isinstance(outs[0], tuple):
            return tuple(list(x) for x in zip(*outs))
        return outs

    def loss(self, per_node, batch):
        """The masked MSE over every entry's nodes, or for a molecule batch
        the MSE of the per-molecule sums: ``(losses, {"mse": losses})``, a
        copy on every entry."""
        mesh, axes = self.mesh, self.axes
        if "graph_id" in batch:
            losses = self._molecule_loss(per_node, batch)
        else:
            nums, dens = [], []
            for pred, t, mask in zip(per_node, batch["targets"],
                                     batch["node_mask"]):
                err = ((pred.float() - t.float()) ** 2) * mask.float()[:, None]
                nums.append(torch.sum(err))
                dens.append(torch.sum(mask.float()) * err.shape[-1])
            nums = C.all_reduce(nums, mesh, axes)
            dens = C.all_reduce([d.detach() for d in dens], mesh, axes)
            losses = [a / torch.clamp(b, min=1.0) for a, b in zip(nums, dens)]
        return losses, {"mse": losses}

    def _molecule_loss(self, per_node, batch) -> list:
        mesh, axes = self.mesh, self.axes
        targets = batch["targets"]
        n_mol = targets[0].shape[0] * (self.ctx.n if self.targets_split
                                       else 1)
        parts = []
        for x, gid in zip(per_node, batch["graph_id"]):
            part = torch.zeros((n_mol + 1,) + tuple(x.shape[1:]),
                               dtype=torch.float64, device=x.device)
            parts.append(part.index_add(0, _safe(gid, n_mol), x.double())
                         [:n_mol])
        preds = [p.to(x.dtype) for p, x in zip(
            C.all_reduce(parts, mesh, axes), per_node)]
        if not self.targets_split:
            return [torch.mean((p.float() - t.float()) ** 2)
                    for p, t in zip(preds, targets)]
        sums = [torch.sum((p[self.ctx.entry_slice(axes, n_mol, e)].float()
                           - t.float()) ** 2)
                for e, (p, t) in enumerate(zip(preds, targets))]
        total = C.all_reduce(sums, mesh, axes)
        den = n_mol * targets[0].shape[-1]
        return [s / torch.full((), float(den), dtype=s.dtype, device=s.device)
                for s in total]


class Graph(MeshGraph):
    """Graph parallelism: each entry holds rows ``[e·r, (e+1)·r)`` of the
    ``n`` global node ids and its block of the edges."""

    def own(self, xs: list) -> list:
        """Each entry's own block of ``n``-row tensors."""
        return [x[self.ctx.entry_slice(self.axes, self.n, e)]
                for e, x in enumerate(xs)]

    def gather(self, x, *idxs) -> tuple:
        safe = [[torch.clamp(i, min=0).long() for i in idx] for idx in idxs]
        return C.all_gather_rows(x, self.mesh, self.axes, *safe)

    def sum(self, data, seg_ids):
        return C.reduce_scatter_segments(data, self.mesh, self.axes, seg_ids,
                                         self.n)

    def mean(self, data, seg_ids):
        s = self.sum(data, seg_ids)
        cnt = self.sum([x.new_ones((x.shape[0], 1)) for x in data], seg_ids)
        return self.map(lambda a, c: a / torch.clamp(c, min=1.0), s, cnt)

    def degree(self, receivers):
        ones = [torch.ones(tuple(r.shape) + (1,), dtype=torch.float32,
                           device=r.device) for r in receivers]
        return [d[:, 0] for d in self.sum(ones, receivers)]

    def max(self, data, seg_ids, fill):
        """The segment max over every entry's edges (``fill`` where a node
        has none); see the module docstring for its gradient."""
        local = []
        for x, seg in zip(data, seg_ids):
            idx = _safe(seg, self.n).reshape((-1,) + (1,) * (x.dim() - 1))
            out = x.new_full((self.n + 1,) + tuple(x.shape[1:]), -torch.inf)
            local.append(out.scatter_reduce(
                0, idx.expand_as(x), x.detach(), "amax",
                include_self=False)[:self.n])
        top = C.all_reduce_max(local, self.mesh, self.axes)
        tied = [(seg >= 0).reshape((-1,) + (1,) * (x.dim() - 1))
                & (x.detach() == m[torch.clamp(seg, min=0).long()])
                for x, seg, m in zip(data, seg_ids, top)]
        val = self.sum([torch.where(t, x, 0.0) for t, x in zip(tied, data)],
                       seg_ids)
        cnt = self.sum([t.to(x.dtype) for t, x in zip(tied, data)], seg_ids)
        out = []
        for m, v, c in zip(self.own(top), val, cnt):
            q = v / torch.clamp(c, min=1.0)
            out.append(torch.where(torch.isfinite(m), m + (q - q.detach()),
                                   fill))
        return out

    def min(self, data, seg_ids, fill):
        return [-x for x in self.max([-x for x in data], seg_ids, -fill)]


def loss(ctx: Ctx, model, cfg, params: list, batch: dict, n: int,
         targets_split: bool = False):
    """Each entry's ``(loss, {"mse": ...})`` of ``model`` (a module of
    ``models.gnn``) on its shards: ``params`` one tree an entry (its
    replicated copies), ``batch`` one list of shards a leaf, ``n`` the
    global node count."""
    g = Graph(ctx, n, targets_split)
    return model.loss_fn(local_params(ctx, params), batch, cfg, g)
