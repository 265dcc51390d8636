"""Collectives over a ``launch.mesh.Mesh``: the operations XLA's SPMD
partitioner (GSPMD) inserts into a JAX step's per-device program, written
out for the port's meshes, which one process drives (``launch.mesh``).

A sharded value is a list of per-entry tensors, one per mesh entry in the
mesh's row-major order, entry ``i``'s tensor on ``mesh.devices[i]`` (a
tensor elsewhere raises). An operation over an axis, or a tuple of axes,
acts on each group of entries that differ only in those axes' coordinates;
a group's ranks are read row-major over the axes, as a ``PartitionSpec``
entry reads them. Every output is a tensor of its own, also where entries
share a device (a view would alias the shards that a donated step then
overwrites).

* ``all_gather(xs, mesh, axes, dim)`` — every rank gets its group's
  tensors concatenated along ``dim`` in rank order;
* ``reduce_scatter(xs, mesh, axes, dim)`` — the group's sum, cut into
  equal blocks along ``dim``, block ``r`` to rank ``r``;
* ``all_reduce(xs, mesh, axes)`` — the group's sum on every rank;
  ``all_reduce_max`` the elementwise max (not differentiable: it serves
  the softmax's stabiliser, whose gradient is 0);
* ``all_to_all(xs, mesh, axes, split_dim, concat_dim)`` — rank ``r``'s
  tensor cut into equal blocks along ``split_dim``, block ``j`` to rank
  ``j``, which concatenates what it gets along ``concat_dim`` in rank
  order;
* ``permute_chunks(xs, mesh, axes, split_dim, concat_dim, routes)`` —
  an all-to-all with any routing: rank ``r``'s tensor cut into equal
  chunks along ``split_dim``, rank ``r`` concatenating along
  ``concat_dim`` the chunks ``routes[r]`` names, each ``(source rank,
  chunk)`` of the group once; its adjoint is the inverse routing;
* ``copy_to(xs, mesh, axes)`` — Megatron's "copy": the identity forward,
  an all-reduce of the gradients backward. A replicated parameter's
  copies pass through it, so each copy's gradient is the sum of every
  copy's, as GSPMD all-reduces a replicated parameter's gradient;
* ``all_gather_rows(xs, mesh, axes, *idxs)`` — row blocks all-gathered
  once and read at each index set (a sharded node tensor read at edge
  endpoints); backward each entry scatter-adds its gradients in f64 and
  the partials are reduce-scattered in f64, rounded once;
* ``reduce_scatter_segments(xs, mesh, axes, segs, n)`` — each entry's
  rows summed into ``n`` segments in f64 (``seg`` -1 dropped), the
  partials reduce-scattered in f64 and rounded once: each rank's block
  of the segment sums; backward an all-gather of the gradient read at
  the segment ids.

The last two keep the port's GNN sums in f64 across entries, as
``models.gnn.common`` keeps them on one card: a sum split over entries
is then the one-card sum rounded once, up to f64's own rounding.

Each is a ``torch.autograd.Function`` whose backward is its adjoint: the
adjoint of ``all_gather`` is ``reduce_scatter`` (where FSDP's
data-parallel gradient sum comes from), of ``all_reduce`` itself, of
``all_to_all`` the ``all_to_all`` with the two dims swapped. A sharded
loss is differentiated from one entry's copy of it: every replicated
value is created by one of these operations, whose adjoint sums the
copies' gradients.

Sums run in rank order on the group's first entry (as
``optim.compression`` sums its payloads), so a run is deterministic; the
result then crosses to every rank.

Every call, forward or backward, adds the ring model's wire bytes a
device to the entries' counters by operation (``wire_bytes``), with the
formulas of the JAX package's HLO statistics, ``nbytes`` the bytes of one
device's result and ``g`` the group's size: all-gather ``nbytes (g - 1) /
g``, all-reduce ``2 nbytes (g - 1) / g``, reduce-scatter ``nbytes (g -
1)``, all-to-all ``nbytes (g - 1) / g``; ``permute_chunks`` counts as an
all-to-all the bytes each rank receives from the others (the same figure
where the routing is an all-to-all's). They are the port's stand-in for
what the JAX package reads from a compiled step's HLO.

"""
from __future__ import annotations

from collections import defaultdict

import numpy as np
import torch

from repro_torch.launch.mesh import Mesh

OPS = ("all_gather", "all_reduce", "reduce_scatter", "all_to_all")


_WIRE: dict = {op: defaultdict(float) for op in OPS}


def ring_wire_bytes(op: str, nbytes: float, g: int) -> float:
    """The wire bytes a device sends for one ``op`` whose result on that
    device is ``nbytes``, in a group of ``g`` (the ring model)."""
    if op == "all_gather":
        return nbytes * (g - 1) / g
    if op == "all_reduce":
        return 2.0 * nbytes * (g - 1) / g
    if op == "reduce_scatter":
        return nbytes * (g - 1)
    if op == "all_to_all":
        return nbytes * (g - 1) / g
    raise ValueError(f"unknown collective {op!r}; one of {OPS}")


def reset_wire_bytes() -> None:
    for op in OPS:
        _WIRE[op].clear()


def wire_bytes() -> dict:
    """``{op: {entry index: wire bytes}}`` since the last reset."""
    return {op: dict(sorted(_WIRE[op].items())) for op in OPS}


def _count(op: str, outs, groups) -> None:
    for group in groups:
        for i in group:
            t = outs[i]
            _WIRE[op][i] += ring_wire_bytes(
                op, t.numel() * t.element_size(), len(group))


def _axes(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def groups(mesh: Mesh, axes) -> list:
    """The entry indices of each group over ``axes``, each in rank order
    (row-major over ``axes``), the groups in the order of their first
    entries."""
    axes = _axes(axes)
    unknown = [a for a in axes if a not in mesh.axis_names]
    if unknown or len(set(axes)) != len(axes):
        raise ValueError(f"axes {axes}: each at most once, and only axes of "
                         f"the mesh {mesh.shape}")
    idx = np.arange(len(mesh.devices)).reshape(mesh.dims)
    pos = [mesh.axis_names.index(a) for a in axes]
    rest = [i for i in range(len(mesh.dims)) if i not in pos]
    grid = idx.transpose(rest + pos).reshape(-1, int(np.prod(
        [mesh.dims[i] for i in pos], dtype=np.int64)))
    return [tuple(int(i) for i in row) for row in grid]


def _check(xs, mesh: Mesh, what: str) -> None:
    if len(xs) != len(mesh.devices):
        raise ValueError(f"{what}: {len(xs)} tensors for the "
                         f"{len(mesh.devices)} entries of the mesh "
                         f"{mesh.shape}")
    for i, (x, d) in enumerate(zip(xs, mesh.devices)):
        if x.device != torch.device(d):
            raise ValueError(f"{what}: entry {i} lives on {d}, but its "
                             f"tensor is on {x.device}")


def _own(x: torch.Tensor, device, keep: bool) -> torch.Tensor:
    """``x`` on ``device`` as a tensor of its own (``keep``: ``x`` is
    already one, made for this rank)."""
    if keep and x.device == torch.device(device):
        return x
    return x.to(device, copy=True)


def _sum(parts, op=torch.add) -> torch.Tensor:
    """The rank-order sum (or ``op``) of ``parts`` on the first's device."""
    lead = parts[0].device
    tot = parts[0]
    for p in parts[1:]:
        tot = op(tot, p.to(lead))
    return tot


def _gather(xs, mesh, axes, dim):
    gs = groups(mesh, axes)
    outs = [None] * len(xs)
    for group in gs:
        for i in group:
            dev = mesh.devices[i]
            outs[i] = torch.cat([xs[j].to(dev) for j in group], dim=dim)
    _count("all_gather", outs, gs)
    return outs


def _scatter(xs, mesh, axes, dim):
    gs = groups(mesh, axes)
    outs = [None] * len(xs)
    for group in gs:
        tot = _sum([xs[j] for j in group])
        n = tot.shape[dim]
        if n % len(group):
            raise ValueError(f"reduce_scatter: dim {dim} of "
                             f"{tuple(tot.shape)} does not split into "
                             f"{len(group)} blocks")
        for r, i in enumerate(group):
            block = tot.narrow(dim, r * (n // len(group)), n // len(group))
            outs[i] = block.to(mesh.devices[i], copy=True,
                               memory_format=torch.contiguous_format)
    _count("reduce_scatter", outs, gs)
    return outs


def _reduce(xs, mesh, axes, op=torch.add):
    gs = groups(mesh, axes)
    outs = [None] * len(xs)
    for group in gs:
        tot = _sum([xs[j] for j in group], op)
        fresh = len(group) > 1    # a one-rank group's sum is its input
        for r, i in enumerate(group):
            outs[i] = _own(tot, mesh.devices[i], keep=fresh and r == 0)
    _count("all_reduce", outs, gs)
    return outs


def _to_all(xs, mesh, axes, split_dim, concat_dim):
    gs = groups(mesh, axes)
    outs = [None] * len(xs)
    for group in gs:
        g = len(group)
        for r, i in enumerate(group):
            dev = mesh.devices[i]
            parts = []
            for j in group:
                n = xs[j].shape[split_dim]
                if n % g:
                    raise ValueError(f"all_to_all: dim {split_dim} of "
                                     f"{tuple(xs[j].shape)} does not split "
                                     f"into {g} blocks")
                parts.append(xs[j].narrow(split_dim, r * (n // g), n // g)
                             .to(dev))
            outs[i] = torch.cat(parts, dim=concat_dim)
    _count("all_to_all", outs, gs)
    return outs


def _permute(xs, mesh, axes, split_dim, concat_dim, routes):
    """``routes[r]``: the (source rank, chunk) pairs rank ``r`` of every
    group concatenates; each rank's tensor is cut into as many equal
    chunks as each rank takes."""
    gs = groups(mesh, axes)
    c = len(routes[0])
    outs = [None] * len(xs)
    for group in gs:
        for r, i in enumerate(group):
            dev = mesh.devices[i]
            parts = []
            for src, j in routes[r]:
                x = xs[group[src]]
                n = x.shape[split_dim]
                if n % c:
                    raise ValueError(f"permute_chunks: dim {split_dim} of "
                                     f"{tuple(x.shape)} does not split into "
                                     f"{c} chunks")
                part = x.narrow(split_dim, j * (n // c), n // c).to(dev)
                if src != r:
                    _WIRE["all_to_all"][i] += part.numel() * \
                        part.element_size()
                parts.append(part)
            outs[i] = torch.cat(parts, dim=concat_dim)
    return outs


def _inverse(routes) -> list:
    """The routing that sends every chunk of ``routes`` back."""
    inv = [[None] * len(routes[0]) for _ in routes]
    for r, route in enumerate(routes):
        for pos, (src, j) in enumerate(route):
            inv[src][j] = (r, pos)
    return inv


def _saved(ctx, args, outs) -> tuple:
    ctx.args = args
    ctx.out_shapes = [o.shape for o in outs]
    return tuple(outs)


def _grads(ctx, gs):
    """The output gradients, a zero tensor where an output got none (its
    value fed nothing that was differentiated)."""
    if all(g is not None for g in gs):
        return gs
    ref = next(g for g in gs if g is not None)
    devices = ctx.args[0].devices
    return [g if g is not None else
            torch.zeros(ctx.out_shapes[i], dtype=ref.dtype,
                        device=devices[i])
            for i, g in enumerate(gs)]


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axes, dim, *xs):
        return _saved(ctx, (mesh, axes, dim), _gather(xs, mesh, axes, dim))

    @staticmethod
    def backward(ctx, *gs):
        mesh, axes, dim = ctx.args
        return (None, None, None,
                *_scatter(_grads(ctx, gs), mesh, axes, dim))


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axes, dim, *xs):
        return _saved(ctx, (mesh, axes, dim), _scatter(xs, mesh, axes, dim))

    @staticmethod
    def backward(ctx, *gs):
        mesh, axes, dim = ctx.args
        return (None, None, None,
                *_gather(_grads(ctx, gs), mesh, axes, dim))


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axes, *xs):
        return _saved(ctx, (mesh, axes), _reduce(xs, mesh, axes))

    @staticmethod
    def backward(ctx, *gs):
        mesh, axes = ctx.args
        return (None, None, *_reduce(_grads(ctx, gs), mesh, axes))


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axes, split_dim, concat_dim, *xs):
        return _saved(ctx, (mesh, axes, split_dim, concat_dim),
                      _to_all(xs, mesh, axes, split_dim, concat_dim))

    @staticmethod
    def backward(ctx, *gs):
        mesh, axes, split_dim, concat_dim = ctx.args
        return (None, None, None, None,
                *_to_all(_grads(ctx, gs), mesh, axes, concat_dim,
                         split_dim))


class _PermuteChunks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axes, split_dim, concat_dim, routes, *xs):
        return _saved(ctx, (mesh, axes, split_dim, concat_dim, routes),
                      _permute(xs, mesh, axes, split_dim, concat_dim, routes))

    @staticmethod
    def backward(ctx, *gs):
        mesh, axes, split_dim, concat_dim, routes = ctx.args
        return (None, None, None, None, None,
                *_permute(_grads(ctx, gs), mesh, axes, concat_dim,
                          split_dim, _inverse(routes)))


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axes, *xs):
        return _saved(ctx, (mesh, axes), [x.view_as(x) for x in xs])

    @staticmethod
    def backward(ctx, *gs):
        mesh, axes = ctx.args
        return (None, None, *_reduce(_grads(ctx, gs), mesh, axes))


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axes, k, *args):
        n = len(mesh.devices)
        idxs = [args[i * n:(i + 1) * n] for i in range(k)]
        xs = args[k * n:]
        full = _gather(xs, mesh, axes, 0)
        outs = [full[e].index_select(0, idx[e]) for idx in idxs
                for e in range(n)]
        ctx.args = (mesh, axes, k, [x.dtype for x in xs])
        ctx.rows = [tuple(f.shape) for f in full]
        ctx.save_for_backward(*args[:k * n])
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        mesh, axes, k, dtypes = ctx.args
        n = len(mesh.devices)
        idxs = ctx.saved_tensors
        parts = []
        for e in range(n):
            part = torch.zeros(ctx.rows[e], dtype=torch.float64,
                               device=mesh.devices[e])
            for i in range(k):
                g = gs[i * n + e]
                if g is not None:
                    part.index_add_(0, idxs[i * n + e], g.double())
            parts.append(part)
        outs = _scatter(parts, mesh, axes, 0)
        return (None, None, None, *([None] * (k * n)),
                *(o.to(dt) for o, dt in zip(outs, dtypes)))


def _dump_ids(seg: torch.Tensor, n: int) -> torch.Tensor:
    """Segment ids with -1 sent to the dump row ``n``, as int64."""
    return torch.where(seg >= 0, seg, n).long()


class _ReduceScatterSegments(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axes, n_seg, *args):
        n = len(mesh.devices)
        segs, xs = args[:n], args[n:]
        parts = []
        for seg, x in zip(segs, xs):
            part = torch.zeros((n_seg + 1,) + tuple(x.shape[1:]),
                               dtype=torch.float64, device=x.device)
            part.index_add_(0, _dump_ids(seg, n_seg), x.double())
            parts.append(part[:n_seg])
        outs = [o.to(x.dtype) for o, x in zip(_scatter(parts, mesh, axes, 0),
                                                xs)]
        ctx.save_for_backward(*segs)
        return _saved(ctx, (mesh, axes, n_seg), outs)

    @staticmethod
    def backward(ctx, *gs):
        mesh, axes, n_seg = ctx.args
        segs = ctx.saved_tensors
        full = _gather([g.contiguous() for g in _grads(ctx, gs)], mesh, axes,
                       0)
        outs = []
        for f, seg in zip(full, segs):
            pad = torch.cat([f, f.new_zeros((1,) + tuple(f.shape[1:]))])
            outs.append(pad.index_select(0, _dump_ids(seg, n_seg)))
        return (None, None, None, *([None] * len(segs)), *outs)


def _apply(fn, mesh, what, xs, axes, *args):
    """``fn`` on ``xs`` (autograd records nothing where no tensor needs a
    gradient)."""
    xs = list(xs)
    _check(xs, mesh, what)
    axes = _axes(axes)
    groups(mesh, axes)                  # raises on an unknown axis
    return list(fn.apply(mesh, axes, *args, *xs))


def all_gather(xs, mesh: Mesh, axes, dim: int) -> list:
    return _apply(_AllGather, mesh, "all_gather", xs, axes, dim)


def reduce_scatter(xs, mesh: Mesh, axes, dim: int) -> list:
    return _apply(_ReduceScatter, mesh, "reduce_scatter", xs, axes, dim)


def all_reduce(xs, mesh: Mesh, axes) -> list:
    return _apply(_AllReduce, mesh, "all_reduce", xs, axes)


def all_reduce_max(xs, mesh: Mesh, axes) -> list:
    xs = [x.detach() for x in xs]
    _check(xs, mesh, "all_reduce_max")
    return _reduce(xs, mesh, _axes(axes), torch.maximum)


def all_to_all(xs, mesh: Mesh, axes, split_dim: int,
               concat_dim: int) -> list:
    return _apply(_AllToAll, mesh, "all_to_all", xs, axes, split_dim,
                  concat_dim)


def permute_chunks(xs, mesh: Mesh, axes, split_dim: int, concat_dim: int,
                   routes) -> list:
    """Within each group over ``axes``, rank ``r``'s result is the chunks
    ``routes[r]`` names — ``(source rank, chunk index)`` pairs, each
    source's tensor cut into ``len(routes[r])`` equal chunks along
    ``split_dim`` — concatenated along ``concat_dim`` in that order. The
    routing must take every chunk of the group exactly once; backward
    sends each chunk's gradient back by the inverse routing."""
    routes = tuple(tuple((int(s), int(j)) for s, j in r) for r in routes)
    g = len(groups(mesh, _axes(axes))[0])
    c = len(routes[0]) if routes else 0
    taken = sorted(p for r in routes for p in r)
    if len(routes) != g or any(len(r) != c for r in routes) \
            or taken != [(s, j) for s in range(g) for j in range(c)]:
        raise ValueError(f"permute_chunks: routes {routes} do not take each "
                         f"of the {g} ranks' chunks exactly once, the same "
                         f"number to each rank")
    return _apply(_PermuteChunks, mesh, "permute_chunks", xs, axes,
                  split_dim, concat_dim, routes)


def copy_to(xs, mesh: Mesh, axes) -> list:
    return _apply(_CopyTo, mesh, "copy_to", xs, axes)


def all_gather_rows(xs, mesh: Mesh, axes, *idxs) -> tuple:
    """Each entry's rows of the all-gathered ``xs`` (dim 0, rank order) at
    each of ``idxs`` (per-entry int64 row indices in range): one list per
    index set. One all-gather forward; backward each entry's gradients
    scatter-added in f64, the partials reduce-scattered in f64 and
    rounded once to the rows' dtype."""
    xs, n = list(xs), len(mesh.devices)
    _check(xs, mesh, "all_gather_rows")
    axes = _axes(axes)
    groups(mesh, axes)
    flat = []
    for idx in idxs:
        idx = list(idx)
        _check(idx, mesh, "all_gather_rows (indices)")
        flat += idx
    outs = _GatherRows.apply(mesh, axes, len(idxs), *flat, *xs)
    return tuple(list(outs[i * n:(i + 1) * n]) for i in range(len(idxs)))


def reduce_scatter_segments(xs, mesh: Mesh, axes, segs, n_seg: int) -> list:
    """Each rank's block of the ``n_seg`` segment sums of every entry's
    rows ``xs`` at segment ids ``segs`` (-1 dropped): f64 partials,
    reduce-scattered in f64 over ``axes`` and rounded once to the rows'
    dtype."""
    xs, segs = list(xs), list(segs)
    _check(xs, mesh, "reduce_scatter_segments")
    _check(segs, mesh, "reduce_scatter_segments (segment ids)")
    axes = _axes(axes)
    groups(mesh, axes)
    return list(_ReduceScatterSegments.apply(mesh, axes, n_seg, *segs, *xs))
