"""GNN substrate of the port (the counterpart of
``repro.models.gnn.common``): padded edge-list message passing with
segment ops, the radial bases, and the host-side batch builders.

Edges are (senders, receivers) int32 tensors padded with -1; a padded lane
scatters to a dump row ``n`` that is sliced off, as in the JAX package.
Sums are ``index_add``; max and min are ``scatter_reduce`` with ``amax`` /
``amin`` over a row of ±inf and ``include_self=False``, whose gradient
shares a tie evenly among the tied entries, as JAX's ``segment_max`` does.
The batch builders are numpy and return the JAX package's arrays from the
same seed.

Every scatter-add — a segment sum, and the backward of a row gather —
accumulates in f64 and rounds once to the data's dtype. The card adds
with atomics in no fixed order, and in f32 that order alone moved
MeshGraphNet's node-encoder weight gradient by 1e-4 (relative L2) from
run to run at twitter's size, as much as two partition layouts differ
(H100 80GB HBM3, 700.00 W; PERF.md). In f64 such a sum is exact
or nearly, so its order no longer shows after the rounding: there the
dense model's step repeated bit for bit, and the SDP, hash and dense
layouts agreed within 6e-7.

Every model's ``apply`` reaches its edges through a graph object:
``Local`` here, one device's whole graph, or the mesh program's
(``runtime.gnn_mesh.Graph``: every value a list of per-entry tensors, a
node tensor split over the entries and read at edge endpoints through an
all-gather, segment sums reduce-scattered). The model writes its local
math once, as functions ``graph.map`` applies to each entry's values.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.graph.csr import Graph
from repro_torch.models import layers as L


def _safe(seg_ids, n: int):
    """seg_ids with -1 sent to the dump row ``n``, as int64."""
    return torch.where(seg_ids >= 0, seg_ids, n).long()


def _acc(dtype):
    """The dtype a scatter-add of ``dtype`` data accumulates in."""
    return torch.float64 if dtype.is_floating_point else dtype


def segment_sum_pad(data, seg_ids, n: int):
    """segment_sum where seg_ids == -1 rows are dropped."""
    out = torch.zeros((n + 1,) + tuple(data.shape[1:]), dtype=_acc(
        data.dtype), device=data.device)
    out = out.index_add(0, _safe(seg_ids, n), data.to(out.dtype))
    return out[:n].to(data.dtype)


def _segment_extremum(data, seg_ids, n: int, reduce: str, init: float):
    idx = _safe(seg_ids, n).reshape((-1,) + (1,) * (data.dim() - 1))
    out = data.new_full((n + 1,) + tuple(data.shape[1:]), init)
    out = out.scatter_reduce(0, idx.expand_as(data), data, reduce,
                             include_self=False)
    return out[:n]


def segment_max_pad(data, seg_ids, n: int, fill=-math.inf):
    out = _segment_extremum(data, seg_ids, n, "amax", -math.inf)
    return torch.where(torch.isfinite(out), out, fill)


def segment_min_pad(data, seg_ids, n: int, fill=math.inf):
    out = _segment_extremum(data, seg_ids, n, "amin", math.inf)
    return torch.where(torch.isfinite(out), out, fill)


def segment_mean_pad(data, seg_ids, n: int):
    s = segment_sum_pad(data, seg_ids, n)
    cnt = segment_sum_pad(data.new_ones(tuple(data.shape[:1]) + (1,)),
                          seg_ids, n)
    return s / torch.clamp(cnt, min=1.0)


class _GatherRows(torch.autograd.Function):
    """``x[idx]`` whose backward scatter-adds the rows' gradients in f64."""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.rows = x.shape[0]
        return torch.index_select(x, 0, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        out = torch.zeros((ctx.rows,) + tuple(g.shape[1:]),
                          dtype=_acc(g.dtype), device=g.device)
        return out.index_add_(0, idx, g.to(out.dtype)).to(g.dtype), None


def gather_rows(x, idx):
    """``x[idx]`` for int64 ``idx`` in range."""
    return _GatherRows.apply(x, idx)


def gather_src(x, idx):
    """x[idx] with -1-safe indexing (padded rows read row 0, to be masked)."""
    return gather_rows(x, torch.clamp(idx, min=0).long())


def in_degree(receivers, n: int):
    ones = torch.ones(tuple(receivers.shape) + (1,), dtype=torch.float32,
                      device=receivers.device)
    return segment_sum_pad(ones, receivers, n)[:, 0]


class Local:
    """One device's graph of ``n`` nodes: every value one tensor."""

    def __init__(self, n: int):
        self.n = n

    def map(self, fn, *xs):
        """``fn`` on the values (the mesh applies it to each entry's)."""
        return fn(*xs)

    def gather(self, x, *idxs) -> tuple:
        """Node rows ``x`` read at each edge index set (-1 reads row 0)."""
        return tuple(gather_src(x, i) for i in idxs)

    def sum(self, data, seg_ids):
        return segment_sum_pad(data, seg_ids, self.n)

    def mean(self, data, seg_ids):
        return segment_mean_pad(data, seg_ids, self.n)

    def max(self, data, seg_ids, fill):
        return segment_max_pad(data, seg_ids, self.n, fill=fill)

    def min(self, data, seg_ids, fill):
        return segment_min_pad(data, seg_ids, self.n, fill=fill)

    def degree(self, receivers):
        return in_degree(receivers, self.n)

    def loss(self, per_node, batch):
        return readout_loss(per_node, batch)


# --------------------------------------------------------------------------
# radial bases (schnet / nequip)
# --------------------------------------------------------------------------

def gaussian_rbf(d, n_rbf: int, cutoff: float):
    """SchNet gaussian basis on distances d (E,)."""
    mu = torch.linspace(0.0, cutoff, n_rbf, dtype=torch.float32,
                        device=d.device)
    gamma = (n_rbf / cutoff) ** 2
    return torch.exp(-gamma * (d[:, None] - mu[None, :]) ** 2)


def bessel_rbf(d, n_rbf: int, cutoff: float):
    """NequIP bessel basis with polynomial cutoff envelope."""
    d = torch.clamp(d, min=1e-6)
    n = torch.arange(1, n_rbf + 1, dtype=torch.float32, device=d.device)
    basis = math.sqrt(2.0 / cutoff) * torch.sin(
        n * math.pi * d[:, None] / cutoff) / d[:, None]
    x = torch.clamp(d / cutoff, 0.0, 1.0)
    env = 1.0 - 10.0 * x**3 + 15.0 * x**4 - 6.0 * x**5   # p=3 polynomial
    return basis * env[:, None]


def edge_vectors(positions, senders, receivers, graph=None):
    """(vec (E,3), dist (E,), unit (E,3)) with -1-padded edges zeroed;
    ``graph`` the positions' graph (default: ``Local`` of their rows)."""
    g = graph or Local(positions.shape[0])
    at_rcv, at_snd = g.gather(positions, receivers, senders)
    return g.map(_edge_geometry, at_rcv, at_snd, senders, receivers)


def _edge_geometry(at_rcv, at_snd, senders, receivers):
    mask = (senders >= 0) & (receivers >= 0)
    vec = at_rcv - at_snd
    vec = torch.where(mask[:, None], vec, 0.0)
    dist = torch.linalg.vector_norm(vec + 1e-12, dim=-1)
    unit = vec / torch.clamp(dist, min=1e-6)[:, None]
    return vec, torch.where(mask, dist, 0.0), unit


# --------------------------------------------------------------------------
# host-side batch construction (numpy: the JAX package's arrays)
# --------------------------------------------------------------------------

def graph_to_batch(g: Graph, d_feat: int, *, seed: int = 0,
                   with_positions: bool = False, out_dim: int = 1,
                   dtype=np.float32) -> dict:
    """Full-graph training batch with synthetic features/targets."""
    rng = np.random.default_rng(seed)
    e = g.edge_array()
    senders = np.concatenate([e[:, 0], e[:, 1]]).astype(np.int32)
    receivers = np.concatenate([e[:, 1], e[:, 0]]).astype(np.int32)
    batch = {
        "senders": senders,
        "receivers": receivers,
        "node_feat": rng.standard_normal((g.n, d_feat)).astype(dtype),
        "node_mask": np.ones(g.n, bool),
        "targets": rng.standard_normal((g.n, out_dim)).astype(dtype),
    }
    if with_positions:
        batch["positions"] = rng.standard_normal((g.n, 3)).astype(dtype)
        batch["species"] = rng.integers(0, 16, g.n).astype(np.int32)
    return batch


INDEX_LEAVES = ("senders", "receivers", "graph_id", "publish_idx", "halo_map")


def fit_batch(batch: dict, specs: dict, axis: int = 0) -> dict:
    """A numpy batch padded along ``axis`` (its rows: nodes, edges,
    molecules; a halo batch's axis 1 within each block) to a step bundle's
    batch ``specs``: ``INDEX_LEAVES`` with -1, the rest with 0
    (``node_mask`` False). Raises where a leaf has more rows than its spec
    or differs on another axis: a batch is never cut."""
    out = {}
    for k, sp in specs.items():
        x = np.asarray(batch[k])
        want = tuple(sp.shape)
        if x.ndim != len(want) or x.shape[axis] > want[axis] or \
                x.shape[:axis] + x.shape[axis + 1:] \
                != want[:axis] + want[axis + 1:]:
            raise ValueError(f"the batch's {k} {x.shape} does not fit the "
                             f"bundle's {want}")
        pad = np.full(want, -1 if k in INDEX_LEAVES else 0, dtype=x.dtype)
        pad[(slice(None),) * axis + (slice(0, x.shape[axis]),)] = x
        out[k] = pad
    return out


def batch_molecules(n_mol: int, n_nodes: int, n_edges: int, *, seed: int = 0,
                    d_feat: int = 0, out_dim: int = 1) -> dict:
    """Batched small molecules flattened into one disjoint graph."""
    rng = np.random.default_rng(seed)
    senders, receivers = [], []
    for m in range(n_mol):
        off = m * n_nodes
        u = rng.integers(0, n_nodes, n_edges)
        v = rng.integers(0, n_nodes, n_edges)
        ok = u != v
        senders.append((u[ok] + off))
        receivers.append((v[ok] + off))
    senders = np.concatenate(senders).astype(np.int32)
    receivers = np.concatenate(receivers).astype(np.int32)
    ntot = n_mol * n_nodes
    batch = {
        "senders": senders,
        "receivers": receivers,
        "positions": rng.standard_normal((ntot, 3)).astype(np.float32),
        "species": rng.integers(0, 16, ntot).astype(np.int32),
        "node_mask": np.ones(ntot, bool),
        "graph_id": np.repeat(np.arange(n_mol, dtype=np.int32), n_nodes),
        "targets": rng.standard_normal((n_mol, out_dim)).astype(np.float32),
    }
    if d_feat:
        batch["node_feat"] = rng.standard_normal((ntot, d_feat)).astype(np.float32)
    return batch


# --------------------------------------------------------------------------
# loss and params
# --------------------------------------------------------------------------

def mse_loss(pred, targets, mask=None):
    err = (pred.float() - targets.float()) ** 2
    if mask is not None:
        err = err * mask.float()[:, None]
        return torch.sum(err) / torch.clamp(
            torch.sum(mask.float()) * err.shape[-1], min=1.0)
    return torch.mean(err)


def readout_loss(per_node, batch):
    """Every GNN's ``loss_fn`` tail: per-graph sums against ``targets`` for
    batched molecules (``graph_id``), unmasked; else the per-node MSE under
    ``node_mask``."""
    if "graph_id" in batch:
        n_mol = batch["targets"].shape[0]
        pred = segment_sum_pad(per_node, batch["graph_id"], n_mol)
        loss = mse_loss(pred, batch["targets"])
    else:
        loss = mse_loss(per_node, batch["targets"], batch.get("node_mask"))
    return loss, {"mse": loss}


def leaf_specs(params: dict) -> dict:
    """{leaf path: (shape, dtype)} of a params tree."""
    return {k: (tuple(t.shape), t.dtype) for k, t in L.leaves(params)}
