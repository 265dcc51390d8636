"""The two-tower model's per-entry program on a (data [x pod], model) mesh:
what XLA's SPMD partitioner makes of the JAX package's recsys steps under
``launch.steps._recsys_param_shardings`` (``steps.py:484-497``), written
out on the port's mesh with every collective an explicit call of
``runtime.collectives``.

**Layout.** Each embedding table is row-sharded: over ``model`` under the
``baseline`` scheme (each row block replicated over the data axes), over
every axis under ``opt`` (no copies). The towers are replicated.

**The bag across row blocks.** An entry looks up only the ids that fall in
its rows: those ids shifted into the block, every other id set to -1, then
the ``embedding_bag`` CUDA kernel in ``sum`` mode on the block (its
``mean`` mode would count only the block's valid ids). The partial bags
are summed over the table's row axes, then divided by the sample's global
count of valid ids, ``max(#(id >= 0), 1)``, as ``embedding_bag_ref``
divides. Where the ids are split over some of the table's row axes
(``opt``: the data axes; a serving batch split over every axis), an
entry's rows must serve every rank's ids there: the ids are
``all_gather``\\ ed over those axes first, the partial bags summed over the
other row axes by ``all_reduce`` (``model`` under ``opt``), and each
sample's sum sent back to the ranks that own it by ``reduce_scatter``
over the gathering axes. Under ``baseline`` with the batch on the data
axes the ids are not split over ``model``, so one ``all_reduce`` over
``model`` sums the bags.

**The backward** (``kernels.embedding_bag.ops.bag_lookup`` in ``sum``
mode): ``embedding_bag_backward`` on the block's shifted ids, fed the bag
gradient already divided by the global count — the order of JAX's
``_bwd`` — so a block's table gradient is bit-equal to the plain
backward of the same gradient. A block replicated over the data axes
passes through ``copy_to`` over them: its gradient sums every data
rank's (under ``baseline`` the dense table gradient's all-reduce, the
step's largest collective).

**The loss.** In-batch softmax over the global batch: the item
embeddings and ``log_q`` are all-gathered over the data axes, so each
data rank's logits are its ``B / n_dp`` rows x ``B`` columns, ``log_q``
correcting each column; the per-row NLL and the in-batch hits are summed
over the data axes and divided by ``B``.

**The optimizer** (``launch.steps``): the towers' copies pass through
``copy_to`` (their gradients summed over every axis: the data ranks'
contributions, the model ranks' zeros), AdamW runs on each entry's shards,
and ``gnorm`` is ``mesh_ctx.global_norm`` (each replicated leaf counted
once).

**Serving.** ``serve_score`` returns each entry's scores of its block of
the pairs; ``score_candidates`` each entry's ``(B, Nc / n_dev)`` columns,
the candidates split over every axis.

A bag summed per block and then across blocks in rank order is not
bit-equal to one slot-ordered sum: a sharded step agrees with the
one-card step to a tolerance, never bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.embedding_bag.ops import bag_lookup
from repro_torch.launch.mesh import PartitionSpec as P
from repro_torch.models import layers as L
from repro_torch.runtime import collectives as C
from repro_torch.runtime.mesh_ctx import MeshCtx, local_params


class Ctx(MeshCtx):
    """A mesh, a two-tower config and the scheme's table layout: the rows
    over ``model``, or over every axis under ``opt``."""

    def __init__(self, mesh, cfg, scheme: str = "baseline"):
        rows = tuple(mesh.axis_names) if scheme == "opt" else ("model",)
        super().__init__(mesh, [(r"table", P(rows, None)), (r".*", P())])
        self.cfg, self.rows = cfg, rows


def _block_ids(ctx: Ctx, ids: torch.Tensor, rows: int, e: int):
    """``ids`` as indices into entry ``e``'s row block of ``rows`` rows:
    shifted, and -1 where the id lies in another block (or is -1)."""
    local = ids.long() - ctx.rank(ctx.rows, e) * rows
    keep = (ids >= 0) & (local >= 0) & (local < rows)
    return torch.where(keep, local, -1).to(torch.int32)


def bags(ctx: Ctx, tables: list, ids: list, id_axes: tuple) -> list:
    """Each entry's mean bags ``(b, d)`` of its ``(b, S)`` ids, the table
    split over ``ctx.rows`` and the ids over ``id_axes``."""
    mesh = ctx.mesh
    spread = tuple(a for a in ctx.axes if a in ctx.rows and a in id_axes)
    summed = tuple(a for a in ctx.rows if a not in spread)
    looked = C.all_gather(ids, mesh, spread, 0) \
        if ctx.size(spread) > 1 else list(ids)
    parts = [bag_lookup(t, _block_ids(ctx, i, t.shape[0], e), "sum")
             for e, (t, i) in enumerate(zip(tables, looked))]
    if ctx.size(summed) > 1:
        parts = C.all_reduce(parts, mesh, summed)
    if ctx.size(spread) > 1:
        parts = C.reduce_scatter(parts, mesh, spread, 0)
    out = []
    for p, i in zip(parts, ids):
        cnt = (i >= 0).sum(dim=1, keepdim=True, dtype=torch.int32)
        out.append(p / torch.clamp(cnt, min=1).to(torch.float32))
    return out


def tower(ctx: Ctx, params: list, ids: list, which: str,
          id_axes: tuple) -> list:
    """Each entry's L2-normalised ``(b, out)`` tower embeddings."""
    fields = ctx.cfg.user_fields if which == "user" else ctx.cfg.item_fields
    flat = [i.reshape(i.shape[0] * fields, -1) for i in ids]
    bs = bags(ctx, [p[f"{which}_table"] for p in params], flat, id_axes)
    out = []
    for p, b, i in zip(params, bs, ids):
        x = L.mlp_apply(p[f"{which}_tower"], b.reshape(i.shape[0], -1),
                        act=torch.relu)
        norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
        out.append(x / torch.clamp(norm, min=1e-6))
    return out


def _data_gather(ctx: Ctx, xs: list) -> list:
    return C.all_gather(xs, ctx.mesh, ctx.da, 0) if ctx.n_dp > 1 \
        else list(xs)


def _data_sum(ctx: Ctx, xs: list) -> list:
    return C.all_reduce(xs, ctx.mesh, ctx.da) if ctx.n_dp > 1 else list(xs)


def loss(ctx: Ctx, params: list, batch: dict, global_batch: int):
    """Each entry's copy of ``(loss, {"xent", "in_batch_acc"})``: the
    in-batch sampled softmax with logQ correction over the global batch,
    the batch on the data axes (``params`` one tree an entry, passed
    through ``mesh_ctx.local_params``)."""
    cfg, da = ctx.cfg, ctx.da
    params = local_params(ctx, params)
    u = tower(ctx, params, batch["user_ids"], "user", da)
    v = _data_gather(ctx, tower(ctx, params, batch["item_ids"], "item", da))
    log_q = _data_gather(ctx, batch["log_q"])
    nll, hits = [], []
    for e, (ue, ve, lq) in enumerate(zip(u, v, log_q)):
        logits = (ue @ ve.T) / cfg.temperature               # (b, B)
        logits = logits - lq[None, :]
        rows = ctx.entry_slice(da, global_batch, e)
        labels = torch.arange(rows.start, rows.stop, device=ue.device)
        lse = torch.logsumexp(logits.float(), dim=-1)
        ll = torch.gather(logits.float(), -1, labels[:, None])[:, 0]
        nll.append(torch.sum(lse - ll))
        hits.append(torch.sum((torch.argmax(logits, -1) == labels).float()))
    nll = _data_sum(ctx, nll)
    hits = _data_sum(ctx, [h.detach() for h in hits])
    losses, acc = [], []
    for s, h in zip(nll, hits):
        n = torch.full((), float(global_batch), dtype=torch.float32,
                       device=s.device)
        losses.append(s / n)
        acc.append(h / n)
    return losses, {"xent": losses, "in_batch_acc": acc}


def serve_score(ctx: Ctx, params: list, batch: dict, id_axes: tuple) -> list:
    """Each entry's ``(b,)`` scores of its (user, item) pairs, the pairs
    split over ``id_axes``."""
    u = tower(ctx, params, batch["user_ids"], "user", id_axes)
    v = tower(ctx, params, batch["item_ids"], "item", id_axes)
    return [torch.sum(a * b, dim=-1) / ctx.cfg.temperature
            for a, b in zip(u, v)]


def score_candidates(ctx: Ctx, params: list, batch: dict) -> list:
    """Each entry's ``(B, Nc / n_dev)`` scores: every query (replicated)
    against its block of the candidate corpus."""
    u = tower(ctx, params, batch["user_ids"], "user", ())
    return [a @ c.T / ctx.cfg.temperature
            for a, c in zip(u, batch["cand_item_emb"])]
