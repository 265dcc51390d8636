"""SDP-partitioned full-graph MeshGraphNet training over the blocked layout
(the port's counterpart of ``repro.runtime.gnn_halo_train``).

The SDP assignment blocks nodes per shard (``repro_torch.graph.halo``),
and each message-passing layer reads remote senders only through the
published boundary rows, whose volume is proportional to the edge-cut SDP
minimises. Two programs run it:

* **stacked** (``mgn_halo_local_loss``): all P blocks on one device
  (``gnn_sharded``); the JAX package's two ``psum``s of the loss become
  sums over the stacked blocks, and autograd over all of them gives the
  summed gradients that ``shard_map``'s transpose inserts there;
* **on the mesh** (``mgn_halo_mesh_loss``, ``launch.steps.
  build_gnn_halo``'s step): one block per mesh entry, entry ``i`` holding
  block ``i`` of the ``(P, ...)`` batch leaves. A layer's exchange is one
  ``all_gather`` of each entry's ``(B_max, F)`` published rows over every
  axis (``collectives.all_gather_rows``, whose backward reduce-scatters
  the gradient sums that ``shard_map``'s transpose inserts), each entry
  reading its halo rows from the gathered ``(P·B_max, F)``; segment sums
  stay within the block; the loss's numerator and denominator are summed
  over every axis. MeshGraphNet's ``apply`` runs on it through
  :class:`HaloGraph`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.graph.halo import scatter_nodes

from repro_torch.models import layers as L
from repro_torch.models.gnn import common as C
from repro_torch.models.gnn import meshgraphnet as MGN
from repro_torch.models.gnn.meshgraphnet import MGNConfig, _block, run_layers
from repro_torch.runtime import collectives as CL
from repro_torch.runtime import gnn_mesh as GM
from repro_torch.runtime.mesh_ctx import MeshCtx, local_params
from repro_torch.runtime.gnn_sharded import exchange, halo_index


def mgn_halo_local_loss(params, batch, cfg: MGNConfig, *, block_size: int):
    """MeshGraphNet's masked MSE over every stacked block.

    batch arrays carry a leading (P,) block dim:
      node_feat (P, Nb, F), targets (P, Nb, out), node_mask (P, Nb),
      publish_idx (P, B_max), halo_map (P, H_max, 2),
      senders/receivers (P, E_max) — senders index [own ++ halo].
    The edge features are ones, as in the JAX package's halo body.
    """
    p = batch["node_feat"].shape[0]
    nb = block_size
    idx = halo_index(batch["publish_idx"], batch["halo_map"],
                     batch["senders"], batch["receivers"], nb)
    snd, rcv = idx["snd"], idx["rcv"]
    emask = (snd >= 0)[:, None]

    h = _block(params["enc_node"],
               batch["node_feat"].reshape(p * nb, -1))       # (P·Nb, D)
    efeat = torch.ones((snd.shape[0], 4), dtype=h.dtype, device=h.device)
    e = _block(params["enc_edge"], efeat)                    # (P·E, D)

    def step(lp, h, e):
        hs = C.gather_src(exchange(h, idx), snd)
        hr = C.gather_src(h, rcv)
        e_new = _block(lp["edge"], torch.cat([e, hs, hr], -1))
        e = e + torch.where(emask, e_new, 0.0)
        agg = C.segment_sum_pad(e, rcv, p * nb)
        h_new = _block(lp["node"], torch.cat([h, agg], -1))
        return h + h_new, e

    h = run_layers(step, params, cfg, h, e, C.Local(p * nb))
    pred = L.mlp_apply(params["dec"]["mlp"], h)

    mask = batch["node_mask"].reshape(-1, 1).float()
    err = ((pred - batch["targets"].reshape(pred.shape)) ** 2) * mask
    num = torch.sum(err)
    den = torch.sum(mask) * pred.shape[-1]
    return num / torch.clamp(den, min=1.0)


def make_mgn_halo_loss(cfg: MGNConfig, block_size: int):
    """Returns ``loss_fn(params, batch, cfg)`` → ``(loss, {"mse": loss})``
    over the stacked blocks."""

    def loss_fn(params, batch, _cfg=None):
        loss = mgn_halo_local_loss(params, batch, cfg, block_size=block_size)
        return loss, {"mse": loss}

    return loss_fn


def halo_batch(spec, node_feat, targets, node_mask=None) -> dict:
    """The stacked numpy batch of ``mgn_halo_local_loss`` from global
    ``(n, ·)`` node arrays and a ``HaloSpec``; ``node_mask`` (n,) defaults
    to every node (pad rows are masked either way)."""
    mask = np.ones(node_feat.shape[0], bool) if node_mask is None \
        else node_mask
    return {"node_feat": scatter_nodes(spec, node_feat),
            "targets": scatter_nodes(spec, targets),
            "node_mask": scatter_nodes(spec, mask, fill=False),
            "publish_idx": spec.publish_idx, "halo_map": spec.halo_map,
            "senders": spec.senders, "receivers": spec.receivers}


class HaloGraph(GM.MeshGraph):
    """MeshGraphNet's graph over the blocked layout on the mesh: entry
    ``i`` holds block ``i``; a node tensor is read at its edges' senders
    in ``[own block ++ halo]`` after the exchange, and summed into the
    block's own rows (``batch``: each leaf's per-entry block, its leading
    dim of one dropped)."""

    def __init__(self, ctx: MeshCtx, batch: dict, block_size: int):
        super().__init__(ctx, block_size * ctx.n)
        self.nb = block_size
        b_max = batch["publish_idx"][0].shape[0]
        self.pub = [torch.clamp(p, min=0).long() for p in batch["publish_idx"]]
        self.pub_ok = [(p >= 0)[:, None] for p in batch["publish_idx"]]
        self.halo = [(torch.clamp(m[:, 0], min=0) * b_max
                      + torch.clamp(m[:, 1], min=0)).long()
                     for m in batch["halo_map"]]
        self.halo_ok = [(m[:, 0] >= 0)[:, None] for m in batch["halo_map"]]

    def exchange(self, x: list) -> list:
        """Each entry's ``[own block ++ halo rows]``."""
        pub = [torch.where(ok, C.gather_rows(h, i), 0.0)
               for h, i, ok in zip(x, self.pub, self.pub_ok)]
        (halo,) = CL.all_gather_rows(pub, self.mesh, self.axes, self.halo)
        return [torch.cat([h, torch.where(ok, r, 0.0)])
                for h, r, ok in zip(x, halo, self.halo_ok)]

    def gather(self, x, *idxs) -> tuple:
        buf = self.exchange(x)
        return tuple([C.gather_src(b, i) for b, i in zip(buf, idx)]
                     for idx in idxs)

    def sum(self, data, seg_ids):
        return [C.segment_sum_pad(d, s, self.nb) for d, s in zip(data,
                                                                 seg_ids)]


def mgn_halo_mesh_loss(ctx: MeshCtx, cfg: MGNConfig, params: list,
                       batch: dict, block_size: int):
    """Each entry's ``(loss, {"mse": ...})`` of MeshGraphNet's masked MSE
    over the blocked layout, one block an entry: ``params`` one tree an
    entry (the replicated copies), ``batch`` one list of ``(1, ...)``
    blocks a leaf of ``mgn_halo_local_loss``'s batch."""
    blocks = {k: [x[0] for x in v] for k, v in batch.items()}
    g = HaloGraph(ctx, blocks, block_size)
    model_batch = {k: blocks[k] for k in ("node_feat", "targets",
                                          "node_mask", "senders",
                                          "receivers")}
    return MGN.loss_fn(local_params(ctx, params), model_batch, cfg, g)
