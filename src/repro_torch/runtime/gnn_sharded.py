"""Partition-aware GNN aggregation over SDP's blocked layout (the port's
counterpart of ``repro.runtime.gnn_sharded``).

The JAX package runs one block per device under ``shard_map`` and
all-gathers each layer's published boundary rows. Here all P blocks live
on one device as a leading axis, ``(P, Nb, F)``: the all-gather becomes an
index into the stacked ``(P, B_max, F)`` published rows, and each shard's
local edge list an index into the flattened ``[own block ++ halo]``
buffers. A layer is then a fixed handful of ops whatever P is. Blocks on
distinct cards come with the training mesh (ROADMAP A18.4).
"""
from __future__ import annotations

import torch

from repro_torch.models.gnn import common as C


def halo_index(publish_idx, halo_map, senders, receivers,
               block_size: int) -> dict:
    """The stacked layout's flat indices, made once per layout:

    * ``pub`` (P·B_max,): each published row's index into the flat
      ``(P·Nb, F)`` blocks, ``pub_ok`` its mask;
    * ``halo`` (P·H_max,): each halo row's index into the flat published
      rows, ``halo_ok`` its mask;
    * ``snd`` / ``rcv`` (P·E_max,): each edge's sender in the flat
      ``(P·(Nb + H_max), F)`` buffers and receiver in the flat blocks,
      -1 where padded.
    """
    p, b = publish_idx.shape
    h = halo_map.shape[1]
    nb = block_size
    shard = torch.arange(p, device=publish_idx.device)[:, None]
    hs, hp = halo_map[..., 0], halo_map[..., 1]
    return {
        "pub": (shard * nb + publish_idx.clamp(min=0)).reshape(-1).long(),
        "pub_ok": (publish_idx >= 0).reshape(-1, 1),
        "halo": (hs.clamp(min=0) * b + hp.clamp(min=0)).reshape(-1).long(),
        "halo_ok": (hs >= 0).reshape(-1, 1),
        "snd": torch.where(senders >= 0, shard * (nb + h) + senders,
                           -1).reshape(-1),
        "rcv": torch.where(receivers >= 0, shard * nb + receivers,
                           -1).reshape(-1),
        "shape": (p, nb, h),
    }


def exchange(x_flat, idx: dict):
    """(P·Nb, F) blocks → (P·(Nb + H_max), F) buffers: each block followed
    by its halo rows, read from the published rows of their owners."""
    p, nb, h = idx["shape"]
    pub = torch.where(idx["pub_ok"], C.gather_rows(x_flat, idx["pub"]), 0.0)
    halo = torch.where(idx["halo_ok"], C.gather_rows(pub, idx["halo"]), 0.0)
    f = x_flat.shape[1:]
    return torch.cat([x_flat.reshape(p, nb, *f), halo.reshape(p, h, *f)],
                     dim=1).reshape(p * (nb + h), *f)


def halo_aggregate(x_blocks, publish_idx, halo_map, senders, receivers, *,
                   block_size: int):
    """x_blocks (P, Nb, F) → aggregated (P, Nb, F): every block's sum over
    its in-edges, remote senders read through the halo."""
    p = x_blocks.shape[0]
    idx = halo_index(publish_idx, halo_map, senders, receivers, block_size)
    buf = exchange(x_blocks.reshape(p * block_size, *x_blocks.shape[2:]), idx)
    snd = idx["snd"]
    msg = torch.where((snd >= 0)[:, None], C.gather_src(buf, snd), 0.0)
    out = C.segment_sum_pad(msg, idx["rcv"], p * block_size)
    return out.reshape(x_blocks.shape)


def naive_aggregate(x, senders, receivers):
    """Baseline: global-id segment-sum over the unblocked graph."""
    n = x.shape[0]
    msg = torch.where((senders >= 0)[:, None], C.gather_src(x, senders), 0.0)
    return C.segment_sum_pad(msg, receivers, n)
