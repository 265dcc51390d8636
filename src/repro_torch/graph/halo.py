"""SDP partition → blocked GNN layout (the port's copy of
``repro.graph.halo``): block relabelling + halo indices.

Given an assignment of nodes to P partitions:

  * nodes are relabelled so each shard owns one padded block (Nb rows);
  * each shard "publishes" the boundary rows other shards need (B_max
    slots, padded);
  * every shard's halo is described as (source_shard, publish_slot) pairs;
  * per-shard local edge lists index [own block ++ halo buffer].

A layer's exchange is then one gather of (B_max, F) published rows per
shard — its volume is proportional to max-boundary size, i.e. to the
edge-cut SDP minimises. The hash-partition baseline yields B_max ≈ all
touched nodes; SDP collapses it.

``build_halo_spec`` returns the JAX package's arrays byte for byte. The
JAX body walks every directed edge in Python twice; this one is
vectorised: a slot is a rank in first-appearance order, taken from
``np.unique``'s first indices.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graph.csr import Graph


@dataclasses.dataclass(frozen=True)
class HaloSpec:
    perm: np.ndarray          # (n,) old → position inside its block
    block_of: np.ndarray      # (n,) owning shard
    block_size: int           # Nb (max padded block)
    n_shards: int
    publish_idx: np.ndarray   # (P, B_max) local rows each shard publishes (-1 pad)
    halo_map: np.ndarray      # (P, H_max, 2) (src_shard, publish_slot) (-1 pad)
    senders: np.ndarray       # (P, E_max) local src in [0, Nb+H_max) (-1 pad)
    receivers: np.ndarray     # (P, E_max) local dst in [0, Nb) (-1 pad)

    @property
    def halo_size(self) -> int:
        return int(self.halo_map.shape[1])

    @property
    def publish_size(self) -> int:
        return int(self.publish_idx.shape[1])

    def collective_bytes_per_layer(self, feat_dim: int,
                                   bytes_per_el: int = 4) -> int:
        """All-gather volume per message-passing layer, per device:
        every shard receives (P-1) × B_max × F remote elements."""
        return (self.n_shards - 1) * self.publish_size * feat_dim * bytes_per_el


def _rank_in_group(group: np.ndarray, p: int) -> np.ndarray:
    """For items in order, each one's index among the earlier items of its
    group (group ids in [0, p))."""
    order = np.argsort(group, kind="stable")
    start = np.concatenate([[0], np.cumsum(np.bincount(group, minlength=p))])
    rank = np.empty(group.shape[0], dtype=np.int64)
    rank[order] = np.arange(group.shape[0]) - start[group[order]]
    return rank


def _first_appearance(keys: np.ndarray):
    """(distinct keys in first-appearance order, each key's index into
    them)."""
    uniq, first, inverse = np.unique(keys, return_index=True,
                                     return_inverse=True)
    order = np.argsort(first, kind="stable")
    pos = np.empty(uniq.shape[0], dtype=np.int64)
    pos[order] = np.arange(uniq.shape[0])
    return uniq[order], pos[inverse.reshape(-1)]


def build_halo_spec(g: Graph, assignment: np.ndarray, p: int) -> HaloSpec:
    assignment = np.asarray(assignment)
    n = g.n
    own = assignment.astype(np.int64)
    # --- block relabelling: rank among the lower ids of the same shard ----
    counts = np.bincount(own, minlength=p)
    nb = int(counts.max())
    local_idx = _rank_in_group(own, p)

    edges = g.edge_array()
    u, v = edges[:, 0], edges[:, 1]
    # both directions: aggregation dst-owned
    src = np.concatenate([u, v]).astype(np.int64)
    dst = np.concatenate([v, u]).astype(np.int64)
    s_own, d_own = own[src], own[dst]
    cross = s_own != d_own

    # --- publish sets: each shard's rows others need, by first appearance
    pub_v, _ = _first_appearance(src[cross])
    pub_owner = own[pub_v]
    pub_slot = _rank_in_group(pub_owner, p)
    slot_of = np.zeros(n, dtype=np.int64)         # global → publish slot
    slot_of[pub_v] = pub_slot
    b_max = int(np.bincount(pub_owner, minlength=p).max(initial=0)) or 1

    # --- halo sets: per user shard, the remote sources by first appearance
    halo_keys, key_pos = _first_appearance(d_own[cross] * n + src[cross])
    halo_user, halo_v = halo_keys // n, halo_keys % n
    halo_slot = _rank_in_group(halo_user, p)
    h_max = int(np.bincount(halo_user, minlength=p).max(initial=0)) or 1

    publish_idx = -np.ones((p, b_max), dtype=np.int32)
    publish_idx[pub_owner, pub_slot] = local_idx[pub_v]
    halo_map = -np.ones((p, h_max, 2), dtype=np.int32)
    halo_map[halo_user, halo_slot, 0] = own[halo_v]
    halo_map[halo_user, halo_slot, 1] = slot_of[halo_v]

    # --- per-shard local edge lists, in edge order ----------------------
    s_loc = local_idx[src]
    s_loc[cross] = nb + halo_slot[key_pos]
    e_slot = _rank_in_group(d_own, p)
    e_max = int(np.bincount(d_own, minlength=p).max(initial=0)) or 1
    senders = -np.ones((p, e_max), dtype=np.int32)
    receivers = -np.ones((p, e_max), dtype=np.int32)
    senders[d_own, e_slot] = s_loc
    receivers[d_own, e_slot] = local_idx[dst]

    return HaloSpec(
        perm=local_idx.astype(np.int32),
        block_of=assignment.astype(np.int32),
        block_size=nb, n_shards=p,
        publish_idx=publish_idx, halo_map=halo_map,
        senders=senders, receivers=receivers,
    )


def scatter_nodes(spec: HaloSpec, x: np.ndarray, fill=0.0) -> np.ndarray:
    """(n, F) global node array → (P, Nb, F) blocked layout."""
    out = np.full((spec.n_shards, spec.block_size) + x.shape[1:], fill,
                  dtype=x.dtype)
    out[spec.block_of, spec.perm] = x
    return out


def gather_nodes(spec: HaloSpec, blocks: np.ndarray) -> np.ndarray:
    """(P, Nb, F) blocked → (n, F) global order."""
    return blocks[spec.block_of, spec.perm]
