"""Vertex-sharded placement of ``PartitionState`` (the port's counterpart of
``repro.core.sharded_state``).

One session's O(n) leaves — the label journal ``assignment``, the presence
mask and the adjacency rows — are laid out as P equal row blocks along the
"vertices" axis of a mesh (``repro_torch.launch.mesh``), one block on each
entry; every O(K) / O(K²) leaf (loads, active mask, cut matrix), the
scalar counters and the key live once, on the lead device (``devices[0]``).
The state is the same ``PartitionState`` named tuple as a dense session's,
with ``RowBlocks`` for the three row leaves, so ``geometry_of``, the
counters' metrics and checkpoint staging (``np.asarray`` gathers a
``RowBlocks``) work unchanged; the window step itself
(``repro_torch.runtime.shard_session``) works block by block.

Row padding: the row count must divide the mesh; ``shard_state`` pads rows
up to the next multiple with ``grow_state``'s inert fill (absent, -1
rows). Padded rows are semantically absent vertices — no event names an id
at or past the semantic n — so they never enter a counter.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.geometry import Geometry, geometry_of
from repro_torch.core.state import PartitionState, grow_state, state_bytes
from repro_torch.launch.mesh import (
    Mesh, Placement, RowBlocks, gather, place,
)

AXIS = "vertices"
ROW_LEAVES = ("assignment", "present", "adj")


def n_shards(mesh: Mesh) -> int:
    return mesh.shape[AXIS]


def pad_rows(n: int, shards: int) -> int:
    """Smallest multiple of ``shards`` that is >= n (and >= shards)."""
    return max(-(-n // shards), 1) * shards


def is_sharded(state: PartitionState) -> bool:
    return isinstance(state.assignment, RowBlocks)


def state_placements(mesh: Mesh) -> PartitionState:
    """A ``Placement`` per leaf: the row leaves in blocks along
    "vertices", the rest whole on the lead device."""
    return PartitionState(*(Placement(mesh, AXIS if f in ROW_LEAVES
                                      else None)
                            for f in PartitionState._fields))


def shard_state(state: PartitionState, mesh: Mesh) -> PartitionState:
    """Place a dense (or differently sharded) state on ``mesh``, padding the
    rows up to a multiple of the shard count first. Copies: the input is
    left as it was."""
    if is_sharded(state):
        state = unshard_state(state)
    g = geometry_of(state)
    target = pad_rows(g.n, n_shards(mesh))
    if target != g.n:
        state = grow_state(state, Geometry(target, g.max_deg, g.k_max))
    return PartitionState(*(place(x, p) for x, p in
                            zip(state, state_placements(mesh))))


def unshard_state(state: PartitionState, n: int | None = None,
                  device=None) -> PartitionState:
    """The canonical dense layout as ordinary tensors on ``device``
    (default: the lead device), the row padding sliced off when ``n`` (the
    semantic row count) is given — the exact shapes a dense run gives."""
    dev = state.edge_load.device if device is None else torch.device(device)
    out = PartitionState(*(gather(x, dev) for x in state))
    if n is not None and n < out.assignment.shape[0]:
        out = out._replace(assignment=out.assignment[:n],
                           present=out.present[:n], adj=out.adj[:n])
    return out


def gather_state(state: PartitionState,
                 n: int | None = None) -> PartitionState:
    """``unshard_state`` as host numpy arrays — what checkpoints persist, so
    sharded and dense sessions round-trip interchangeably."""
    host = unshard_state(state, n, device="cpu")
    return PartitionState(*(t.numpy().copy() for t in host))


def per_device_state_bytes(state: PartitionState) -> int:
    """Peak resident state bytes on any one mesh entry: each entry pays for
    its own row blocks, and the lead one for every leaf that is not split
    as well. On a dense state this is ``state_bytes``."""
    if not is_sharded(state):
        return state_bytes(state)
    p = len(state.assignment.blocks)
    per = np.zeros(p, np.int64)
    for x in state:
        if isinstance(x, RowBlocks):
            per += [b.numel() * b.element_size() for b in x.blocks]
        else:
            per[0] += x.numel() * x.element_size()
    return int(per.max())
