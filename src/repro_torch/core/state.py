"""Partition state: the paper's meta-data maps as dense torch tensors (the
port's counterpart of ``repro.core.state``).

partitionInfoMap<p, List<v>>  -> assignment (n,) inverted index
edgeInfoMap<v, List<edges>>   -> adj (n, max_deg) + present (n,)
graph summary (Alg. 2)        -> edge_load / vertex_count / totals

The JAX package's arrays are immutable and its session donates the state
to each feed. The port's engines update the O(n) leaves (``assignment``,
``present``, ``adj``) in place instead, which is what donation buys in
JAX: an engine call consumes the state it is given, and the caller keeps
only the state it returns. Copy (``state_to_numpy``) what must outlive a
call.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core.geometry import Geometry
from repro_torch.core.rng import prng_key


class PartitionState(NamedTuple):
    assignment: torch.Tensor    # (n,) int32, -1 = absent
    present: torch.Tensor       # (n,) bool
    adj: torch.Tensor           # (n, max_deg) int32, -1 padded (symmetric cap)
    edge_load: torch.Tensor     # (k_max,) int32 — paper "load": Σ incident edges
    vertex_count: torch.Tensor  # (k_max,) int32
    active: torch.Tensor        # (k_max,) bool
    num_partitions: torch.Tensor  # () int32
    total_edges: torch.Tensor   # () int32 — present edges
    cut_edges: torch.Tensor     # () int32 — present cut edges
    denied_scaleout: torch.Tensor  # () int32 — scale-outs blocked by k_max
    scale_events: torch.Tensor  # () int32 — scale-out + scale-in events executed
    key: torch.Tensor           # (2,) uint32 threefry key words
    # (k_max, k_max) int32 symmetric pairwise cut counts: [p, q] (p != q) is
    # the number of present edges between partitions p and q; [p, p] counts
    # each internal edge of p twice. Row sums equal edge_load and the
    # off-diagonal half-sum equals cut_edges (see repro_torch.core.transition).
    cut_matrix: torch.Tensor


_DTYPES = (torch.int32, torch.bool, torch.int32, torch.int32, torch.int32,
           torch.bool, torch.int32, torch.int32, torch.int32, torch.int32,
           torch.int32, torch.uint32, torch.int32)


def resolve_device(device=None) -> torch.device:
    """The device rule of every entry point: ``None`` means the CUDA card,
    and asking for CUDA where there is none raises — nothing carries on
    quietly on the CPU. Pass ``device="cpu"`` for the plain versions."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is present — the port runs on the card by "
            "default; pass device='cpu' to run its plain versions on the CPU")
    return dev


def init_state(n: int, max_deg: int, k_max: int, k_init: int, seed: int = 0,
               device=None) -> PartitionState:
    dev = resolve_device(device)

    def scalar(x):
        return torch.tensor(x, dtype=torch.int32, device=dev)

    return PartitionState(
        assignment=torch.full((n,), -1, dtype=torch.int32, device=dev),
        present=torch.zeros((n,), dtype=torch.bool, device=dev),
        adj=torch.full((n, max_deg), -1, dtype=torch.int32, device=dev),
        edge_load=torch.zeros((k_max,), dtype=torch.int32, device=dev),
        vertex_count=torch.zeros((k_max,), dtype=torch.int32, device=dev),
        active=torch.arange(k_max, device=dev) < k_init,
        num_partitions=scalar(k_init),
        total_edges=scalar(0),
        cut_edges=scalar(0),
        denied_scaleout=scalar(0),
        scale_events=scalar(0),
        key=prng_key(seed, dev),
        cut_matrix=torch.zeros((k_max, k_max), dtype=torch.int32, device=dev),
    )


def _pad(x: torch.Tensor, shape, fill) -> torch.Tensor:
    out = torch.full(shape, fill, dtype=x.dtype, device=x.device)
    out[tuple(slice(0, s) for s in x.shape)] = x
    return out


def grow_state(state: PartitionState, geom: Geometry) -> PartitionState:
    """Pad ``state`` to the larger ``geom`` — a semantics no-op: new vertex
    rows are absent, wider rows are -1-padded, and new partition slots are
    inactive with zero counters. Never shrinks. ``geom.k_max=None`` keeps
    the current partition-slot count."""
    n0, d0 = state.adj.shape
    k0 = state.edge_load.shape[0]
    n1, d1 = int(geom.n), int(geom.max_deg)
    k1 = int(geom.k_max) if geom.k_max else int(k0)
    if n1 < n0 or d1 < d0 or k1 < k0:
        raise ValueError(
            f"grow_state cannot shrink: state is (n={n0}, max_deg={d0}, "
            f"k_max={k0}), requested (n={n1}, max_deg={d1}, k_max={k1}) — "
            "build a fresh session for a smaller universe")
    if (n1, d1, k1) == (n0, d0, k0):
        return state
    return state._replace(
        assignment=_pad(state.assignment, (n1,), -1),
        present=_pad(state.present, (n1,), False),
        adj=_pad(state.adj, (n1, d1), -1),
        edge_load=_pad(state.edge_load, (k1,), 0),
        vertex_count=_pad(state.vertex_count, (k1,), 0),
        active=_pad(state.active, (k1,), False),
        cut_matrix=_pad(state.cut_matrix, (k1, k1), 0),
    )


def state_bytes(state: PartitionState) -> int:
    """Total bytes of the state's tensors at its current geometry."""
    return int(sum(t.numel() * t.element_size() for t in state))


def state_from_numpy(leaves: Sequence[np.ndarray], device=None
                     ) -> PartitionState:
    """A state from numpy leaves in ``PartitionState`` field order — how a
    JAX state is carried across (``[np.asarray(x) for x in jax_state]``,
    the key as uint32[2]). The arrays are copied, never shared."""
    dev = resolve_device(device)
    leaves = list(leaves)
    if len(leaves) != len(PartitionState._fields):
        raise ValueError(
            f"expected {len(PartitionState._fields)} leaves in the order "
            f"{PartitionState._fields}, got {len(leaves)}")
    out = []
    for name, leaf, dt in zip(PartitionState._fields, leaves, _DTYPES):
        arr = np.array(leaf, copy=True)
        t = torch.from_numpy(arr)
        if t.dtype != dt:
            raise ValueError(f"leaf {name!r} is {arr.dtype}, expected {dt}")
        out.append(t.to(dev))
    state = PartitionState(*out)
    n, k = state.assignment.shape[0], state.edge_load.shape[0]
    expect = {"present": (n,), "edge_load": (k,), "vertex_count": (k,),
              "active": (k,), "cut_matrix": (k, k), "key": (2,)}
    for name, shape in expect.items():
        if tuple(getattr(state, name).shape) != shape:
            raise ValueError(f"leaf {name!r} has shape "
                             f"{tuple(getattr(state, name).shape)}, expected "
                             f"{shape}")
    if state.adj.ndim != 2 or state.adj.shape[0] != n:
        raise ValueError(f"leaf 'adj' has shape {tuple(state.adj.shape)}, "
                         f"expected ({n}, max_deg)")
    return state


def state_to_numpy(state: PartitionState) -> PartitionState:
    """Host copies of every leaf (the key as uint32[2])."""
    return PartitionState(*(t.detach().cpu().numpy().copy() for t in state))


def recount_cut_matrix(state: PartitionState) -> PartitionState:
    """Rebuild ``cut_matrix`` from (assignment, present, adj)."""
    from repro_torch.core.metrics import recompute_counters
    rec = recompute_counters(
        state.assignment.cpu().numpy(), state.present.cpu().numpy(),
        state.adj.cpu().numpy(), state.edge_load.shape[0])
    return state._replace(cut_matrix=torch.as_tensor(
        rec["cut_matrix"], dtype=torch.int32).to(state.cut_matrix.device))


def state_metrics(s: PartitionState) -> dict:
    """Host-side summary (edge-cut ratio Eq. 9, load imbalance Eq. 10)."""
    from repro_torch.core.metrics import load_imbalance
    imb = load_imbalance(s.edge_load.cpu().numpy(), s.active.cpu().numpy())
    tot = int(s.total_edges)
    cut = int(s.cut_edges)
    return {
        "edge_cut": cut,
        "total_edges": tot,
        "edge_cut_ratio": float(cut / max(tot, 1)),
        "load_imbalance": imb,
        "num_partitions": int(s.num_partitions),
        "denied_scaleout": int(s.denied_scaleout),
        "scale_events": int(s.scale_events),
    }
