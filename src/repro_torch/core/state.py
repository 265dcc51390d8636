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
call. The repacks (``compact_state``, ``shrink_state``) consume theirs
the same way: the old tier's O(n) tensors are released before they
return, so a tier change never holds two full states and scratch at once.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core.geometry import Geometry, geometry_of
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


def _release(*tensors: torch.Tensor) -> None:
    """Free the storage of consumed tensors now — JAX's donation. The
    caching allocator orders the reuse after the kernels already queued on
    the stream, so the gathers reading them still see their data. Memory
    borrowed from numpy (``state_from_numpy`` on the CPU) is not torch's
    to free and goes with its last reference."""
    for t in tensors:
        if t.untyped_storage().resizable():
            t.untyped_storage().resize_(0)


def _apply_repack(state: PartitionState, keep_idx: torch.Tensor,
                  entry_map: torch.Tensor, geom: Geometry) -> PartitionState:
    """Device half of compact/shrink: gather the kept vertex slots into a
    dense ``(geom.n, geom.max_deg)`` layout and relabel every adjacency
    entry through ``entry_map`` (old slot → new slot, -1 dropped).
    ``keep_idx[new] = old`` (-1 = fresh padding slot). Consumes ``state``:
    its O(n) tensors are released as soon as the gathers have read them,
    so the relabel runs beside the new tier's rows alone."""
    n_old, d_old = state.adj.shape
    d_new = int(geom.max_deg)
    valid = keep_idx >= 0
    src = torch.where(valid, keep_idx, 0)
    present = valid & state.present[src]
    assignment = torch.where(present, state.assignment[src], -1)
    rows = state.adj[src]
    _release(state.assignment, state.present, state.adj)
    rows = (rows[:, :d_new].contiguous() if d_new <= d_old else _pad(
        rows, (rows.shape[0], d_new), -1))
    # scrub: absent slots' rows are stale history (the deletion cores never
    # clear them — ``present`` masks them), and a relabel would dangle them
    live = present[:, None] & (rows >= 0)
    # index_select reads the int32 slots as they are (an indexing
    # expression would first copy them to int64, twice the rows' bytes)
    shape = rows.shape
    rows = entry_map.index_select(0, rows.clamp_(0, n_old - 1).view(-1))
    return state._replace(assignment=assignment, present=present,
                          adj=rows.view(shape).masked_fill_(~live, -1))


def _present_extent(present: torch.Tensor, adj: torch.Tensor):
    """The semantically live content: the keep mask (present slots plus
    every slot a present row references — a deleted neighbour keeps its
    slot, because survivors' rows still name it and a re-add must find the
    same slot) and the used row width of the present rows."""
    keep = present.clone()
    live = (adj >= 0) & present[:, None]
    keep[adj[live].to(torch.int64)] = True
    cols = torch.nonzero(live.any(dim=0))
    width = int(cols[-1]) + 1 if cols.numel() else 1
    return keep, width


def compact_state(state: PartitionState, geom: Geometry | None = None
                  ) -> tuple[PartitionState, np.ndarray]:
    """Dense re-pack of the live vertex slots — the relabelling shrink.

    Keeps every present slot and every slot a present row references,
    packs them in ascending-id order at the front of a ``geom``-sized state
    (default: the tight extent) and relabels the adjacency. Returns
    ``(new_state, perm)`` with ``perm[old_id] = new_id`` (-1 = dropped), a
    host array. Every transition core is invariant under the relabelling
    except the ``hash`` policy (it assigns by raw id) and LDG's capacity
    knob (it reads the allocated ``n``); callers keep the inverse of
    ``perm`` to answer in original ids. Counters pass through; absent
    slots' stale rows are scrubbed. Consumes ``state``."""
    cur = geometry_of(state)
    keep, width = _present_extent(state.present, state.adj)
    keep_idx = torch.nonzero(keep)[:, 0]
    count = int(keep_idx.shape[0])
    tight = Geometry(max(count, 1), width)
    if geom is None:
        geom = tight
    if geom.k_max is not None and int(geom.k_max) != cur.k_max:
        raise ValueError(
            f"compact_state cannot change k_max (state has {cur.k_max}, "
            f"requested {geom.k_max}): partition-slot geometry is "
            "config-pinned — grow it via restore with a larger cfg.k_max")
    if not Geometry(geom.n, geom.max_deg).covers(tight):
        raise ValueError(
            f"live content needs (n={tight.n}, max_deg={tight.max_deg}) "
            f"— {count} slots are present or referenced by a present row "
            f"— but the requested geometry is (n={geom.n}, "
            f"max_deg={geom.max_deg})")
    dev = keep.device
    perm = torch.full((cur.n,), -1, dtype=torch.int32, device=dev)
    perm[keep_idx] = torch.arange(count, dtype=torch.int32, device=dev)
    pad = torch.full((int(geom.n) - count,), -1, dtype=torch.int64,
                     device=dev)
    perm_host = perm.cpu().numpy()
    new = _apply_repack(state, torch.cat([keep_idx, pad]), perm,
                        Geometry(int(geom.n), int(geom.max_deg), cur.k_max))
    return new, perm_host


def shrink_state(state: PartitionState, geom: Geometry) -> PartitionState:
    """Truncate ``state`` to the smaller ``geom`` without relabelling — the
    inverse of ``grow_state``, legal only when the live content fits: no
    present slot, and no entry of a present row, at or beyond ``geom.n``,
    and no present-row entry in columns >= ``geom.max_deg`` (else it
    raises, pointing at ``compact_state``). Absent slots' stale rows are
    scrubbed. ``geom.k_max`` must be None or unchanged. Consumes
    ``state``."""
    cur = geometry_of(state)
    n1, d1 = int(geom.n), int(geom.max_deg)
    if geom.k_max is not None and int(geom.k_max) != cur.k_max:
        raise ValueError(
            f"shrink_state cannot change k_max (state has {cur.k_max}, "
            f"requested {geom.k_max}): partition-slot geometry is "
            "config-pinned")
    if n1 > cur.n:
        raise ValueError(
            f"shrink_state cannot grow n (state has n={cur.n}, requested "
            f"{n1}) — that is grow_state's job")
    keep, width = _present_extent(state.present, state.adj)
    hi = torch.nonzero(state.present)
    top = int(hi[-1]) + 1 if hi.numel() else 1
    kept = torch.nonzero(keep)
    refs_top = int(kept[-1]) + 1 if kept.numel() else 1
    if max(top, refs_top) > n1 or width > d1:
        raise ValueError(
            f"live content reaches (n={max(top, refs_top)}, "
            f"max_deg={width}) — beyond the requested (n={n1}, "
            f"max_deg={d1}); slot ids are preserved by shrink_state, so "
            "re-pack with compact_state to move high slots down first")
    dev = keep.device
    entry_map = torch.cat([
        torch.arange(n1, dtype=torch.int32, device=dev),
        torch.full((cur.n - n1,), -1, dtype=torch.int32, device=dev)])
    return _apply_repack(state, torch.arange(n1, device=dev), entry_map,
                         Geometry(n1, d1, cur.k_max))


def live_extent(state: PartitionState) -> tuple[Geometry, Geometry]:
    """``(packed, prefix)`` — the two tight geometries of the live content:
    ``packed`` is what a dense re-pack needs (kept-slot count × used row
    width), ``prefix`` preserves slot ids (highest kept slot + 1 × the same
    width). Equal ``n`` means truncation already packs densely."""
    k = geometry_of(state).k_max
    keep, width = _present_extent(state.present, state.adj)
    idx = torch.nonzero(keep)
    packed = Geometry(max(int(idx.shape[0]), 1), width, k)
    prefix = Geometry(int(idx[-1]) + 1 if idx.numel() else 1, width, k)
    return packed, prefix


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
