"""Plain PyTorch version of the fused window chooser: the slot step
(``fused_chooser.make_slot_step``) driven by a Python loop."""
from __future__ import annotations

import torch

from repro_torch.core import transition as tx
from repro_torch.core.windowed import SmallState
from repro_torch.kernels.fused_chooser.fused_chooser import (
    SCAL_CUT, SCAL_DENIED, SCAL_NP, SCAL_SCALE, SCAL_TOTAL, make_slot_step,
)


def fused_window_choose_ref(ev, src_lbl, touch, rand_tab, active, edge_load,
                            vertex_count, cut_matrix, scalars, knobs, *,
                            n: int, policy: str, balance_guard: str,
                            autoscaling: bool):
    """Same signature and outputs as ``fused_chooser.fused_window_choose``,
    on any device."""
    w = ev.shape[0]
    k_max = int(rand_tab.shape[-1])
    kn = tx.Knobs(*knobs.unbind())
    slot_step = make_slot_step(
        k_max=k_max, n=n, autoscaling=autoscaling,
        choose=tx.make_table_chooser(balance_guard, policy))
    small = SmallState(
        active=active != 0, edge_load=edge_load, vertex_count=vertex_count,
        num_partitions=scalars[SCAL_NP], total_edges=scalars[SCAL_TOTAL],
        cut_edges=scalars[SCAL_CUT], denied_scaleout=scalars[SCAL_DENIED],
        scale_events=scalars[SCAL_SCALE], cut_matrix=cut_matrix)
    w_label = torch.full((w,), -1, dtype=torch.int32, device=ev.device)
    remap = torch.arange(k_max, dtype=torch.int32, device=ev.device)
    psel = torch.zeros((w,), dtype=torch.int32, device=ev.device)
    for i in range(w):
        small, w_label, remap, psel[i] = slot_step(
            small, w_label, remap, kn, i, ev[i], src_lbl[i], touch[i],
            rand_tab[i])
    return (w_label, psel, remap, small.active.to(torch.int32),
            torch.stack([small.edge_load, small.vertex_count]),
            small.cut_matrix,
            torch.stack([small.num_partitions, small.total_edges,
                         small.cut_edges, small.denied_scaleout,
                         small.scale_events]))


# ---------------------------------------------------------------------------
# a model of the CUDA kernel's warp reductions
# ---------------------------------------------------------------------------
#
# The kernel keeps partition j on lane j % 32 as entry t = j // 32 of the
# lane's arrays. These functions run its K-wide reductions in that layout,
# step for step, so the CPU tests can hold them against the sequential
# loops of ``repro_torch.core.transition``.

_INT_MAX = 2 ** 31 - 1


def _lanes(x: torch.Tensor, fill) -> torch.Tensor:
    """(KT, 32) layout of a (K,) vector: [t, lane] is partition 32 t +
    lane; entries past K hold ``fill``."""
    k = x.shape[0]
    grid = torch.full((-(-k // 32) * 32,), fill, dtype=x.dtype)
    grid[:k] = x
    return grid.reshape(-1, 32)


def warp_argmin(val: torch.Tensor) -> int:
    """``Lanes::argmin``: each lane keeps its first least entry (t
    ascending, a strict <), lanes without a partition hold (INT_MAX,
    INT_MAX); then the least value over the lanes, and the least index of
    the lanes that hold it."""
    k = val.shape[0]
    v = _lanes(val.to(torch.int64), _INT_MAX).tolist()
    best, idx = [_INT_MAX] * 32, [_INT_MAX] * 32
    for lane in range(32):
        for t in range(len(v)):
            j = 32 * t + lane
            if j < k and (idx[lane] == _INT_MAX or v[t][lane] < best[lane]):
                best[lane], idx[lane] = v[t][lane], j
    m = min(best)                                   # __reduce_min_sync
    return min(i if b == m else _INT_MAX for b, i in zip(best, idx))


def warp_masked_argmin(x: torch.Tensor, mask: torch.Tensor) -> int:
    """``Lanes::masked_argmin``: masked-out entries count as 2^30."""
    return warp_argmin(torch.where(mask, x, 2 ** 30))


def _ballots(active: torch.Tensor) -> list[int]:
    """The active set as the kernel's per-t 32-bit masks."""
    grid = _lanes(active.to(torch.int64), 0).tolist()
    return [sum(bit << lane for lane, bit in enumerate(row)) for row in grid]


def warp_nth_active(active: torch.Tensor, i: int) -> int:
    """``Lanes::nth_active``: i modulo the active count, then the lane whose
    popc prefix of the active mask equals what is left of i (a ballot)."""
    masks = _ballots(active)
    cnt = sum(bin(m).count("1") for m in masks)
    i = i % max(cnt, 1)                             # floor_mod
    found, before = 0, 0
    for t, m in enumerate(masks):
        hits = [lane for lane in range(32) if (m >> lane) & 1
                and before + bin(m & ((1 << lane) - 1)).count("1") == i]
        if hits:
            found = 32 * t + hits[0]                # __ffs of the ballot
        before += bin(m).count("1")
    return found


def warp_affinity_choice(active, scores, edge_load, ridx: int) -> int:
    """``affinity_choice``: the best score over active partitions (a warp
    max), its ties broken by the least load, else the ridx-th active."""
    sv = torch.where(active, scores, -1)
    best = int(sv.max())                            # __reduce_max_sync
    if best <= 0:
        return warp_nth_active(active, ridx)
    return warp_masked_argmin(edge_load, active & (sv == best))


def warp_banded_pick(h, active, vertex_count) -> int:
    """``banded_pick``: a butterfly of fmaxf over the lanes for the best h,
    then the least vertex count within 1e-6 of it among active ones."""
    grid = _lanes(h, float("-inf"))
    lane_best = grid.max(dim=0).values               # each lane's t loop
    for off in (16, 8, 4, 2, 1):                     # __shfl_xor_sync
        lane_best = torch.fmax(lane_best, lane_best[torch.arange(32) ^ off])
    floor_ = lane_best[0] - torch.tensor(1e-6, dtype=torch.float32)
    return warp_masked_argmin(vertex_count, active & (h >= floor_))
