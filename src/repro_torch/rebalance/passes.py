"""The two rebalance passes over ``PartitionState`` (the port's copy of
``repro.rebalance.passes``).

Both passes are functions of ``(state, cursor)`` that never advance
``state.key`` or the cursor (a rebalanced session makes the same *event*
decisions as an unrebalanced one), and both keep every counter exact,
``cut_matrix`` included:

* **greedy migration** (xDGP-style): rank every present vertex by its
  move gain from the per-vertex label histogram under an Eq. 10 capacity
  guard, take the top ``m``, and commit them one by one through
  ``transition.migrate_core``, each re-scored against the state the
  earlier commits left — so every committed move has a fresh gain > 0.
* **LPA refinement** (Spinner-style): ``passes`` synchronous sweeps of
  score → candidate → probabilistic capacity acceptance, each followed by
  a from-scratch recount of the counters.

The per-vertex label histogram is ``partition_affinity``'s function over
all ``n`` rows: a session with ``use_kernel=True`` computes it with the
CUDA kernel (its plain version on the CPU), else with the plain version.
No step reads a value back to the host; the passes' only host read is the
exactness check of :func:`rebalance_state`.

Equal to the JAX package bit for bit: the top-m selection orders ties by
index (``jax.lax.top_k``'s order), the cut matrix is an integer
``index_add_``, and the LPA score is computed as XLA's CPU backend does —
unfused ``hist / deg - 0.1 * (load / cap)`` where it picks the candidate,
one FMA where it reads the current label's score (the fusion that gathers
it contracts the multiply-subtract).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import rng
from repro_torch.core import transition as tx
from repro_torch.core.state import PartitionState
from repro_torch.kernels.partition_affinity.ops import gather_labels
from repro_torch.kernels.partition_affinity.partition_affinity import (
    partition_affinity,
)
from repro_torch.kernels.partition_affinity.ref import partition_affinity_ref

# fold_in salt of the LPA acceptance draws: event keys are fold_in(base,
# t0 + i) with non-negative cursors, so one fixed salt up front keeps the
# rebalance's stream apart from every event's
_SALT = 0x5EBA1A7C
_I32, _F32 = torch.int32, torch.float32
# f32 sums of whole numbers (loads, degrees) are exact in any order below
_F32_EXACT = 1 << 24


class RebalanceStats(NamedTuple):
    moved: torch.Tensor       # () int32 — committed greedy migrations
    cut_before: torch.Tensor  # () int32
    cut_after: torch.Tensor   # () int32


def _histograms(state: PartitionState, use_kernel: bool = True):
    """Per-vertex label histogram ``(n, k)`` and live degree ``(n,)`` over
    edges whose two endpoints are present (rows of absent vertices are
    empty) — ``partition_affinity`` over a labels tile of all n rows."""
    labels = gather_labels(state.assignment, state.present, state.adj)
    labels = torch.where(state.present[:, None], labels, -1)
    k = state.edge_load.shape[0]
    if use_kernel:
        return partition_affinity(labels, k_max=k)
    return partition_affinity_ref(labels, k_max=k)


def _dest_cap(state: PartitionState, slack, max_cap):
    """Eq. 10 capacity guard: a destination may not exceed the mean active
    edge load by more than ``slack`` (and never ``max_cap``)."""
    act = state.active
    load = state.edge_load.to(_F32)
    cnt = torch.clamp(act.sum(dtype=_I32), min=1).to(_F32)
    mean = torch.where(act, load, 0.0).sum() / cnt
    one = torch.ones((), dtype=_F32, device=load.device)
    return torch.minimum(torch.maximum(mean * (slack + 1.0), one), max_cap)


def _recount(state: PartitionState, hist, deg) -> PartitionState:
    """Every derived counter from the histograms of the relabelled state
    (presence and adjacency are unchanged, so ``total_edges`` is too):
    ``cut_matrix`` row p sums the histograms of p's vertices — an exact
    integer scatter (rows of unassigned vertices land on a spare row)."""
    k = state.edge_load.shape[0]
    dev = hist.device
    live = state.present & (state.assignment >= 0)
    idx = torch.where(live, state.assignment, k).to(torch.int64)
    cm = torch.zeros((k + 1, k), dtype=_I32, device=dev).index_add_(
        0, idx, hist)[:k]
    count = torch.zeros(k + 1, dtype=_I32, device=dev).index_add_(
        0, idx, torch.ones_like(deg))[:k]
    load = torch.zeros(k + 1, dtype=_I32, device=dev).index_add_(
        0, idx, deg)[:k]
    total = cm.sum(dtype=_I32)
    internal = cm.diagonal().sum(dtype=_I32)
    return state._replace(
        vertex_count=count, edge_load=load, cut_matrix=cm,
        cut_edges=torch.div(total - internal, 2, rounding_mode="floor"))


def _rebuild_counters(state: PartitionState,
                      use_kernel: bool = True) -> PartitionState:
    """From-scratch device recount of the counters after a bulk relabel."""
    hist, deg = _histograms(state, use_kernel)
    return _recount(state, hist, deg)


def _top_m(gain: torch.Tensor, m: int) -> torch.Tensor:
    """Indices of the ``m`` largest gains, largest first and ties by lower
    index (``jax.lax.top_k``'s order), from unique int64 keys — so no
    device's tie order matters."""
    n = gain.shape[0]
    key = (-gain.to(torch.int64)) * n + torch.arange(
        n, dtype=torch.int64, device=gain.device)
    return torch.topk(key, m, largest=False, sorted=True).indices


def _commit(state: PartitionState, v, slack, max_cap, enabled):
    """One greedy commit: re-score ``v`` against the current state and move
    it to its best fitting partition if that strictly beats staying."""
    k = state.edge_load.shape[0]
    stats = tx.neighbor_stats(state, state.adj[v.reshape(1)][0])
    scores, dv = stats[0], stats[1]
    curv = torch.clamp(tx._take(state.assignment, v), 0, k - 1)
    ok = (state.active
          & (state.edge_load.to(_F32) + dv.to(_F32)
             <= _dest_cap(state, slack, max_cap))
          & (tx._ar(k, scores.device) != curv))
    hq = torch.where(ok, scores, -tx._BIG)
    q = torch.argmax(hq).to(_I32)
    do = enabled & (hq.max() > tx._take(scores, curv))
    return tx.migrate_core(state, v, q, gate=do, stats=stats)


def migration_pass(state: PartitionState, *, m: int, slack, max_cap,
                   enabled=True, use_kernel: bool = True):
    """Greedy top-m migration: rank by stale gains (one batched histogram),
    commit each pick against the current state. Returns ``(state,
    moved)``."""
    k = state.edge_load.shape[0]
    hist, deg = _histograms(state, use_kernel)
    cur = torch.clamp(state.assignment, 0, k - 1).to(torch.int64)
    cur_aff = hist.gather(1, cur[:, None])[:, 0]
    cap = _dest_cap(state, slack, max_cap)
    ar = tx._ar(k, hist.device)
    fits = (state.active[None, :]
            & (state.edge_load.to(_F32)[None, :]
               + deg.to(_F32)[:, None] <= cap))
    h = torch.where(fits & (ar[None, :] != cur[:, None]), hist, -tx._BIG)
    gain = torch.where(state.present & (state.assignment >= 0),
                       h.max(dim=1).values - cur_aff, -tx._BIG)
    picks = _top_m(gain, m)
    moved = torch.zeros((), dtype=_I32, device=hist.device)
    for i in range(m):
        state, did = _commit(state, picks[i], slack, max_cap, enabled)
        moved = moved + did.to(_I32)
    return state, moved


def _lpa_sweep(s: PartitionState, key, *, slack, max_cap, balance_weight,
               enabled, use_kernel: bool) -> PartitionState:
    """One synchronous LPA iteration drawing its acceptances from ``key``."""
    k = s.edge_load.shape[0]
    n = s.assignment.shape[0]
    hist, deg = _histograms(s, use_kernel)
    degf = torch.clamp(deg.to(_F32), min=1.0)
    load = s.edge_load.to(_F32)
    cap = _dest_cap(s, slack, max_cap)
    frac = hist.to(_F32) / degf[:, None]
    lc = load / cap
    inf = torch.full((), -torch.inf, dtype=_F32, device=load.device)
    score = torch.where(s.active[None, :], frac - (lc * balance_weight)[None, :],
                        inf)
    cur = torch.clamp(s.assignment, 0, k - 1).to(torch.int64)
    cand = torch.argmax(score, dim=1)
    best = score.gather(1, cand[:, None])[:, 0]
    # the current label's score: XLA's CPU backend contracts this one into
    # an FMA (the candidate's above is unfused)
    cur_sc = tx.fma_f32(lc[cur], -balance_weight,
                        frac.gather(1, cur[:, None])[:, 0])
    cur_sc = torch.where(s.active[cur], cur_sc, inf)
    eps = torch.full((), 1e-6, dtype=_F32, device=load.device)
    want = (s.present & (s.assignment >= 0) & (cand != cur)
            & (best > cur_sc + eps))
    # Spinner's acceptance: movers into label q are admitted with
    # probability remaining(q) / demand(q), so no label overshoots its
    # capacity in expectation
    wdeg = torch.where(want, degf, 0.0)
    demand = torch.zeros(k, dtype=_F32, device=load.device).index_add_(
        0, cand, wdeg)
    remaining = torch.clamp(cap - load, min=0.0)
    p_acc = torch.clamp(remaining / torch.clamp(demand, min=1.0), 0.0, 1.0)
    u = rng.uniform(key, n)
    move = want & (u < p_acc[cand]) & enabled
    s = s._replace(assignment=torch.where(move, cand.to(_I32), s.assignment))
    return _rebuild_counters(s, use_kernel)


def lpa_pass(state: PartitionState, t0: int, *, passes: int, slack, max_cap,
             balance_weight=0.1, enabled=True, use_kernel: bool = True):
    """Spinner-style synchronous LPA: ``passes`` iterations, iteration ``i``
    drawing from ``fold_in(fold_in(key, salt), t0 + i)`` — ``state.key``
    itself never advances. ``balance_weight`` is Spinner's small load
    penalty: the affinity term lives in [0, 1], so 0.1 nudges ties toward
    lighter labels while the acceptance rule enforces the capacity."""
    base = rng.fold_in(state.key, _SALT)
    bw = torch.full((), balance_weight, dtype=_F32, device=state.key.device)
    for i in range(passes):
        state = _lpa_sweep(state, rng.fold_in(base, t0 + i), slack=slack,
                           max_cap=max_cap, balance_weight=bw,
                           enabled=enabled, use_kernel=use_kernel)
    return state


def check_exact(state: PartitionState) -> None:
    """The passes sum whole degrees and loads in f32 (``_dest_cap``'s mean,
    the LPA demand): exact in any order while the sums stay below 2**24.
    Every such sum is at most 2·total_edges + n; refuse a state beyond it
    rather than let a device's summation order show."""
    n = state.assignment.shape[0]
    bound = 2 * int(state.total_edges) + n
    if bound >= _F32_EXACT:
        raise ValueError(
            f"2*total_edges + n = {bound} reaches 2**24: the rebalance's f32 "
            "load and demand sums would no longer be exact in every order")


def rebalance_state(state: PartitionState, t0: int, slack, max_cap,
                    enabled=True, *, m: int, passes: int,
                    use_kernel: bool = True):
    """One full rebalance: greedy migration (if ``m > 0``) then LPA
    refinement (if ``passes > 0``). ``t0`` is the session cursor: passes at
    different stream positions draw distinct acceptances, and a session
    replaying the same cursor draws the same. ``slack`` and ``max_cap`` are
    0-dim f32 tensors on the state's device. Consumes ``state``."""
    check_exact(state)
    cut0 = state.cut_edges.clone()
    moved = torch.zeros((), dtype=_I32, device=cut0.device)
    if m > 0:
        state, moved = migration_pass(state, m=m, slack=slack,
                                      max_cap=max_cap, enabled=enabled,
                                      use_kernel=use_kernel)
    if passes > 0:
        state = lpa_pass(state, t0, passes=passes, slack=slack,
                         max_cap=max_cap, enabled=enabled,
                         use_kernel=use_kernel)
    return state, RebalanceStats(moved, cut0, state.cut_edges)
