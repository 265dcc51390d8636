"""Event transitions — the port's ONE definition site for SDP's add/delete
transitions, policy dispatch and autoscale hooks (the static-knob path of
``repro.core.transition``).

Two engine paths consume these functions: the faithful per-event loop
(``repro_torch.core.engine``) and the window engines
(``repro_torch.core.windowed``, ``repro_torch.kernels.fused_chooser``).

Port rules that every function here follows:

* **No host syncs.** Nothing reads a tensor back to Python inside the
  engines' loops. Where JAX branches with ``lax.cond``/``lax.switch``, the
  port computes the branch and selects with ``torch.where`` (or gates each
  effect with the branch's predicate) — the values are the same. K-sized
  updates are one-hot arithmetic, so they need no indexing at all.
* **The same f32 arithmetic as XLA on the CPU.** Float scalars enter as
  f32 tensors (``make_knobs``), never as Python numbers a device kernel
  could fold into a reciprocal. The K-reductions of ``load_stats`` are
  summed left to right (``_seq_sum``), the order XLA's CPU reduce uses.
  XLA's CPU backend contracts two multiply-adds into FMAs — the SDP
  guard's ``w_dev - load_dev`` and Fennel's ``scores - cost`` — so the
  port computes exactly those two as single-rounding FMAs (``fma_f32``)
  and every other op unfused. ``torch.sqrt`` of an f32 on the CPU is not
  correctly rounded, so square roots go through f64 (``sqrt_f32``).
* **In-place O(n) writes.** ``assignment``/``present``/``adj`` rows are
  written in place (see ``repro_torch.core.state``); JAX's drop-mode
  scatter to the sentinel row ``n`` becomes a write of the old value.

The pairwise cut-matrix invariant (``PartitionState.cut_matrix``): [p, q]
(p != q) counts present edges between partitions p and q and [p, p]
counts each internal edge of p twice, so row sums equal ``edge_load`` and
the off-diagonal half-sum equals ``cut_edges``. Every core maintains it
incrementally; ``scale_in`` merges it in O(K²).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core import rng
from repro_torch.core.config import EngineConfig, POLICIES
from repro_torch.core.state import PartitionState

_BIG = 2**30
_F32 = torch.float32
_I32 = torch.int32


class EventTrace(NamedTuple):
    """Per-event metric trace (paper captures these at interval boundaries)."""
    total_edges: torch.Tensor
    cut_edges: torch.Tensor
    num_partitions: torch.Tensor
    load_std: torch.Tensor


# ---------------------------------------------------------------------------
# engine knobs
# ---------------------------------------------------------------------------

class Knobs(NamedTuple):
    """Numeric policy/scaling knobs as 0-dim f32 tensors on the engine's
    device. The host arithmetic (products, percentages) happens in Python
    doubles first and is rounded to f32 once, exactly as the JAX package's
    weak-typed constants are."""
    max_cap: torch.Tensor             # Eq. 5 MAXCAP
    scale_in_l: torch.Tensor          # Eq. 6 l = tolerance*MAXCAP/100
    scale_in_dest: torch.Tensor       # Eq. 7 destinationThreshold
    ldg_cap_num: torch.Tensor         # ldg_slack * n (cap = this / k)
    fennel_gamma: torch.Tensor
    fennel_gm1: torch.Tensor          # gamma - 1
    fennel_alpha_scale: torch.Tensor


def knob_values(cfg: EngineConfig, n: int) -> tuple[float, ...]:
    """The seven knob values in ``Knobs`` field order, in Python doubles."""
    return (
        cfg.max_cap,
        cfg.tolerance_param * cfg.max_cap / 100.0,
        cfg.max_cap - cfg.dest_param * cfg.max_cap / 100.0,
        cfg.ldg_slack * n,
        cfg.fennel_gamma,
        cfg.fennel_gamma - 1.0,
        cfg.fennel_alpha_scale,
    )


def make_knobs(cfg: EngineConfig, n: int, device) -> Knobs:
    """Host-side knob derivation shared by every engine path."""
    vals = torch.tensor(knob_values(cfg, n), dtype=_F32, device=device)
    return Knobs(*vals.unbind())


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

def _ar(k: int, device) -> torch.Tensor:
    return torch.arange(k, dtype=_I32, device=device)


def _take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` for a 0-dim index tensor, without reading ``i`` back to
    the host (a 0-dim tensor index would)."""
    return x[i.reshape(1)][0]


def _add_at(x: torch.Tensor, i, val) -> torch.Tensor:
    """``x.at[i].add(val)`` on a K-vector (one-hot, no indexing)."""
    return x + torch.where(_ar(x.shape[0], x.device) == i, val, 0)


def _set_at(x: torch.Tensor, i, val) -> torch.Tensor:
    """``x.at[i].set(val)`` on a K-vector."""
    return torch.where(_ar(x.shape[0], x.device) == i, val, x)


def _add_row_col(cm: torch.Tensor, p, vec) -> torch.Tensor:
    """``cm.at[p, :].add(vec).at[:, p].add(vec)`` (both land on [p, p])."""
    ar = _ar(cm.shape[0], cm.device)
    return (cm + torch.where((ar == p)[:, None], vec[None, :], 0)
            + torch.where((ar == p)[None, :], vec[:, None], 0))


def _add_pair(cm: torch.Tensor, p, q, val) -> torch.Tensor:
    """``cm.at[p, q].add(val).at[q, p].add(val)`` (p == q lands twice)."""
    ar = _ar(cm.shape[0], cm.device)
    rp, rq = (ar == p), (ar == q)
    return (cm + torch.where(rp[:, None] & rq[None, :], val, 0)
            + torch.where(rq[:, None] & rp[None, :], val, 0))


def _seq_sum(x: torch.Tensor) -> torch.Tensor:
    """f32 sum over the last axis, strictly left to right — the order of
    XLA's CPU reduce, which the JAX reference and the CUDA kernels share."""
    s = x[..., 0]
    for j in range(1, x.shape[-1]):
        s = s + x[..., j]
    return s


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once to f32, as a fused multiply-add would.

    The f64 product of two f32 values is exact; the f64 sum is exact up to
    an error term (TwoSum), and rounding the sum to odd when it is inexact
    makes the final rounding to f32 equal to a single rounding of the exact
    value."""
    a64, b64, c64 = a.to(torch.float64), b.to(torch.float64), c.to(torch.float64)
    p = a64 * b64
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    odd = (s.view(torch.int64) & 1) == 1
    away = torch.nextafter(s, torch.copysign(torch.full_like(s, torch.inf), err))
    return torch.where((err != 0) & ~odd, away, s).to(_F32)


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root (XLA's and CUDA's ``sqrtf``): an
    f64 root rounded once to f32 is exact for every f32 input."""
    return torch.sqrt(x.to(torch.float64)).to(_F32)


def neighbor_stats(state: PartitionState, row: torch.Tensor):
    """(scores[k], deg, nb_present, safe_row): affinity of one vertex row.

    scores[k] = |E(v) ∩ P_k| over *present* neighbours (paper Eq. 1).
    """
    valid = row >= 0
    safe_row = torch.where(valid, row, 0)
    nb_present = valid & state.present[safe_row]
    nb_assign = torch.where(nb_present, state.assignment[safe_row], -1)
    k_max = state.edge_load.shape[0]
    onehot = nb_assign[:, None] == _ar(k_max, row.device)[None, :]
    scores = onehot.sum(dim=0, dtype=_I32)
    deg = nb_present.sum(dtype=_I32)
    return scores, deg, nb_present, safe_row


def nth_active(active: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """Index of the i-th active partition, with i taken modulo the active
    count (all-inactive yields 0 — there is no valid answer then)."""
    cnt = active.sum(dtype=_I32)
    i = torch.remainder(i, torch.clamp(cnt, min=1))
    cum = torch.cumsum(active.to(_I32), 0, dtype=_I32) - 1
    return torch.argmax(((cum == i) & active).to(_I32)).to(_I32)


def masked_argmin(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """First index of the minimum of ``x`` over ``mask``."""
    return torch.argmin(torch.where(mask, x, _BIG)).to(_I32)


def load_stats(state):
    """(avg_d, load_dev) over active partitions — Eqs. 2 & 10.

    ``state`` is any carrier of active/edge_load (PartitionState or the
    windowed engine's SmallState)."""
    act = state.active
    load = state.edge_load.to(_F32)
    p = torch.clamp(act.sum(dtype=_I32).to(_F32), min=1.0)
    maxl = torch.where(act, load, -torch.inf).max(dim=-1).values
    minl = torch.where(act, load, torch.inf).min(dim=-1).values
    avg_d = (maxl - minl) / p
    mean = _seq_sum(torch.where(act, load, 0.0)) / p
    dev = load - mean
    var = _seq_sum(torch.where(act, dev * dev, 0.0)) / p
    return avg_d, sqrt_f32(var)


# ---------------------------------------------------------------------------
# policies: choose a partition for an arriving vertex
# ---------------------------------------------------------------------------
#
# Every key-consuming policy draws exactly one random index in
# [0, num_partitions). The key-driven choosers take the event's two
# precomputed random words (``rng.draw_words``) where JAX takes its folded
# key; the ``_at`` twins take the drawn index itself (a ``rand_index_table``
# lookup), which is the fused chooser's seam.

def _affinity_choice_at(state, scores, ridx):
    """Paper Alg. 3 with the random draw precomputed: argmax affinity; tie →
    min load; no overlap → the ``ridx``-th active partition."""
    act = state.active
    s = torch.where(act, scores, -1)
    best = s.max()
    tied = act & (s == best)
    p_tie = masked_argmin(state.edge_load, tied)
    p_rand = nth_active(act, ridx)
    return torch.where(best > 0, p_tie, p_rand)


def _rand_index(state, words) -> torch.Tensor:
    """The ONE random draw any policy makes: an index in
    [0, max(num_partitions, 1))."""
    hi, lo = words
    return rng.randint_words(hi, lo, torch.clamp(state.num_partitions, min=1))


def _affinity_choice(state, scores, words):
    return _affinity_choice_at(state, scores, _rand_index(state, words))


def _sdp_guard_inputs(state):
    avg_d, load_dev = load_stats(state)
    cut = torch.clamp(state.cut_edges.to(_F32), min=1.0)
    ratio = state.total_edges.to(_F32) / cut
    th = fma_f32(ratio, load_dev, -load_dev)   # Eqs. 4 and 3: w_dev - dev
    return avg_d, load_dev, th


def _sdp_text_pick(state, p_aff):
    """§4.2.2 guard around an already-made affinity choice."""
    avg_d, _, th = _sdp_guard_inputs(state)
    p_min = masked_argmin(state.edge_load, state.active)
    guard = (state.num_partitions > 1) & (avg_d > th)
    return torch.where(guard, p_min, p_aff)


def _sdp_alg1_pick(state, p_aff):
    """Alg. 1 listing guard around an already-made affinity choice."""
    _, load_dev, th = _sdp_guard_inputs(state)
    p_min = masked_argmin(state.edge_load, state.active)
    guard = (state.num_partitions > 1) & (load_dev > th)
    return torch.where(guard, p_aff, p_min)


def _choose_sdp_text(state, scores, deg, v, words, kn: Knobs, n: int):
    """§4.2.2 text semantics: imbalance (AVG_d > TH) ⇒ least-loaded."""
    return _sdp_text_pick(state, _affinity_choice(state, scores, words))


def _choose_sdp_alg1(state, scores, deg, v, words, kn: Knobs, n: int):
    """Alg. 1 listing semantics: σ > TH ⇒ affinity path, else least-loaded."""
    return _sdp_alg1_pick(state, _affinity_choice(state, scores, words))


def _choose_ldg(state, scores, deg, v, words, kn: Knobs, n: int):
    k = torch.clamp(state.num_partitions.to(_F32), min=1.0)
    cap = kn.ldg_cap_num / k
    w = 1.0 - state.vertex_count.to(_F32) / cap
    h = scores.to(_F32) * torch.clamp(w, min=0.0)
    h = torch.where(state.active, h, -torch.inf)
    best = h.max()
    tied = state.active & (h >= best - 1e-6)
    return masked_argmin(state.vertex_count, tied)


def _choose_fennel(state, scores, deg, v, words, kn: Knobs, n: int):
    m = state.total_edges.to(_F32) + deg.to(_F32)
    nt = torch.clamp(state.vertex_count.sum(dtype=_I32).to(_F32), min=1.0)
    k = torch.clamp(state.num_partitions.to(_F32), min=1.0)
    alpha = kn.fennel_alpha_scale * sqrt_f32(k) * m / torch.pow(
        nt, torch.full_like(nt, 1.5))
    coef = alpha * kn.fennel_gamma
    vcp = torch.pow(state.vertex_count.to(_F32), kn.fennel_gm1)
    h = torch.where(state.active, fma_f32(-coef, vcp, scores.to(_F32)),
                    -torch.inf)
    best = h.max()
    tied = state.active & (h >= best - 1e-6)
    return masked_argmin(state.vertex_count, tied)


def _choose_hash(state, scores, deg, v, words, kn: Knobs, n: int):
    idx = torch.remainder(v, torch.clamp(state.num_partitions, min=1))
    return nth_active(state.active, idx)


def _choose_random(state, scores, deg, v, words, kn: Knobs, n: int):
    return nth_active(state.active, _rand_index(state, words))


def _choose_greedy(state, scores, deg, v, words, kn: Knobs, n: int):
    return _affinity_choice(state, scores, words)


POLICY_INDEX = {p: i for i, p in enumerate(POLICIES)}


def policy_fns(balance_guard: str):
    """Policy table in POLICIES order."""
    sdp = _choose_sdp_text if balance_guard == "text" else _choose_sdp_alg1
    return (sdp, _choose_ldg, _choose_fennel, _choose_hash, _choose_random,
            _choose_greedy)


def make_chooser(balance_guard: str, policy: str) -> Callable:
    """``choose(state, scores, deg, v, words, kn, n) -> p`` for a static
    policy string (traced policy indices belong to the sweep lanes)."""
    return policy_fns(balance_guard)[POLICY_INDEX[policy]]


def _choose_sdp_text_at(state, scores, deg, v, ridx, kn: Knobs, n: int):
    return _sdp_text_pick(state, _affinity_choice_at(state, scores, ridx))


def _choose_sdp_alg1_at(state, scores, deg, v, ridx, kn: Knobs, n: int):
    return _sdp_alg1_pick(state, _affinity_choice_at(state, scores, ridx))


def _choose_random_at(state, scores, deg, v, ridx, kn: Knobs, n: int):
    return nth_active(state.active, ridx)


def _choose_greedy_at(state, scores, deg, v, ridx, kn: Knobs, n: int):
    return _affinity_choice_at(state, scores, ridx)


def policy_fns_at(balance_guard: str):
    """Table-driven policy table in POLICIES order: each entry takes the
    precomputed random index where ``policy_fns`` takes the event's words.
    ldg/fennel/hash never draw, so they are shared verbatim."""
    sdp = _choose_sdp_text_at if balance_guard == "text" else _choose_sdp_alg1_at
    return (sdp, _choose_ldg, _choose_fennel, _choose_hash, _choose_random_at,
            _choose_greedy_at)


def make_table_chooser(balance_guard: str, policy: str) -> Callable:
    """``choose(state, scores, deg, v, ridx, kn, n) -> p`` — the
    ``make_chooser`` contract with the random words replaced by the drawn
    index ``ridx`` (see ``rand_index_table``)."""
    return policy_fns_at(balance_guard)[POLICY_INDEX[policy]]


def rand_index_table(base_key: torch.Tensor, t0: int, w: int,
                     k_max: int) -> torch.Tensor:
    """(w, k_max) int32 table of the per-slot random draw for every possible
    partition count: ``tab[i, m-1] = randint(fold_in(base_key, t0+i), (),
    0, m)`` — what a chooser reading ``tab[i, num_partitions-1]`` needs to
    reproduce the key-driven engines bit for bit."""
    dev = base_key.device
    hi, lo = rng.draw_words(base_key,
                            t0 + torch.arange(w, dtype=torch.int64, device=dev))
    m = torch.arange(1, k_max + 1, dtype=torch.int64, device=dev)
    return rng.randint_words(hi[:, None], lo[:, None], m[None, :])


# ---------------------------------------------------------------------------
# scaling (§4.2.3)
# ---------------------------------------------------------------------------

def scale_out(state, kn: Knobs, gate=True):
    """Eq. 5: if MAXCAP ≤ |E|/|P|, activate one more partition. ``gate``
    AND-composes an outer condition (this event is an ADD)."""
    p = torch.clamp(state.num_partitions.to(_F32), min=1.0)
    adding_threshold = state.total_edges.to(_F32) / p
    want = (kn.max_cap <= adding_threshold) & gate
    slot_free = ~state.active.all()
    do = want & slot_free
    slot = torch.argmax((~state.active).to(_I32)).to(_I32)  # first inactive
    return state._replace(
        active=state.active | ((_ar(state.active.shape[0], slot.device)
                                == slot) & do),
        num_partitions=state.num_partitions + do.to(_I32),
        scale_events=state.scale_events + do.to(_I32),
        denied_scaleout=state.denied_scaleout + (want & ~slot_free).to(_I32),
    )


def recompute_cut(assignment, present, adj) -> torch.Tensor:
    """Exact cut count from scratch (each undirected edge stored twice in
    adj) — the reference for tests, never on an engine path."""
    valid = adj >= 0
    safe = torch.where(valid, adj, 0)
    nb_present = valid & present[safe]
    both = nb_present & present[:, None]
    diff = assignment[:, None] != assignment[safe]
    return torch.div((both & diff).sum(dtype=_I32), 2,
                     rounding_mode="floor").to(_I32)


def merge_cut_matrix(cut_matrix: torch.Tensor, src, dst) -> torch.Tensor:
    """Fold row/col ``src`` into ``dst`` in O(K²) (the relabel src→dst):
    preserves symmetry and row sums, and the off-diagonal half-sum drops
    by exactly M[src, dst]."""
    ar = _ar(cut_matrix.shape[0], cut_matrix.device)
    row = cut_matrix[src.reshape(1)][0]
    ss = _take(row, src)
    rd, rs = (ar == dst), (ar == src)
    cm = (cut_matrix + torch.where(rd[:, None], row[None, :], 0)
          + torch.where(rd[None, :], row[:, None], 0)
          + torch.where(rd[:, None] & rd[None, :], ss, 0))
    return torch.where(rs[:, None] | rs[None, :], 0, cm)


def scale_in_trigger(small, kn: Knobs):
    """Eqs. 6–8 trigger: (src, dst, do). ``small`` is any state carrying
    active/edge_load/num_partitions."""
    el = small.edge_load
    under = small.active & (el.to(_F32) < kn.scale_in_l)
    n_under = under.sum(dtype=_I32)
    src = masked_argmin(el, small.active)
    mask2 = small.active & (_ar(el.shape[0], el.device) != src)
    dst = masked_argmin(el, mask2)
    fits = (_take(el, src) + _take(el, dst)).to(_F32) <= kn.scale_in_dest
    do = (small.num_partitions > 1) & (n_under >= 2) & fits
    return src, dst, do


def merge_counters(small, src, dst, do):
    """The O(K) half of a scale-in migrate (src folds into dst), selected
    by ``do`` — shared by the faithful engine and both window engines."""
    el, vc = small.edge_load, small.vertex_count

    def fold(x):
        return _set_at(_add_at(x, dst, _take(x, src)), src, 0)

    def sel(a, b):
        return torch.where(do, a, b)

    return small._replace(
        edge_load=sel(fold(el), el),
        vertex_count=sel(fold(vc), vc),
        active=sel(_set_at(small.active, src, False), small.active),
        num_partitions=sel(small.num_partitions - 1, small.num_partitions),
        cut_edges=sel(small.cut_edges
                      - small.cut_matrix[src.reshape(1), dst.reshape(1)][0],
                      small.cut_edges),
        cut_matrix=sel(merge_cut_matrix(small.cut_matrix, src, dst),
                       small.cut_matrix),
        scale_events=sel(small.scale_events + 1, small.scale_events),
    )


def scale_in(state: PartitionState, kn: Knobs, gate=True) -> PartitionState:
    """Eqs. 6–8: if ≥2 machines are under l, migrate the min-load machine
    into the next-least-loaded one (if it fits under
    destinationThreshold). ``gate`` AND-composes an outer condition (this
    event is a DEL_VERTEX). The merged cut comes from the incremental
    pairwise matrix — no adjacency pass."""
    src, dst, do = scale_in_trigger(state, kn)
    do = do & gate
    a = state.assignment
    state = merge_counters(state, src, dst, do)
    return state._replace(assignment=torch.where(do & (a == src), dst, a))


# ---------------------------------------------------------------------------
# event transition cores (shared by every engine path)
# ---------------------------------------------------------------------------
#
# Each core takes the gate of its event branch: with the gate False it
# leaves every value as it was, so applying all three gated cores in turn
# equals the one ``lax.switch`` branch JAX runs.

def _write(x: torch.Tensor, i: torch.Tensor, cond, val) -> None:
    """In place: ``x[i] = where(cond, val, x[i])`` for a 0-dim ``i``
    (``cond`` may be the Python ``True`` of an ungated call)."""
    i1 = i.reshape(1)
    x[i1] = val if cond is True else torch.where(cond, val, x[i1])


def commit_add(state: PartitionState, v, row, p, scores, deg, gate=True):
    """Apply an ADD decision (partition p, scores vs current presence).
    Duplicate adds of a present vertex change nothing but presence."""
    fresh = gate & ~_take(state.present, v)
    _write(state.assignment, v, fresh, p)
    _write(state.present, v, gate, True)
    _write(state.adj, v, fresh, row)
    d = torch.where(fresh, deg, 0)
    sc = torch.where(fresh, scores, 0)
    return state._replace(
        vertex_count=_add_at(state.vertex_count, p, fresh.to(_I32)),
        edge_load=_add_at(state.edge_load + sc, p, d),
        total_edges=state.total_edges + d,
        cut_edges=state.cut_edges + d - _take(sc, p),
        cut_matrix=_add_row_col(state.cut_matrix, p, sc),
    )


def del_vertex_core(state: PartitionState, v, gate=True):
    """Remove vertex v and its incident edges (no scale-in)."""
    was = gate & _take(state.present, v)
    own_row = state.adj[v.reshape(1)][0]
    scores, deg, _, _ = neighbor_stats(state, own_row)
    p = torch.clamp(_take(state.assignment, v), min=0)
    d = torch.where(was, deg, 0)
    sc = torch.where(was, scores, 0)
    _write(state.assignment, v, was, -1)
    _write(state.present, v, gate, False)
    return state._replace(
        vertex_count=_add_at(state.vertex_count, p, -was.to(_I32)),
        edge_load=_add_at(state.edge_load - sc, p, -d),
        total_edges=state.total_edges - d,
        cut_edges=state.cut_edges - (d - _take(sc, p)),
        cut_matrix=_add_row_col(state.cut_matrix, p, -sc),
    )


def del_edge_core(state: PartitionState, v, row, gate=True):
    """Remove edge (v, row[0]) if it exists. The row edits apply whenever
    the branch runs (an absent endpoint's stale row is still cleaned)."""
    u = row[0]
    safe_u = torch.clamp(u, min=0)
    own_row = state.adj[v.reshape(1)][0]
    in_adj = (own_row == u).any() & (u >= 0)
    exists = (gate & _take(state.present, v) & _take(state.present, safe_u)
              & in_adj)
    pv = torch.clamp(_take(state.assignment, v), min=0)
    pu = torch.clamp(_take(state.assignment, safe_u), min=0)
    e = exists.to(_I32)
    cutdec = (exists & (pv != pu)).to(_I32)
    hit = gate & (u >= 0)
    _write(state.adj, v, True, torch.where(hit & (own_row == u), -1, own_row))
    row_u = state.adj[safe_u.reshape(1)][0]    # after write 1 (self-loops)
    _write(state.adj, safe_u, True, torch.where(hit & (row_u == v), -1, row_u))
    return state._replace(
        edge_load=_add_at(_add_at(state.edge_load, pv, -e), pu, -e),
        total_edges=state.total_edges - e,
        cut_edges=state.cut_edges - cutdec,
        cut_matrix=_add_pair(state.cut_matrix, pv, pu, -e),
    )


def merge_slot(small, sc, deg, p, fresh, p_dv, was, pu, exists):
    """The masked counter merge of one window slot from its histogram
    ``(sc, deg)``: a fresh ADD commits to ``p``, a DEL_VERTEX of a present
    vertex removes from ``p_dv``, an existing DEL_EDGE removes the
    (p_dv, pu) edge. A slot holds one event type, so at most one term is
    live and the sum is exact — shared by the journal window and the fused
    chooser's slot step (and mirrored by the CUDA kernel)."""
    d_add = torch.where(fresh, deg, 0)
    sc_a = torch.where(fresh, sc, 0)
    d_dv = torch.where(was, deg, 0)
    sc_d = torch.where(was, sc, 0)
    e = exists.to(_I32)
    cutdec = (exists & (p_dv != pu)).to(_I32)
    el = small.edge_load + sc_a - sc_d
    el = _add_at(_add_at(el, p, d_add), p_dv, -d_dv)
    el = _add_at(_add_at(el, p_dv, -e), pu, -e)
    cm = _add_row_col(small.cut_matrix, p, sc_a)
    cm = _add_pair(_add_row_col(cm, p_dv, -sc_d), p_dv, pu, -e)
    return small._replace(
        vertex_count=_add_at(_add_at(small.vertex_count, p, fresh.to(_I32)),
                             p_dv, -was.to(_I32)),
        edge_load=el,
        total_edges=small.total_edges + d_add - d_dv - e,
        cut_edges=(small.cut_edges + (d_add - _take(sc_a, p))
                   - (d_dv - _take(sc_d, p_dv)) - cutdec),
        cut_matrix=cm,
    )


# ---------------------------------------------------------------------------
# the static-knob transition
# ---------------------------------------------------------------------------

class EventTransition(NamedTuple):
    """Event branches in EVENT_* code order, each ``(state, v, row, words,
    gate) -> state``."""
    apply_add: Callable
    apply_del_vertex: Callable
    apply_del_edge: Callable

    def step(self, state, et, v, row, words):
        """One event: every branch runs gated by its event code (codes are
        clipped to [0, 3] as in JAX; 3 is a no-op pad)."""
        et = torch.clamp(et, 0, 3)
        state = self.apply_add(state, v, row, words, et == 0)
        state = self.apply_del_vertex(state, v, row, words, et == 1)
        return self.apply_del_edge(state, v, row, words, et == 2)


def make_transition(kn: Knobs, n: int, *, balance_guard: str, policy: str,
                    autoscale: bool = False) -> EventTransition:
    """The event branches for one run (the caller resolves ``autoscale =
    cfg.autoscale and policy == "sdp"``)."""
    choose = make_chooser(balance_guard, policy)

    def apply_add(state, v, row, words, gate):
        if autoscale:
            state = scale_out(state, kn, gate)
        scores, deg, _, _ = neighbor_stats(state, row)
        p = choose(state, scores, deg, v, words, kn, n)
        return commit_add(state, v, row, p, scores, deg, gate)

    def apply_del_vertex(state, v, row, words, gate):
        state = del_vertex_core(state, v, gate)
        return scale_in(state, kn, gate) if autoscale else state

    def apply_del_edge(state, v, row, words, gate):
        return del_edge_core(state, v, row, gate)

    return EventTransition(apply_add, apply_del_vertex, apply_del_edge)


def scan_events(step_fn: Callable, state: PartitionState,
                etype: torch.Tensor, vertex: torch.Tensor, nbrs: torch.Tensor,
                t0: int) -> tuple[PartitionState, EventTrace]:
    """The faithful per-event loop: event ``t0 + i`` draws from
    ``fold_in(state.key, t0 + i)`` (all draws precomputed in one batch) and
    the trace records the counters and Eq. 10 deviation after it."""
    T = etype.shape[0]
    hi, lo = rng.draw_words(
        state.key, t0 + torch.arange(T, dtype=torch.int64, device=etype.device))
    sv = torch.clamp(vertex, min=0)
    rows = []
    for i in range(T):
        state = step_fn(state, etype[i], sv[i], nbrs[i], (hi[i], lo[i]))
        _, load_dev = load_stats(state)
        rows.append((state.total_edges, state.cut_edges,
                     state.num_partitions, load_dev))
    if not rows:
        z = torch.zeros((0,), dtype=_I32, device=etype.device)
        return state, EventTrace(z, z, z, z.to(_F32))
    return state, EventTrace(*(torch.stack(c) for c in zip(*rows)))
