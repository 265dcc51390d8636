"""Wiring of the window kernels into the window engines.

Pure-ADD window (``run_window_adds_fused``):

  1. ``windowed.prepare_add_window`` — the committed scores (W, K) from the
     ``partition_affinity`` kernel, each row entry's window slot and the
     fresh flags (a few batched torch ops);
  2. the slots' random table: rows of a ``WindowTables`` draw, or one
     ``window_rng`` launch of its own;
  3. ONE ``add_window_choose`` launch for the W slots' fixup;
  4. ``windowed.commit_add_window`` — the O(n) writes.

Mixed window (``run_window_mixed_fused``; see fused_chooser.py for the
design):

  1. ``_prepare_window`` — choice-independent prep: one ``window_prep``
     launch derives presence and touch indices from the event list, emits
     the per-slot scalar rows and the (W, D) committed-label / touch-index
     tables, and performs the faithful adjacency row writes, each touched
     row through its own chain of slots (adjacency never depends on
     partition choices);
  2. the per-slot random draw for every possible partition count: rows of
     a ``WindowTables`` draw, or one ``window_rng`` launch of its own;
  3. ONE ``fused_window_choose`` launch for all W slots;
  4. apply — two O(n) gathers rebuild the final journal from
     (w_label, remap): ``label = w_label[last_touch]`` where touched, else
     ``remap[committed]``.

Sweep lanes (``sweep_window_mixed_fused``): step 1 per lane, ONE
``window_rng`` launch for every lane's table, ONE launch of the chooser's
sweep form for every lane's window, then the apply for all lanes at once.

A window's random table depends only on ``state.key``, the window's first
event index and K (``state.edge_load.shape[0]``): no window engine writes
``state.key`` (the port's window functions and JAX's ``core/windowed.py``
replace every other leaf and carry the key through), and neither does a
rebalance. So a session draws the tables of many consecutive windows in one
launch (``WindowTables``) and hands each window its rows.

Nothing here reads the card back to the host. Each kernel's wrapper runs
its plain version for CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.core import transition as tx
from repro_torch.core import windowed as wnd
from repro_torch.core.config import EngineConfig
from repro_torch.core.geometry import check_row_width
from repro_torch.core.state import PartitionState
from repro_torch.kernels.fused_chooser import fused_chooser as fk
from repro_torch.kernels.fused_chooser.window_prep import (
    prep_max_w, prep_smem_bytes, window_prep,
)
from repro_torch.kernels.partition_affinity.ops import scores_for_state
from repro_torch.kernels.window_rng.ops import window_rng

_prepare_window = window_prep


def check_shape_limits(window: int, k_max: int) -> None:
    """Raise unless the card's window kernels take a window of ``window``
    events over ``k_max`` partition slots: ``window_prep`` up to
    ``prep_max_w()`` slots, the mixed chooser up to ``large_max_k(window)``
    partitions and the pure-ADD fixup up to ``add_max_k(window)``. A card
    session or sweep with ``use_kernel=True`` calls it before any window
    runs; the error names the knob to lower. (The plain versions on the CPU
    have no limit.)"""
    if window > prep_max_w():
        raise ValueError(
            f"window={window} is above the {prep_max_w()} slots the "
            f"window_prep kernel takes ({prep_smem_bytes(window)} bytes of "
            f"shared memory at {window}): lower window to at most "
            f"{prep_max_w()}")
    for what, limit in (("fused_chooser", fk.large_max_k(window)),
                        ("pure-ADD fixup", fk.add_max_k(window))):
        if k_max > limit:
            raise ValueError(
                f"k_max={k_max} is above the {limit} partitions the {what} "
                f"kernel takes at a window of {window}: lower cfg.k_max to "
                f"at most {limit} (or the window)")


def _apply(w_label, remap, last_touch, label0):
    """Step 4: the journal rebuilt from the window-local decisions — two
    O(n) gathers, no scatter ordering to get wrong. ``w_label`` (…, W),
    ``remap`` (…, K), ``last_touch`` and ``label0`` (…, n), for one window
    or, with a leading lane axis, every sweep lane's at once."""
    w = w_label.shape[-1]
    lbl_touched = w_label.gather(-1, torch.clamp(last_touch, 0, w - 1).long())
    lbl_kept = torch.where(
        label0 >= 0, remap.gather(-1, torch.clamp(label0, min=0).long()), -1)
    return torch.where(last_touch >= 0, lbl_touched, lbl_kept)


# the most bytes one multi-window draw holds (K int32 entries a row)
DRAW_BUDGET_BYTES = 64 << 20


def windows_per_draw(window: int, k: int) -> int:
    """How many windows of ``window`` events one draw covers at K = ``k``:
    as many as fit ``DRAW_BUDGET_BYTES``, at least one (4,096 at the twitter
    session's (256, 16), 6 at K = 9,587)."""
    return max(1, DRAW_BUDGET_BYTES // (4 * k * window))


class WindowTables:
    """The random tables of a run of consecutive windows of one session,
    drawn ahead: ``take(state, t)`` gives the (window, K) table of the
    window at global event ``t`` as rows of one ``window_rng`` draw that
    starts at the first window it serves and covers up to
    ``windows_per_draw`` windows, never past ``end`` (the global event
    index after the run's last window). A draw serves later windows while
    the state's key tensor and K are the ones it was drawn for and the
    window lies inside it; otherwise ``take`` draws again from ``t``.
    Rows ``[t - start, t - start + window)`` of a table drawn from
    ``start`` are the table ``window_rng(key, t, window, K)`` bit for bit
    (a row depends only on its own event index)."""

    def __init__(self, window: int, end: int):
        self.window, self.end = int(window), int(end)
        self._tab = self._key = None
        self._start = self._rows = self._k = 0

    def take(self, state: PartitionState, t: int) -> torch.Tensor:
        k = state.edge_load.shape[0]
        w = self.window
        if (self._tab is None or state.key is not self._key or k != self._k
                or not self._start <= t <= self._start + self._rows - w):
            windows = min(windows_per_draw(w, k),
                          max(1, -(-(self.end - t) // w)))
            self._tab = window_rng(state.key, t, windows * w, k)
            self._key, self._k = state.key, k
            self._start, self._rows = t, windows * w
        return self._tab[t - self._start:t - self._start + w]


def _fused_lane(state: PartitionState, ets, vs, rows, t0: int, knobs, *,
                policy: str, balance_guard: str, autoscaling: bool,
                rand_tab: torch.Tensor | None = None) -> PartitionState:
    """One mixed window through prep → rand table → kernel → apply."""
    w = vs.shape[0]
    prep = _prepare_window(state, ets, vs, rows)
    if rand_tab is None:
        rand_tab = window_rng(state.key, t0, w, state.edge_load.shape[0])
    w_label, _psel, remap, *small_out = fk.fused_window_choose(
        prep.ev, prep.src_lbl, prep.touch, rand_tab, *wnd.small_args(state),
        knobs, n=state.assignment.shape[0], policy=policy,
        balance_guard=balance_guard, autoscaling=autoscaling)
    label_final = _apply(w_label, remap, prep.last_touch, prep.label0)
    return wnd.with_small_outputs(state, *small_out, assignment=label_final,
                                  present=label_final >= 0, adj=prep.adj)


def run_window_mixed_fused(state: PartitionState, ets, vs, rows, t0: int,
                           *, policy: str, cfg: EngineConfig,
                           knobs: torch.Tensor | None = None,
                           rand_tab: torch.Tensor | None = None
                           ) -> PartitionState:
    """Drop-in for ``windowed.run_window_mixed`` (static knob),
    bit-identical to the faithful engine. ``knobs`` is
    ``transition.knob_tensor(cfg, n, device)``, made here when not given;
    ``rand_tab`` the window's (W, K) random table (``WindowTables.take``),
    drawn here when not given."""
    check_row_width(state, rows)
    if knobs is None:
        knobs = tx.knob_tensor(cfg, state.assignment.shape[0], vs.device)
    return _fused_lane(state, ets, vs, rows, t0, knobs, policy=policy,
                       balance_guard=cfg.balance_guard,
                       autoscaling=policy == "sdp" and cfg.autoscale,
                       rand_tab=rand_tab)


def run_window_adds_fused(state: PartitionState, vs, rows, t0: int, *,
                          policy: str, cfg: EngineConfig,
                          knobs: torch.Tensor | None = None,
                          rand_tab: torch.Tensor | None = None
                          ) -> PartitionState:
    """Drop-in for ``windowed.run_window_adds`` through the kernels
    (``partition_affinity``, ``window_rng`` unless ``rand_tab`` is given,
    ``add_window_choose``), bit-identical to the faithful engine."""
    check_row_width(state, rows)
    n = state.assignment.shape[0]
    if knobs is None:
        knobs = tx.knob_tensor(cfg, n, vs.device)
    prep = wnd.prepare_add_window(state, vs, rows, scores_for_state)
    if rand_tab is None:
        rand_tab = window_rng(state.key, t0, vs.shape[0],
                              state.edge_load.shape[0])
    out = fk.add_window_choose(
        *prep, vs, rand_tab, *wnd.small_args(state), knobs, n=n,
        policy=policy, balance_guard=cfg.balance_guard,
        autoscaling=policy == "sdp" and cfg.autoscale)
    return wnd.commit_add_window(state, vs, rows, *out)


def _stacked_small(states) -> tuple:
    """The lanes' O(K) counter slices stacked on a leading lane axis, as
    ``fused_window_choose_lanes`` takes them: (active, edge_load,
    vertex_count, cut_matrix, scalars (L, 5))."""
    def stack(f):
        return torch.stack([getattr(st, f) for st in states])
    return (stack("active"), stack("edge_load"), stack("vertex_count"),
            stack("cut_matrix"),
            torch.stack([stack(f) for f in wnd._SCALARS], dim=1))


def sweep_window_mixed_fused(states: list, kns: torch.Tensor, policy_idx,
                             autoscale, ets, vs, rows, t0: int, *,
                             balance_guard: str, autoscale_mode: str,
                             window: int = 256,
                             shared_stream: bool = False) -> list:
    """Drop-in for ``windowed.sweep_window_mixed`` through the kernels, the
    port's ``sweep_window_mixed_fused``: per window step, every lane's
    ``window_prep`` (a launch each, on the lane's own state), ONE
    ``window_rng`` launch for every lane's table (the lanes' keys stacked
    once: no window writes a key), then ONE launch of the chooser's sweep
    form (``fused_window_choose_lanes``) for all lanes, each lane under its
    own policy and scale gate (``flags``), then the apply for all lanes at
    once: two batched gathers rebuild every lane's journal. Nothing reads
    the card back to the host. Bit-identical per lane to
    ``sweep_window_mixed``."""
    check_row_width(states[0], rows)
    starts = wnd.window_starts(ets.shape[-1], window)
    dev = kns.device
    n = states[0].assignment.shape[0]
    k = states[0].edge_load.shape[0]
    autos = wnd.lane_autoscaling(policy_idx, autoscale, autoscale_mode)
    flags = torch.tensor([[int(p), int(a)] for p, a in zip(policy_idx, autos)],
                         dtype=torch.int32, device=dev)
    lanes = [tuple(wnd.lane_events(x, b, shared_stream)
                   for x in (ets, vs, rows)) for b in range(len(states))]
    keys = torch.stack([st.key for st in states])
    for i0 in starts:
        sl = slice(i0, i0 + window)
        preps = [_prepare_window(st, et_b[sl], vs_b[sl], rows_b[sl])
                 for st, (et_b, vs_b, rows_b) in zip(states, lanes)]
        rand_tab = window_rng(keys, t0 + i0, window, k)
        w_label, _psel, remap, active, loads, cut_matrix, scalars = \
            fk.fused_window_choose_lanes(
                *(torch.stack([getattr(p, f) for p in preps])
                  for f in ("ev", "src_lbl", "touch")),
                rand_tab, *_stacked_small(states), kns, flags, n=n,
                balance_guard=balance_guard,
                dynamic=autoscale_mode == "dynamic")
        label_final = _apply(
            w_label, remap, torch.stack([p.last_touch for p in preps]),
            torch.stack([p.label0 for p in preps]))
        present = label_final >= 0
        states = [wnd.with_small_outputs(
            st, active[b], loads[b], cut_matrix[b], scalars[b],
            assignment=label_final[b], present=present[b], adj=p.adj)
            for b, (st, p) in enumerate(zip(states, preps))]
    return states
