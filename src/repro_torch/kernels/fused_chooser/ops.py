"""Wiring of the window kernels into the window engines.

Pure-ADD window (``run_window_adds_fused``):

  1. ``windowed.prepare_add_window`` — the committed scores (W, K) from the
     ``partition_affinity`` kernel, each row entry's window slot and the
     fresh flags (a few batched torch ops);
  2. ``window_rng`` — the slots' random table, one launch;
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
  2. ``window_rng`` — the per-slot random draw for every possible
     partition count, one launch;
  3. ONE ``fused_window_choose`` launch for all W slots;
  4. apply — two O(n) gathers rebuild the final journal from
     (w_label, remap): ``label = w_label[last_touch]`` where touched, else
     ``remap[committed]``.

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
from repro_torch.kernels.fused_chooser.window_prep import window_prep
from repro_torch.kernels.partition_affinity.ops import scores_for_state
from repro_torch.kernels.window_rng.ops import window_rng

_prepare_window = window_prep


def _fused_lane(state: PartitionState, ets, vs, rows, t0: int, knobs, *,
                policy: str, balance_guard: str,
                autoscaling: bool) -> PartitionState:
    """One mixed window through prep → rand table → kernel → apply."""
    w = vs.shape[0]
    prep = _prepare_window(state, ets, vs, rows)
    rand_tab = window_rng(state.key, t0, w, state.edge_load.shape[0])
    w_label, _psel, remap, *small_out = fk.fused_window_choose(
        prep.ev, prep.src_lbl, prep.touch, rand_tab, *wnd.small_args(state),
        knobs, n=state.assignment.shape[0], policy=policy,
        balance_guard=balance_guard, autoscaling=autoscaling)

    # apply: rebuild the journal from the window-local decisions — two
    # O(n) gathers, no scatter ordering to get wrong
    lbl_touched = w_label[torch.clamp(prep.last_touch, 0, w - 1)]
    lbl_kept = torch.where(prep.label0 >= 0,
                           remap[torch.clamp(prep.label0, min=0)], -1)
    label_final = torch.where(prep.last_touch >= 0, lbl_touched, lbl_kept)
    return wnd.with_small_outputs(state, *small_out, assignment=label_final,
                                  present=label_final >= 0, adj=prep.adj)


def run_window_mixed_fused(state: PartitionState, ets, vs, rows, t0: int,
                           *, policy: str, cfg: EngineConfig,
                           knobs: torch.Tensor | None = None
                           ) -> PartitionState:
    """Drop-in for ``windowed.run_window_mixed`` (static knob),
    bit-identical to the faithful engine. ``knobs`` is
    ``transition.knob_tensor(cfg, n, device)``, made here when not given."""
    check_row_width(state, rows)
    if knobs is None:
        knobs = tx.knob_tensor(cfg, state.assignment.shape[0], vs.device)
    return _fused_lane(state, ets, vs, rows, t0, knobs, policy=policy,
                       balance_guard=cfg.balance_guard,
                       autoscaling=policy == "sdp" and cfg.autoscale)


def run_window_adds_fused(state: PartitionState, vs, rows, t0: int, *,
                          policy: str, cfg: EngineConfig,
                          knobs: torch.Tensor | None = None
                          ) -> PartitionState:
    """Drop-in for ``windowed.run_window_adds`` through the kernels
    (``partition_affinity``, ``window_rng``, ``add_window_choose``),
    bit-identical to the faithful engine."""
    check_row_width(state, rows)
    n = state.assignment.shape[0]
    if knobs is None:
        knobs = tx.knob_tensor(cfg, n, vs.device)
    prep = wnd.prepare_add_window(state, vs, rows, scores_for_state)
    rand_tab = window_rng(state.key, t0, vs.shape[0],
                          state.edge_load.shape[0])
    out = fk.add_window_choose(
        *prep, vs, rand_tab, *wnd.small_args(state), knobs, n=n,
        policy=policy, balance_guard=cfg.balance_guard,
        autoscaling=policy == "sdp" and cfg.autoscale)
    return wnd.commit_add_window(state, vs, rows, *out)
