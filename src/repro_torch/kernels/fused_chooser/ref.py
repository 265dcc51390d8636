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
