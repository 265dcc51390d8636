"""Timing of ``csrc/fused_chooser.cu``'s two kernels at one shape on the card.

    PYTHONPATH=src python -m repro_torch.kernels.fused_chooser.sweep

Takes the streaming session's window at (W, D, K) = (256, 192, 16) —
twitter at scale 0.03 degree-capped to 192, its churn stream, 768 events
through the port's plain window engines — and launches both kernels on
it: the lanes kernel, which ``dispatch`` picks there, and the large-K
kernel, which takes any K. Checks the large kernel bit-equal to the lanes
kernel for every policy x guard x autoscale; then prints the card's name
and power limit, and one JSON line: each kernel's device time per window
(SDP, text guard, autoscale; CUDA-graph replay), the lanes kernel's once
more after the large one's (the spread of the timing). A development
tool: nothing in the package runs it. Needs one CUDA card.
"""
from __future__ import annotations

import json
import sys

import numpy as np
import torch

from repro_torch.core import transition as tx, windowed as wnd
from repro_torch.core.config import EngineConfig, POLICIES
from repro_torch.core.state import init_state
from repro_torch.graph.csr import cap_degree
from repro_torch.graph.datasets import load_dataset
from repro_torch.graph.stream import (
    EVENT_ADD, interleaved_churn, normalize_rows,
)
from repro_torch.kernels.fused_chooser import fused_chooser as fk
from repro_torch.kernels.fused_chooser import ops as fops
from repro_torch.kernels.sweep import card, graph_ms

# (dataset, scale, degree cap, row width, k_max, max_cap, window, warm
# events) of the streaming session's window, and its churn stream
MAIN = ("twitter", 0.03, 192, 192, 16, 400, 256, 768)
CHURN = dict(warmup_frac=0.2, del_every=3, edge_del_every=5, seed=0)


def window_inputs(dev, name, scale, cap, width, k_max, max_cap, window,
                  warm, churn):
    """``fused_window_choose``'s ten tensor arguments for the window after
    ``warm`` events of ``name``'s churn stream run through the plain window
    engines on ``dev`` (SDP, autoscale), with the config's n and the
    window's event types: a real stream's mid-session shapes."""
    g = load_dataset(name, scale=scale)
    if cap:
        g = cap_degree(g, cap)
    s = interleaved_churn(g, **churn)
    cfg = EngineConfig(k_max=k_max, k_init=1, max_cap=max_cap, autoscale=True)
    et = torch.as_tensor(s.etype).to(dev)
    vx = torch.as_tensor(s.vertex).to(dev)
    nb = torch.as_tensor(normalize_rows(s.nbrs, width)).to(dev)
    state = init_state(s.n, width, k_max, 1, seed=0, device=dev)
    for t in range(0, warm, window):
        sl = slice(t, t + window)
        if np.all(s.etype[sl] == EVENT_ADD):
            state = wnd.run_window_adds(state, vx[sl], nb[sl], t,
                                        policy="sdp", cfg=cfg)
        else:
            state = wnd.run_window_mixed(state, et[sl], vx[sl], nb[sl], t,
                                         policy="sdp", cfg=cfg)
    sl = slice(warm, warm + window)
    n = state.assignment.shape[0]
    prep = fops._prepare_window(type(state)(*(t.clone() for t in state)),
                                et[sl], vx[sl], nb[sl])
    scalars = torch.stack([state.num_partitions, state.total_edges,
                           state.cut_edges, state.denied_scaleout,
                           state.scale_events])
    knobs = torch.tensor(tx.knob_values(cfg, n), dtype=torch.float32,
                         device=dev)
    args = (prep.ev, prep.src_lbl, prep.touch,
            tx.rand_index_table(state.key, warm, window, k_max), state.active,
            state.edge_load, state.vertex_count, state.cut_matrix, scalars,
            knobs)
    return args, n, et[sl]


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("the sweep needs a CUDA card")
    dev = torch.device("cuda", 0)
    args, n, _ = window_inputs(dev, *MAIN, CHURN)
    checked = 0
    for policy in POLICIES:
        for guard in ("text", "alg1"):
            for auto in (True, False):
                kw = dict(policy=policy, balance_guard=guard,
                          autoscaling=auto)
                want = fk.launch("lanes", *args, **kw)
                got = fk.launch("large", *args, **kw)
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError(f"the large kernel differs from the "
                                         f"lanes kernel at {kw}")
                checked += 1
    kw = dict(policy="sdp", balance_guard="text", autoscaling=True)
    times = {kernel: graph_ms(lambda kernel=kernel: fk.launch(
        kernel, *args, **kw), 20) for kernel in fk.KERNELS}
    times["lanes_again"] = graph_ms(lambda: fk.launch("lanes", *args, **kw),
                                    20)
    w, d = args[1].shape
    print(card())
    print(json.dumps({"shape": [w, d, args[3].shape[1]], "n": n,
                      "bit_equal_cases": checked, "ms": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
