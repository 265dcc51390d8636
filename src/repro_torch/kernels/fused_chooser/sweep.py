"""Timing of ``csrc/fused_chooser.cu``'s kernels at one shape on the card.

    PYTHONPATH=src python -m repro_torch.kernels.fused_chooser.sweep

Takes the streaming session's window at (W, D, K) = (256, 192, 16) —
twitter at scale 0.03 degree-capped to 192, its churn stream, 768 events
through the port's plain window engines — and launches both kernels on
it: the lanes kernel, which ``dispatch`` picks there, and the large-K
kernel, which takes any K; and both pure-ADD kernels (``add_dispatch``)
on the stream's first window, all of whose slots commit. Checks each
large kernel bit-equal to its lanes kernel for every policy x guard x
autoscale; then prints the card's name and power limit, and one JSON
line: each kernel's device time per window (SDP, text guard, autoscale;
CUDA-graph replay), each lanes kernel's once more after the large one's
(the spread of the timing). A development tool: nothing in the package
runs it. Needs one CUDA card. Its window setups (``WINDOW_SETUPS``) and
builders (``window_state``, ``window_inputs``, ``crafted_window``,
``chain_window``, ``add_window_args``) also make the card tests' and
``chip_smoke.py``'s cases of the window kernels.
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
from repro_torch.kernels.partition_affinity.ops import scores_for_state
from repro_torch.kernels.sweep import card, graph_ms

# (dataset, scale, degree cap, row width, k_max, max_cap, window, warm
# events) of the streaming session's window, and its churn stream
MAIN = ("twitter", 0.03, 192, 192, 16, 400, 256, 768)
CHURN = dict(warmup_frac=0.2, del_every=3, edge_del_every=5, seed=0)
# the window kernels' check setups, laid out as MAIN: the session's window,
# grqc's 2,843-wide rows, a window and a row width off every multiple of 32,
# and K = 1, 40, 200 and 1,000
WINDOW_SETUPS = {
    "session": MAIN,
    "grqc_wide": ("grqc", 1.0, 0, 2843, 16, 1500, 256, 1024),
    "odd": ("grqc", 0.05, 37, 37, 5, 60, 100, 200),
    **{f"k{k}": MAIN[:4] + (k,) + MAIN[5:] for k in (1, 40, 200, 1000)},
}


def window_state(dev, name, scale, cap, width, k_max, max_cap, window,
                 warm, churn):
    """The state after ``warm`` events of ``name``'s churn stream run
    through the port's plain window engines on ``dev`` (SDP, autoscale),
    its config, and the stream's (etype, vertex, rows) on ``dev``: a real
    stream's mid-session state."""
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
    return state, cfg, (et, vx, nb)


def window_inputs(dev, name, scale, cap, width, k_max, max_cap, window,
                  warm, churn):
    """``fused_window_choose``'s ten tensor arguments for the window after
    ``warm`` events of ``name``'s churn stream (``window_state``), with the
    config's n and the window's event types."""
    state, cfg, (et, vx, nb) = window_state(
        dev, name, scale, cap, width, k_max, max_cap, window, warm, churn)
    sl = slice(warm, warm + window)
    n = state.assignment.shape[0]
    prep = fops._prepare_window(clone_state(state), et[sl], vx[sl], nb[sl])
    rand_tab = tx.rand_index_table(state.key, warm, window, k_max)
    args = (prep.ev, prep.src_lbl, prep.touch, rand_tab,
            *wnd.small_args(state), tx.knob_tensor(cfg, n, dev))
    return args, n, et[sl]


def clone_state(state):
    """A copy of every leaf (the window engines update O(n) leaves in
    place)."""
    return type(state)(*(t.clone() for t in state))


def crafted_window(state, window: int, seed: int, adds_only: bool = False):
    """A window of (ets, vs, rows) over ``state`` (on its device) that
    holds the cases whose order the window scans must keep: pads; ADDs of
    absent and of present vertices whose rows name the subject itself;
    a vertex added twice; a DEL_VERTEX then a re-ADD of the vertex; an
    existing edge deleted from both endpoints; self-loop DEL_EDGEs, of an
    edge the window added and of a present vertex; DEL_EDGEs of missing
    edges and of no neighbour (-1). ``adds_only`` keeps the pads and the
    ADDs: a pure-ADD window."""
    n, d = state.adj.shape
    rng = np.random.default_rng(seed)
    adj = state.adj.cpu().numpy()
    present = state.present.cpu().numpy()
    pres, absent = np.flatnonzero(present), np.flatnonzero(~present)
    pick = (lambda pool: int(rng.choice(pool)) if len(pool)
            else int(rng.integers(n)))
    slots = []

    def row_of(v):
        r = np.full(d, -1, np.int32)
        k = int(rng.integers(1, d + 1))
        r[:k] = rng.integers(0, n, size=k)
        if rng.random() < 0.3:
            r[int(rng.integers(k))] = v
        return r

    def edge(v, u):
        r = np.full(d, -1, np.int32)
        r[0] = u
        slots.append((2, v, r))

    kinds = 2 if adds_only else 6
    while len(slots) < window:
        kind = int(rng.integers(kinds))
        if kind == 0:                                   # a pad
            slots.append((int(rng.integers(3)), -1, row_of(0)))
        elif kind == 1:                                 # ADDs, one twice
            v = pick(absent) if rng.random() < 0.7 else pick(pres)
            slots.append((0, v, row_of(v)))
            if rng.random() < 0.3:
                slots.append((0, v, row_of(v)))
        elif kind == 2:                                 # DEL_VERTEX, re-ADD
            v = pick(pres) if rng.random() < 0.8 else pick(absent)
            slots.append((1, v, row_of(v)))
            if rng.random() < 0.5:
                slots.append((0, v, row_of(v)))
        elif kind == 3:                                 # both endpoints
            v = pick(pres)
            nbrs = adj[v][adj[v] >= 0]
            u = int(rng.choice(nbrs)) if len(nbrs) else pick(pres)
            edge(v, u)
            edge(u, v)
        elif kind == 4:                                 # self-loops
            x = pick(absent)
            r = row_of(x)
            r[0] = x
            slots.append((0, x, r))
            edge(x, x)
            v = pick(pres)
            edge(v, v)
        else:                                           # missing edges
            edge(pick(pres), int(rng.integers(n)))
            edge(pick(pres), -1)
    slots = slots[:window]
    dev = state.adj.device
    ets = torch.tensor([e for e, _, _ in slots], dtype=torch.int32, device=dev)
    vs = torch.tensor([v for _, v, _ in slots], dtype=torch.int32, device=dev)
    rows = torch.from_numpy(np.stack([r for _, _, r in slots])).to(dev)
    return ets, vs, rows


def chain_window(state, window: int, seed: int, hot: int = 4):
    """A window of (ets, vs, rows) over ``state`` (on its device) whose
    events name only ``hot`` vertices, some present at its start, so each
    of their rows carries a long chain of slots: ADDs whose rows name the
    hot vertices, DEL_VERTEXes, DEL_EDGEs from either end, self-loop
    DEL_EDGEs, DEL_EDGEs of no neighbour (u = -1), and pads."""
    n, d = state.adj.shape
    rng = np.random.default_rng(seed)
    present = state.present.cpu().numpy()
    pres, absent = np.flatnonzero(present), np.flatnonzero(~present)
    pool = [int(rng.choice(p)) if len(p) else int(rng.integers(n))
            for p in (pres, absent) for _ in range(-(-hot // 2))][:hot]
    ets, vs, rows = [], [], []
    for _ in range(window):
        kind = int(rng.integers(6))
        v = pool[int(rng.integers(len(pool)))]
        r = np.full(d, -1, np.int32)
        if kind == 0:                                   # ADD, hot row
            k = int(rng.integers(1, d + 1))
            r[:k] = np.where(rng.random(k) < 0.5,
                             rng.choice(pool, size=k),
                             rng.integers(0, n, size=k))
        elif kind == 2:                                 # DEL_EDGE, hot u
            r[0] = pool[int(rng.integers(len(pool)))]
        elif kind == 3:                                 # self-loop
            r[0] = v
        ets.append(2 if kind in (2, 3, 4) else min(kind, 1))
        vs.append(-1 if kind == 5 else v)
        rows.append(r)
    dev = state.adj.device
    return (torch.tensor(ets, dtype=torch.int32, device=dev),
            torch.tensor(vs, dtype=torch.int32, device=dev),
            torch.from_numpy(np.stack(rows)).to(dev))


def add_window_args(state, cfg, vs, rows, t0: int, score_fn=None):
    """``add_window_choose``'s twelve tensor arguments for the pure-ADD
    window (vs, rows) at event t0 over ``state`` (which it does not
    change)."""
    n = state.assignment.shape[0]
    k_max = state.edge_load.shape[0]
    prep = wnd.prepare_add_window(state, vs, rows, score_fn)
    rand_tab = tx.rand_index_table(state.key, t0, vs.shape[0], k_max)
    return (*prep, vs, rand_tab, *wnd.small_args(state),
            tx.knob_tensor(cfg, n, vs.device))


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
    add_args, add_checked = add_window_first(dev), 0
    for policy in POLICIES:
        for guard in ("text", "alg1"):
            for auto in (True, False):
                akw = dict(policy=policy, balance_guard=guard,
                           autoscaling=auto)
                want = fk.add_launch("lanes", *add_args, **akw)
                got = fk.add_launch("large", *add_args, **akw)
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError(f"the large pure-ADD kernel differs "
                                         f"from the lanes one at {akw}")
                add_checked += 1
    add_times = {kernel: graph_ms(lambda kernel=kernel: fk.add_launch(
        kernel, *add_args, **kw), 20) for kernel in fk.KERNELS}
    add_times["lanes_again"] = graph_ms(
        lambda: fk.add_launch("lanes", *add_args, **kw), 20)
    w, d = args[1].shape
    print(card())
    print(json.dumps({"shape": [w, d, args[3].shape[1]], "n": n,
                      "bit_equal_cases": checked, "ms": times,
                      "add_window_choose": {
                          "window": "first", "fresh": int(add_args[3].sum()),
                          "bit_equal_cases": add_checked,
                          "ms": add_times}}), flush=True)
    return 0


def add_window_first(dev):
    """``add_window_choose``'s arguments for the session's first window
    (MAIN's stream from the empty state; its deletions, none in the
    warm-up, as pads): every one of its 256 slots commits."""
    name, scale, cap, width, k_max, max_cap, window, _ = MAIN
    state, cfg, (et, vx, nb) = window_state(
        dev, name, scale, cap, width, k_max, max_cap, window, 0, CHURN)
    vs = torch.where(et[:window] == EVENT_ADD, vx[:window], -1)
    return add_window_args(state, cfg, vs, nb[:window], 0, scores_for_state)


if __name__ == "__main__":
    sys.exit(main())
