"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc``, holds each
against its plain PyTorch version on the card (bit-equal, no tolerance:
both kernels are exact), runs the streaming session on grqc against the
port's faithful per-event engine, and drives the full-width session —
the paper's largest dataset, twitter at scale 1.0 — through
``Partitioner.feed`` with both kernels on the path. One JSON line per
phase; the last line is ``{"ok": true, "device": {...}}``. Any failure
raises and exits non-zero without that line. Needs one CUDA card; imports
nothing of JAX.
"""
from __future__ import annotations

import functools
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.api.partitioner import Partitioner  # noqa: E402
from repro_torch.core import engine, transition as tx, windowed as wnd  # noqa: E402
from repro_torch.core.config import EngineConfig, POLICIES  # noqa: E402
from repro_torch.core.metrics import recompute_counters  # noqa: E402
from repro_torch.core.state import init_state  # noqa: E402
from repro_torch.graph.csr import cap_degree  # noqa: E402
from repro_torch.graph.datasets import load_dataset  # noqa: E402
from repro_torch.graph.stream import (  # noqa: E402
    EVENT_ADD, VertexStream, interleaved_churn, normalize_rows,
)
from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels.fused_chooser import fused_chooser as fk  # noqa: E402
from repro_torch.kernels.fused_chooser import ops as fops  # noqa: E402
from repro_torch.kernels.fused_chooser.ref import fused_window_choose_ref  # noqa: E402
from repro_torch.kernels.partition_affinity import ops as pops  # noqa: E402
from repro_torch.kernels.partition_affinity import partition_affinity as pa  # noqa: E402
from repro_torch.kernels.partition_affinity.ref import partition_affinity_ref  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
EVENT_ARGS = dict(warmup_frac=0.2, del_every=3, edge_del_every=5, seed=0)
# the full-width session's kernel shapes: a window of 256 events, twitter
# degree-capped to 192 (``Partitioner.from_stream`` sizes the rows to the
# stream's max_deg exactly), 16 partition slots
WINDOW, TWITTER_CAP, K_MAX = 256, 192, 16
SESSION_SHAPE = (WINDOW, TWITTER_CAP, K_MAX)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _elapsed_ms(run) -> float:
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop)


def eager_ms(fn, reps: int) -> float:
    """Time per call of ``fn`` called back to back from Python (CUDA
    events), after one warm-up call: for small kernels this is the host's
    launch rate, not the device's work."""
    fn()
    torch.cuda.synchronize()
    return _elapsed_ms(lambda: [fn() for _ in range(reps)]) / reps


def graph_ms(fn, reps: int, replays: int = 3) -> float:
    """Device time per call of ``fn``: ``reps`` calls captured in one CUDA
    graph and replayed, so no host launch overhead is in the number.
    Capture also proves ``fn`` makes no host sync."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    ms = _elapsed_ms(lambda: [graph.replay() for _ in range(replays)])
    return ms / (reps * replays)


def max_abs_diff(a, b) -> int:
    worst = 0
    for x, y in zip(a, b):
        if x.shape != y.shape or x.dtype != y.dtype:
            raise AssertionError(f"shape/dtype differ: {x.shape} {x.dtype} "
                                 f"vs {y.shape} {y.dtype}")
        if x.numel():
            worst = max(worst, int((x.to(torch.int64) - y.to(torch.int64))
                                   .abs().max()))
    return worst


def clone_state(state):
    return type(state)(*(t.clone() for t in state))


def state_digest(state) -> str:
    """SHA-256 over every leaf's bytes in field order — comparable with a
    digest of the same state from the JAX package (numpy leaves)."""
    h = hashlib.sha256()
    for t in state:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()


def assert_states_equal(a, b, what: str) -> None:
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if x.dtype == torch.uint32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        if x.shape != y.shape or not torch.equal(x, y):
            raise AssertionError(f"{what}: leaf {f!r} differs")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — "
                         "this smoke run needs an NVIDIA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    info = {"phase": "device", "name": torch.cuda.get_device_name(0),
            "capability": list(torch.cuda.get_device_capability(0)),
            "nvidia_smi": smi, "torch": torch.__version__,
            "cuda": torch.version.cuda}
    emit(info)
    return info


def phase_build() -> dict:
    t = time.perf_counter()
    libs = common.build_kernels(["partition_affinity", "fused_chooser"])
    secs = time.perf_counter() - t
    ptxas = {}
    for name, lib in libs.items():
        log = lib.with_suffix(".log")
        ptxas[name] = ([ln.strip() for ln in log.read_text().splitlines()
                        if "registers" in ln or "spill" in ln]
                       if log.exists() else ["(library was already built)"])
    out = {"phase": "build", "seconds": round(secs, 3),
           "libraries": {k: str(v.relative_to(ROOT)) for k, v in libs.items()},
           "ptxas": ptxas}
    emit(out)
    return out


def _warm_state(dev, name, scale, cap, width, k_max, max_cap, window, warm):
    """A mid-stream state of the port's plain window engines on ``dev``
    plus the next window's events — a real churn stream's shapes."""
    g = load_dataset(name, scale=scale)
    if cap:
        g = cap_degree(g, cap)
    s = interleaved_churn(g, **EVENT_ARGS)
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
    return state, cfg, (et[sl], vx[sl], nb[sl]), warm


def phase_kernels(dev) -> dict:
    """Each kernel against its plain version on the card, bit for bit."""
    gen = torch.Generator(device=dev).manual_seed(0)
    pa_out = {"name": "partition_affinity", "cases": []}
    for (w, d, k) in (SESSION_SHAPE, (256, 256, 16), (100, 37, 5), (1, 1, 1)):
        labels = torch.randint(-1, k, (w, d), generator=gen, device=dev,
                               dtype=torch.int32)
        out = pa.partition_affinity(labels, k_max=k)
        torch.cuda.synchronize()
        err = max_abs_diff(out, partition_affinity_ref(labels, k_max=k))
        case = {"shape": [w, d, k], "max_abs_err": err}
        if (w, d, k) == SESSION_SHAPE:
            ones = torch.ones((w, d), dtype=torch.int32, device=dev)
            bins = (labels + 1).to(torch.int64)

            def kernel():
                pa.partition_affinity(labels, k_max=k)

            def plain():
                partition_affinity_ref(labels, k_max=k)

            def library():   # the same histogram in one PyTorch call
                torch.zeros((w, k + 1), dtype=torch.int32, device=dev) \
                    .scatter_add_(1, bins, ones)[:, 1:]

            case["ms"] = graph_ms(kernel, 100)
            case["plain_ms"] = graph_ms(plain, 20)
            case["library_ms"] = graph_ms(library, 100)
            case["eager_ms"] = eager_ms(kernel, 200)
            case["plain_eager_ms"] = eager_ms(plain, 50)
            case["library_eager_ms"] = eager_ms(library, 200)
            case["bound_ms"] = (w * d + w * k + w) * 4 / HBM_BYTES_PER_S * 1e3
        pa_out["cases"].append(case)
        if err:
            raise AssertionError(f"partition_affinity {w}x{d}x{k}: kernel "
                                 f"differs from the plain version by {err}")

    fc_out = {"name": "fused_chooser", "cases": []}
    # (label, dataset, scale, degree cap, row width, k_max, window, warm
    # events, max_cap): the session's shapes (SESSION_SHAPE), a window and
    # width off every multiple of 32, and a single partition slot
    setups = (("main", "twitter", 0.03, TWITTER_CAP, TWITTER_CAP, K_MAX,
               WINDOW, 768, 400),
              ("odd", "grqc", 0.05, 37, 37, 5, 100, 200, 60),
              ("k1", "twitter", 0.03, TWITTER_CAP, TWITTER_CAP, 1, WINDOW,
               768, 400))
    for label, name, scale, cap, width, k_max, window, warm, max_cap in setups:
        state, cfg, (ets, vs, rows), t0 = _warm_state(
            dev, name, scale, cap, width, k_max, max_cap, window, warm)
        n = state.assignment.shape[0]
        prep = fops._prepare_window(clone_state(state), ets, vs, rows)
        rand_tab = tx.rand_index_table(state.key, t0, window, k_max)
        scalars = torch.stack([state.num_partitions, state.total_edges,
                               state.cut_edges, state.denied_scaleout,
                               state.scale_events])
        knobs = torch.tensor(tx.knob_values(cfg, n), dtype=torch.float32,
                             device=dev)
        args = (prep.ev, prep.src_lbl, prep.touch, rand_tab, state.active,
                state.edge_load, state.vertex_count, state.cut_matrix,
                scalars, knobs)
        n_del = int((ets != 0).sum())
        guards = ("text", "alg1")
        for policy in POLICIES:
            for guard in guards:
                for auto in ((True, False) if label == "main" else (True,)):
                    kw = dict(n=n, policy=policy, balance_guard=guard,
                              autoscaling=auto)
                    got = fk.fused_window_choose(*args, **kw)
                    want = fused_window_choose_ref(*args, **kw)
                    torch.cuda.synchronize()
                    err = max_abs_diff(got, want)
                    scale = int(got[6][4] - scalars[4])
                    case = {"case": label, "shape": [window, width, k_max],
                            "policy": policy, "guard": guard,
                            "autoscale": auto, "max_abs_err": err,
                            "scale_events_in_window": scale,
                            "deletions_in_window": n_del}
                    if (label, policy, guard, auto) == ("main", "sdp", "text",
                                                        True):
                        def kernel():
                            fk.fused_window_choose(*args, **kw)

                        def plain():
                            fused_window_choose_ref(*args, **kw)

                        case["ms"] = graph_ms(kernel, 20)
                        case["plain_ms"] = graph_ms(plain, 1, replays=2)
                        case["eager_ms"] = eager_ms(kernel, 20)
                        case["plain_eager_ms"] = eager_ms(plain, 1)
                        w, d, k = window, width, k_max
                        nbytes = 4 * (w * fk.EV_COLS + 2 * w * d + w * k
                                      + 3 * k + k * k + fk.SCAL_N + 7
                                      + 2 * w + 4 * k + k * k + fk.SCAL_N)
                        case["bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
                    fc_out["cases"].append(case)
                    if err:
                        raise AssertionError(
                            f"fused_chooser {label} {policy}/{guard}/"
                            f"autoscale={auto}: kernel differs from the plain "
                            f"version by {err}")
    out = {"phase": "kernels", "partition_affinity": pa_out,
           "fused_chooser": fc_out}
    emit(out)
    return out


def _session(stream, cfg, dev, window, chunks=None):
    part = Partitioner.from_stream(stream, cfg, policy="sdp", seed=0,
                                   use_kernel=True, window=window, device=dev)
    T = stream.num_events
    bounds = [0] + sorted(set(c for c in (chunks or []) if 0 < c < T)) + [T]
    for a, b in zip(bounds[:-1], bounds[1:]):
        part.feed((stream.etype[a:b], stream.vertex[a:b], stream.nbrs[a:b]))
    part.sync()
    return part


def _scaling(state, k_init) -> dict:
    ev = int(state.scale_events)
    npart = int(state.num_partitions)
    scale_in = (ev - (npart - k_init)) // 2
    return {"scale_events": ev, "scale_outs": ev - scale_in,
            "scale_ins": scale_in, "num_partitions": npart}


def _reset_launches():
    pa.partition_affinity.launches = 0
    fk.fused_window_choose.launches = 0


def _read_launches() -> dict:
    return {"partition_affinity": pa.partition_affinity.launches,
            "fused_chooser": fk.fused_window_choose.launches}


def phase_grqc(dev) -> dict:
    """The session with both kernels against the port's faithful engine."""
    s = interleaved_churn(load_dataset("grqc"), **EVENT_ARGS)
    cfg = EngineConfig(k_max=16, k_init=1, max_cap=1500, autoscale=True)
    t = time.perf_counter()
    ref, _ = engine.run_stream(s, policy="sdp", cfg=cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    t_ref = time.perf_counter() - t
    T = s.num_events
    chunks = [1, 7, 300, 301, 1000, 2500, T // 2 + 3, T - 5]
    _reset_launches()
    t = time.perf_counter()
    part = _session(s, cfg, dev, 256, chunks)
    t_part = time.perf_counter() - t
    launches = _read_launches()
    assert_states_equal(part.state, ref, "grqc session vs faithful engine")
    if min(launches.values()) < 1:
        raise AssertionError(f"grqc session missed a kernel: {launches}")
    m = part.metrics()
    out = {"phase": "grqc", "n": s.n, "events": T, "max_deg": s.max_deg,
           "max_cap": cfg.max_cap, "bit_equal": True,
           "state_sha256": state_digest(part.state),
           **_scaling(part.state, cfg.k_init),
           "kernel_windows": m["kernel_windows"],
           "fallback_windows": m["fallback_windows"], "launches": launches,
           "faithful_s": round(t_ref, 3), "session_s": round(t_part, 3)}
    emit(out)
    return out


class _Split:
    """Wall-clock split of a session's stages: wraps module functions with
    synchronized timers (host and device both finish inside each span)."""

    def __init__(self):
        self.seconds: dict[str, float] = {}
        self._undo = []

    def wrap(self, module, attr, label):
        fn = getattr(module, attr)

        @functools.wraps(fn)      # keeps a wrapper's launch counter in reach
        def timed(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = fn(*a, **kw)
            torch.cuda.synchronize()
            self.seconds[label] = (self.seconds.get(label, 0.0)
                                   + time.perf_counter() - t)
            return r

        setattr(module, attr, timed)
        self._undo.append((module, attr, fn))

    def restore(self):
        for module, attr, fn in reversed(self._undo):
            setattr(module, attr, fn)


def phase_twitter(dev) -> dict:
    """The full-width session: twitter at scale 1.0, degree-capped to 192
    as the JAX package's benchmarks do, the interleaved churn stream."""

    t = time.perf_counter()
    g = cap_degree(load_dataset("twitter", scale=1.0), TWITTER_CAP)
    s = interleaved_churn(g, **EVENT_ARGS)
    setup_s = time.perf_counter() - t
    counts = {"add": int((s.etype == 0).sum()),
              "del_vertex": int((s.etype == 1).sum()),
              "del_edge": int((s.etype == 2).sum())}
    cfg = EngineConfig(k_max=K_MAX, k_init=1, max_cap=40000, autoscale=True)

    torch.cuda.reset_peak_memory_stats(dev)
    _reset_launches()
    t = time.perf_counter()
    part = _session(s, cfg, dev, WINDOW)
    run_s = time.perf_counter() - t
    launches = _read_launches()
    if min(launches.values()) < 1:
        raise AssertionError(f"twitter session missed a kernel: {launches}")
    shape = (WINDOW, part.max_deg, cfg.k_max)
    if shape != SESSION_SHAPE:
        raise AssertionError(f"twitter session ran its kernels at (W, D, K) = "
                             f"{shape}, phase kernels timed {SESSION_SHAPE}")
    peak = torch.cuda.max_memory_allocated(dev)
    st = part.state
    k_max = st.edge_load.shape[0]
    rec = recompute_counters(st.assignment.cpu().numpy(),
                             st.present.cpu().numpy(), st.adj.cpu().numpy(),
                             k_max)
    for key in ("edge_load", "vertex_count", "cut_matrix"):
        if not np.array_equal(rec[key], getattr(st, key).cpu().numpy()):
            raise AssertionError(f"twitter: {key} disagrees with the "
                                 "from-scratch recount")
    for key in ("total_edges", "cut_edges"):
        if rec[key] != int(getattr(st, key)):
            raise AssertionError(f"twitter: {key} disagrees with the "
                                 "from-scratch recount")
    m = part.metrics()

    # wall-time split over a prefix of the same stream, every stage timed
    # with synchronizes around it (which is why it is a separate run)
    prefix = 128 * WINDOW
    sub = VertexStream(s.etype[:prefix], s.vertex[:prefix], s.nbrs[:prefix],
                       n=s.n)
    split = _Split()
    split.wrap(fops, "_prepare_window", "prep_loop")
    split.wrap(tx, "rand_index_table", "rand_table")
    split.wrap(fk, "fused_window_choose", "fused_kernel")
    split.wrap(fops, "_fused_lane", "mixed_window_total")
    split.wrap(pops, "partition_affinity", "partition_affinity")
    split.wrap(wnd, "run_window_adds", "add_window_total")
    split.wrap(engine, "run_events", "scan_tail")
    try:
        t = time.perf_counter()
        _session(sub, cfg, dev, WINDOW)
        split_total = time.perf_counter() - t
    finally:
        split.restore()
    sec = split.seconds
    split_out = {
        "events": prefix,
        "total_s": split_total,
        "prep_loop_s": sec.get("prep_loop", 0.0),
        "rand_table_s": sec.get("rand_table", 0.0),
        "fused_kernel_s": sec.get("fused_kernel", 0.0),
        "apply_s": (sec.get("mixed_window_total", 0.0)
                    - sec.get("prep_loop", 0.0) - sec.get("rand_table", 0.0)
                    - sec.get("fused_kernel", 0.0)),
        "add_fixup_s": (sec.get("add_window_total", 0.0)
                        - sec.get("partition_affinity", 0.0)),
        "partition_affinity_s": sec.get("partition_affinity", 0.0),
        "scan_tail_s": sec.get("scan_tail", 0.0),
    }
    out = {"phase": "twitter", "scale": 1.0, "n": s.n,
           "edges_capped": g.num_edges, "events": s.num_events, **counts,
           "max_deg": s.max_deg, "session_max_deg": part.max_deg,
           "window": WINDOW, "max_cap": cfg.max_cap,
           "setup_s": round(setup_s, 3), "run_s": run_s,
           "events_per_s": s.num_events / run_s,
           "launches": launches, "kernel_windows": m["kernel_windows"],
           "fallback_windows": m["fallback_windows"],
           "metrics": {k: m[k] for k in ("edge_cut", "total_edges",
                                         "edge_cut_ratio", "load_imbalance",
                                         "num_partitions", "denied_scaleout",
                                         "scale_events")},
           **_scaling(st, cfg.k_init),
           "recount_ok": True, "max_memory_allocated": peak,
           "split": split_out}
    emit(out)
    return out


def kernel_line(kernels: dict, twitter: dict) -> dict:
    pa_case = next(c for c in kernels["partition_affinity"]["cases"] if "ms" in c)
    fc_case = next(c for c in kernels["fused_chooser"]["cases"] if "ms" in c)
    pa_cases = kernels["partition_affinity"]["cases"]
    fc_cases = kernels["fused_chooser"]["cases"]
    worst_pa = max(c["max_abs_err"] for c in pa_cases)
    worst_fc = max(c["max_abs_err"] for c in fc_cases)
    rows = [
        {"name": "partition_affinity", "route": "cuda",
         "source": "src/repro_torch/csrc/partition_affinity.cu",
         "replaces": "src/repro/kernels/partition_affinity/partition_affinity.py:47",
         "launches": twitter["launches"]["partition_affinity"],
         "max_abs_err": worst_pa, "shape": pa_case["shape"],
         "cases": len(pa_cases),
         "mismatches": sum(c["max_abs_err"] != 0 for c in pa_cases),
         "ms": pa_case["ms"], "plain_ms": pa_case["plain_ms"],
         "bound_ms": pa_case["bound_ms"], "bound_by": "bytes",
         "library_ms": pa_case["library_ms"]},
        {"name": "fused_chooser", "route": "cuda",
         "source": "src/repro_torch/csrc/fused_chooser.cu",
         "replaces": "src/repro/kernels/fused_chooser/fused_chooser.py:245",
         "launches": twitter["launches"]["fused_chooser"],
         "max_abs_err": worst_fc, "shape": fc_case["shape"],
         "cases": len(fc_cases),
         "mismatches": sum(c["max_abs_err"] != 0 for c in fc_cases),
         "ms": fc_case["ms"], "plain_ms": fc_case["plain_ms"],
         "bound_ms": fc_case["bound_ms"], "bound_by": "bytes",
         "library_ms": None},
    ]
    return {"kernels": rows}


def main() -> int:
    info = phase_device()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    kernels = phase_kernels(dev)
    phase_grqc(dev)
    twitter = phase_twitter(dev)
    emit(kernel_line(kernels, twitter))
    print(info["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
