"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc``, holds each
against its plain PyTorch version on the card (bit-equal, no tolerance,
for the exact kernels; flash_attention's f32 sums run in another order
than the plain version's, so it is held at tests/test_kernels.py's 2e-5 in
f32 and at one bf16 ulp in bf16, on each of its three kernels: f32 CUDA
cores, the bf16 tensor-core prefill, the bf16 decode split over the keys),
runs the streaming session on grqc against the
port's faithful per-event engine (and at k_max = 200, the fused chooser's
large-K kernel, against the plain session), drives the full-width
session — the
paper's largest dataset, twitter at scale 1.0 — through
``Partitioner.feed`` with its five kernels on the path (pure-ADD windows:
``partition_affinity``, ``window_rng``, the pure-ADD fixup
``add_window_choose``; mixed ones: ``window_prep``, ``window_rng``,
``fused_chooser``), times its window pipelines against the host loops
they replace on the same card, rebalances the twitter session's final
state (``Partitioner.rebalance``, its label histograms on
``partition_affinity`` over all n rows) against the plain histograms and
runs fig16's three streams at full scale against the JAX package's
pinned digests, drives the long-lived session's lifecycle — bulk deletes
with ``auto_shrink``, ``compact()``, ``snapshot()``, ``restore()`` on the
card, the same tail to both sessions — on twitter and on grqc (against
its pinned JAX digest), and serves
the two-tower recsys model at its full vocabulary and widths (bf16
tables, 51.54 GB on the card) through ``serve_score`` and
``score_candidates`` with the ``embedding_bag`` kernel on the path,
aggregates twitter's ELL adjacency through ``ell_aggregate`` with the
``segment_spmm`` kernel on the path, and serves gemma2-9b at its full
width and depth (bf16, 18.48 GB of params, an 11.32 GB KV cache) through
``LMServer`` — 8 requests of 8,192-token prompts, 32 tokens each — with
every attention call of prefill and decode on the ``flash_attention``
kernel (prefill on the tensor cores, decode split over the keys). One
JSON line per phase; the last line is ``{"ok": true,
"device": {...}}``.
Any failure raises and exits non-zero without that line. Needs one CUDA
card; imports nothing of JAX.
"""
from __future__ import annotations

import functools
import itertools
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.api import scenarios as sc  # noqa: E402
from repro_torch.api.scenarios import state_digest  # noqa: E402
from repro_torch.api.partitioner import Partitioner  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.shapes import RECSYS_SHAPES  # noqa: E402
from repro_torch.core import engine, windowed as wnd  # noqa: E402
from repro_torch.core.rng import prng_key  # noqa: E402
from repro_torch.core.state import PartitionState, init_state  # noqa: E402
from repro_torch.core.transition import knob_tensor  # noqa: E402
from repro_torch.core.config import EngineConfig, POLICIES  # noqa: E402
from repro_torch.core.metrics import (  # noqa: E402
    normalized_load_imbalance, recompute_counters,
)
from repro_torch.core.offline import cut_of, offline_partition  # noqa: E402
from repro_torch.graph.csr import cap_degree  # noqa: E402
from repro_torch.graph.datasets import load_dataset  # noqa: E402
from repro_torch.graph.stream import (  # noqa: E402
    VertexStream, interleaved_churn, materialize_graph,
)
from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels.embedding_bag import embedding_bag as eb  # noqa: E402
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as fa  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.fused_chooser import fused_chooser as fk  # noqa: E402
from repro_torch.kernels.fused_chooser import ops as fops  # noqa: E402
from repro_torch.kernels.fused_chooser import sweep as fsweep  # noqa: E402
from repro_torch.kernels.fused_chooser.ref import (  # noqa: E402
    fused_window_choose_ref, prepare_window_ref,
)
from repro_torch.kernels.fused_chooser.window_prep import window_prep  # noqa: E402
from repro_torch.kernels.partition_affinity import ops as pops  # noqa: E402
from repro_torch.kernels.partition_affinity import partition_affinity as pa  # noqa: E402
from repro_torch.kernels.partition_affinity.ref import partition_affinity_ref  # noqa: E402
from repro_torch.kernels.segment_spmm import ops as sops  # noqa: E402
from repro_torch.kernels.segment_spmm import segment_spmm as ss  # noqa: E402
from repro_torch.kernels.segment_spmm.ref import segment_spmm_ref  # noqa: E402
from repro_torch.kernels.window_rng import ops as rops  # noqa: E402
from repro_torch.kernels.window_rng.ref import window_rng_ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import recsys as RS  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.rebalance import passes as rpasses  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
L2_BYTES = 50 * 2 ** 20        # H100 SXM L2 (NVIDIA data sheet)
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor cores (data sheet)
EVENT_ARGS = dict(warmup_frac=0.2, del_every=3, edge_del_every=5, seed=0)
# the full-width session's kernel shapes: a window of 256 events, twitter
# degree-capped to 192 (``Partitioner.from_stream`` sizes the rows to the
# stream's max_deg exactly), 16 partition slots
WINDOW, TWITTER_CAP, K_MAX = 256, 192, 16
SESSION_SHAPE = (WINDOW, TWITTER_CAP, K_MAX)
K_200_CAP = 60             # grqc's k_max = 200 session: edges a partition
GRQC_WIDTH = 2843          # grqc's widest row, uncapped (the grqc phase's D)
# embedding_bag cases (V, D, B, L, lowest id, table view's offset in
# elements): tests/test_kernels.py's shapes, the serve shape (4096 bags of 8
# slots at D = 256), rows past 2^23 at D = 256, where idx * D passes 2^31,
# and the load-width variants: row widths and base offsets that give every
# width in f32 and bf16, with bags of 1, 8, 37 and 2,000 slots
BAG_CASES = ((10, 8, 4, 1, -1, 0), (50, 24, 12, 5, -1, 0),
             (100, 130, 7, 9, -1, 0), (30, 256, 3, 4, -1, 0),
             (1 << 20, 256, 4096, 8, -1, 0),
             ((1 << 23) + 4096, 256, 1024, 8, 1 << 23, 0),
             (300, 256, 45, 37, -1, 1), (300, 256, 45, 2000, -1, 2),
             (300, 256, 45, 1, -1, 4), (300, 6, 45, 8, -1, 0),
             (300, 5, 45, 37, -1, 0), (300, 12, 45, 2000, -1, 0))
# the recsys phase: requests served (after warm-up ones), the corpus chunk,
# the serve_bulk slice checked against the plain bag, and the check's
# tolerance on scores (|score| <= 1/temperature = 20; the kernel path and
# the plain path run the same towers on bit-equal bags, so 0 is expected)
P99_REQUESTS, BULK_REQUESTS, QUERIES, WARMUP = 300, 4, 200, 10
CORPUS_CHUNK, BULK_CHECK = 131_072, 32_768
SCORE_ATOL = 1e-3
# flash_attention cases (B, H, Hkv, Sq, Sk, D): tests/test_kernels.py's
# ATTN_CASES, then phi3's (32/32 x 96) and deepseek's (56/8 x 128) heads
ATTN_CASES = ((1, 1, 1, 16, 16, 8), (2, 4, 2, 64, 64, 16),
              (2, 4, 1, 33, 65, 32), (1, 8, 8, 128, 128, 64),
              (1, 32, 32, 256, 256, 96), (1, 56, 8, 256, 256, 128))
ATTN_KW = (dict(causal=True), dict(causal=True, window=16),
           dict(causal=True, softcap=30.0), dict(causal=False))
ATTN_TOL = 2e-5          # tests/test_kernels.py's tolerance, f32
# bf16 out: kernel and plain version round one f32 result computed in
# another order, so they may land one bf16 ulp (<= 2^-7 relative) apart
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-5
# bf16 attention at the other LM configs' heads (phi3-mini 32/32 x 96,
# deepseek-coder 56/8 x 128) at a short S that is no multiple of a tile
BF16_ARCHS, BF16_S = ("phi3-mini-3.8b", "deepseek-coder-33b"), 300
# the LM phase: gemma2-9b's CONFIG served as serve_lm serves it
LM_ARCH, LM_SLOTS, LM_REQUESTS, LM_PROMPT, LM_GEN = "gemma2-9b", 4, 8, 8192, 32
LM_MAX_LEN = LM_PROMPT + LM_GEN + 1
# logits of two bf16 paths through 42 layers (kernel vs plain attention;
# prefill + decode vs one forward over S + 1 tokens, whose products run at
# other shapes): each rounds the residual stream to bf16 (2^-8) at other
# places, so they drift apart by a few bf16 ulps; a wrong mask, position
# or cache slot moves the logits by O(1). Limit on the relative L2 error:
LOGIT_REL = 2.0 ** -4
# int32 operations a second: 132 SMs x 64 results a clock for 32-bit
# integer add, shift, compare and logic (CUDA C++ Programming Guide,
# arithmetic instruction throughput, compute capability 9.0) x the 1.98 GHz
# boost clock of the H100 SXM data sheet (its 67 TFLOP/s f32 is 132 x 128
# lanes x 2 (an FMA) x that clock)
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# the rebalance phase: fig16's full-scale budget (m = 128 greedy commits,
# two LPA iterations) on the twitter session's final state; every rebalance
# takes its histograms from partition_affinity once for the migration's
# ranking and twice an LPA iteration
REBALANCE_M, REBALANCE_PASSES = 128, 2
REBALANCE_HISTOGRAMS = 1 + 2 * REBALANCE_PASSES
CKPT_DIR = os.path.join(ROOT, "build", "repro_torch", "smoke_ckpt")
# segment_spmm: the twitter session's ELL (degree cap 192) at MeshGraphNet's
# hidden width and at full_graph_sm's d_feat, and grqc's uncapped rows
SPMM_WIDTHS = (128, 1433)


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


def host_ms(fn, reps: int) -> float:
    """The host's time per call of ``fn`` (Python, argument checks,
    launches), read on the host's clock around ``reps`` calls issued back
    to back with no sync in between, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    secs = time.perf_counter() - t
    torch.cuda.synchronize()
    return secs * 1e3 / reps


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


def bag_case(dev, v, d, b, l, dtype, seed, low=-1, off=0):
    """A (V, D) table in ``dtype`` — a view ``off`` elements into its
    storage — and (B, L) int32 bags: ids in [low, V), about a quarter of
    the slots -1, bag 0 all padding — built by hand, since full-vocab
    ``make_batch`` ids are almost never -1."""
    g = torch.Generator(device=dev).manual_seed(seed)
    flat = torch.randn((v * d + off,), generator=g, device=dev).to(dtype)
    table = flat[off:].view(v, d)
    idx = torch.randint(low, v, (b, l), generator=g, device=dev,
                        dtype=torch.int32)
    pad = torch.rand((b, l), generator=g, device=dev) < 0.25
    idx = torch.where(pad, torch.full_like(idx, -1), idx)
    idx[0] = -1
    return table, idx


def assert_states_equal(a, b, what: str) -> None:
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if x.dtype == torch.uint32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        if x.shape != y.shape or not torch.equal(x, y):
            raise AssertionError(f"{what}: leaf {f!r} differs")


def check_recount(st, what: str) -> None:
    """Every counter of ``st`` equals a from-scratch recount of its
    (assignment, present, adjacency)."""
    rec = recompute_counters(st.assignment.cpu().numpy(),
                             st.present.cpu().numpy(), st.adj.cpu().numpy(),
                             st.edge_load.shape[0])
    for key in ("edge_load", "vertex_count", "cut_matrix"):
        if not np.array_equal(rec[key], getattr(st, key).cpu().numpy()):
            raise AssertionError(f"{what}: {key} disagrees with the "
                                 "from-scratch recount")
    for key in ("total_edges", "cut_edges"):
        if rec[key] != int(getattr(st, key)):
            raise AssertionError(f"{what}: {key} disagrees with the "
                                 "from-scratch recount")


def clone_state(st) -> PartitionState:
    return PartitionState(*(t.clone() for t in st))


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
    libs = common.build_kernels(["partition_affinity", "fused_chooser",
                                 "window_prep", "window_rng",
                                 "embedding_bag", "flash_attention",
                                 "segment_spmm"])
    secs = time.perf_counter() - t
    ptxas = {}
    for name, lib in libs.items():
        log = lib.with_suffix(".log")
        ptxas[name] = (_ptxas_report(log.read_text())
                       if log.exists() else ["(library was already built)"])
    out = {"phase": "build", "seconds": round(secs, 3),
           "libraries": {k: str(v.relative_to(ROOT)) for k, v in libs.items()},
           "ptxas": ptxas}
    emit(out)
    return out


def _ptxas_report(log: str) -> list:
    """One line per compiled function of ``nvcc -Xptxas -v``'s log: the
    function (its mangled name's readable part), registers, static shared
    memory, spills."""
    rows, name = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
            hashed = re.search(r"_cu_[0-9a-f]{8}(.*)", name)
            name = re.sub(r"^\d+", "", hashed.group(1) if hashed else name)
        elif "spill" in ln and name:
            spill = ln.strip()
        elif "Used" in ln and "registers" in ln and name:
            rows.append(f"{name}: {ln.split(':', 1)[1].strip()}; {spill}")
            name = None
    return rows


def check_partition_affinity(dev) -> dict:
    gen = torch.Generator(device=dev).manual_seed(0)
    pa_out = {"name": "partition_affinity", "cases": []}
    for (w, d, k) in (SESSION_SHAPE, (256, 256, 16), (100, 37, 5), (1, 1, 1),
                      (WINDOW, TWITTER_CAP, 200), (70, GRQC_WIDTH, 2000)):
        labels = torch.randint(-1, k, (w, d), generator=gen, device=dev,
                               dtype=torch.int32)
        out = pa.partition_affinity(labels, k_max=k)
        torch.cuda.synchronize()
        err = max_abs_diff(out, partition_affinity_ref(labels, k_max=k))
        case = {"shape": [w, d, k], "max_abs_err": err}
        if (w, d) == SESSION_SHAPE[:2] and k in (K_MAX, 200):
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
            # the floor of a launch this small: a one-element zero_, timed
            # the same way
            one = torch.zeros(1, device=dev)
            case["launch_floor_ms"] = graph_ms(one.zero_, 100)
        pa_out["cases"].append(case)
        if err:
            raise AssertionError(f"partition_affinity {w}x{d}x{k}: kernel "
                                 f"differs from the plain version by {err}")
    return pa_out


def _fused_bytes(w: int, d: int, k: int) -> int:
    """Bytes one fused_window_choose launch must move: its inputs (the
    scalar rows, the two (W, D) tables, the random table, the counters,
    knobs) read once and its outputs written once."""
    return 4 * (w * fk.EV_COLS + 2 * w * d + w * k + 3 * k + k * k
                + fk.SCAL_N + 7 + 2 * w + 4 * k + k * k + fk.SCAL_N)


def check_fused_chooser(dev) -> dict:
    fc_out = {"name": "fused_chooser", "cases": []}
    # the window kernels' setups (sweep.WINDOW_SETUPS): the session's shapes
    # (SESSION_SHAPE), a window and width off every multiple of 32, a single
    # partition slot, partitions past the warp's 32 lanes, grqc's uncapped
    # 2,843-wide rows, and 200 and 1,000 partition slots (the large-K
    # kernel)
    for label, spec in fsweep.WINDOW_SETUPS.items():
        name, scale, cap, width, k_max, max_cap, window, warm = spec
        args, n, ets = fsweep.window_inputs(
            dev, name, scale, cap, width, k_max, max_cap, window, warm,
            EVENT_ARGS)
        scalars = args[8]
        n_del = int((ets != 0).sum())
        guards = ("text", "alg1")
        # the plain version takes ~8 s a window at K = 1,000: SDP only
        # there (tests/test_torch_gpu.py holds every policy at K = 1,000)
        for policy in (("sdp",) if label == "k1000" else POLICIES):
            for guard in guards:
                for auto in ((True, False) if label == "session"
                             else (True,)):
                    kw = dict(n=n, policy=policy, balance_guard=guard,
                              autoscaling=auto)
                    got = fk.fused_window_choose(*args, **kw)
                    want = fused_window_choose_ref(*args, **kw)
                    torch.cuda.synchronize()
                    err = max_abs_diff(got, want)
                    scale = int(got[6][4] - scalars[4])
                    case = {"case": label, "shape": [window, width, k_max],
                            "kernel": fk.dispatch(window, k_max),
                            "policy": policy, "guard": guard,
                            "autoscale": auto, "max_abs_err": err,
                            "scale_events_in_window": scale,
                            "deletions_in_window": n_del}
                    timed = guard == "text" and auto and (
                        policy == "sdp" or (label == "session"
                                            and policy in ("ldg", "random")))
                    if timed and label in ("session", "k40", "grqc_wide",
                                           "k200", "k1000"):
                        def kernel():
                            fk.fused_window_choose(*args, **kw)

                        def plain():
                            fused_window_choose_ref(*args, **kw)

                        case["ms"] = graph_ms(kernel, 20)
                        case["eager_ms"] = eager_ms(kernel, 20)
                        if policy == "sdp" and k_max > fk.LANES_MAX_K:
                            # a graph would pool the (K, K) temporaries of
                            # every slot's op
                            case["plain_ms"] = case["plain_eager_ms"] = \
                                eager_ms(plain, 1)
                        elif policy == "sdp":
                            case["plain_ms"] = graph_ms(plain, 1, replays=2)
                            case["plain_eager_ms"] = eager_ms(plain, 1)
                        w, d, k = window, width, k_max
                        case["bound_ms"] = (_fused_bytes(w, d, k)
                                            / HBM_BYTES_PER_S * 1e3)
                    fc_out["cases"].append(case)
                    if err:
                        raise AssertionError(
                            f"fused_chooser {label} {policy}/{guard}/"
                            f"autoscale={auto}: kernel differs from the plain "
                            f"version by {err}")
    return fc_out


def _bound(nbytes: int, ops: int) -> dict:
    """The least time for a call that moves ``nbytes`` and does ``ops``
    int32 operations: the larger of the two."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / INT32_OPS_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": nbytes, "int_ops": ops}


def _window_cases(dev):
    """{setup: (state, cfg, (etype, vertex, rows))} of the window
    kernels' setups (``sweep.WINDOW_SETUPS``)."""
    return {name: fsweep.window_state(dev, *spec, fsweep.CHURN)
            for name, spec in fsweep.WINDOW_SETUPS.items()}


def check_window_rng(dev) -> dict:
    """Bit-equal to the plain version at the session's t0s, the uint32
    wrap and K from 1 to 1,000; timed at the session's (W, K)."""
    out = {"name": "window_rng", "cases": []}
    for seed in (0, 2**40 + 5):
        key = prng_key(seed, device=dev)
        for t0 in (0, 114_958, 2**32 - 100):
            for k in (1, K_MAX, 200, 1000):
                got = rops.window_rng(key, t0, WINDOW, k)
                want = window_rng_ref(key, t0, WINDOW, k)
                torch.cuda.synchronize()
                err = max_abs_diff([got], [want])
                case = {"seed": seed, "t0": t0, "shape": [WINDOW, k],
                        "max_abs_err": err}
                if (seed, t0, k) == (0, 114_958, K_MAX):
                    case["ms"] = graph_ms(lambda: rops.window_rng(
                        key, t0, WINDOW, k), 100)
                    case["eager_ms"] = eager_ms(lambda: rops.window_rng(
                        key, t0, WINDOW, k), 100)
                    case["plain_ms"] = graph_ms(lambda: window_rng_ref(
                        key, t0, WINDOW, k), 5)
                    case["plain_eager_ms"] = eager_ms(lambda: window_rng_ref(
                        key, t0, WINDOW, k), 5)
                    # five threefry blocks of ~117 operations a slot, and
                    # 10 for each table entry's range reduction (five
                    # modulos and five products, masks and sums, each
                    # modulo counted as one operation, so a lower bound);
                    # the key in, the table out
                    case.update(_bound(8 + WINDOW * k * 4,
                                       WINDOW * (5 * 117 + 2 + 10 * k)))
                out["cases"].append(case)
                if err:
                    raise AssertionError(f"window_rng seed={seed} t0={t0} "
                                         f"k={k}: kernel differs from the "
                                         f"plain version by {err}")
    return out


def _prep_bytes(prep, state, rows) -> int:
    """Bytes one window_prep call must move: the events in, the scalar
    rows and both tables out, the assignment and presence (n) in, label0
    and last_touch (n) out, and each adjacency row the window reads (the
    subjects of fresh ADDs, DEL_VERTEXes and DEL_EDGEs, and the DEL_EDGEs'
    other ends) once, and once more if it writes it (all but those only
    DEL_VERTEXes name)."""
    w, d = rows.shape
    n = state.assignment.shape[0]
    et, v = prep.ev[:, fk.EV_ET], prep.ev[:, fk.EV_V]
    u = rows[:, 0]
    de = (et == 2) & (u >= 0)
    wrote = (prep.ev[:, fk.EV_FRESH] != 0) | de
    read = torch.unique(torch.cat([v[wrote | (et == 1)], u[de]])).numel()
    written = torch.unique(torch.cat([v[wrote], u[de]])).numel()
    return (4 * (2 * w + w * d) + 4 * w * fk.EV_COLS + 8 * w * d + 5 * n
            + 8 * n + 4 * d * (read + written))


def check_window_prep(dev, cases) -> dict:
    """Bit-equal to the plain loop (every output, the adjacency after it,
    presence unwritten) on each setup's own window, four crafted ones
    (pads, self-loops, an edge deleted from both endpoints, a vertex added
    twice, a deleted vertex added again) and one over four hot vertices,
    whose rows carry long chains of slots; timed on each setup's own
    window."""
    out = {"name": "window_prep", "cases": []}
    for name in ("session", "grqc_wide", "odd"):
        state, _, (et, vx, nb) = cases[name]
        w, warm = fsweep.WINDOW_SETUPS[name][6:]
        sl = slice(warm, warm + w)
        windows = {"stream": (et[sl], vx[sl], nb[sl])}
        for seed in range(4):
            windows[f"crafted{seed}"] = fsweep.crafted_window(state, w, seed)
        windows["chain0"] = fsweep.chain_window(state, w, 0)
        for label, (ets, vs, rows) in windows.items():
            a, b = fsweep.clone_state(state), fsweep.clone_state(state)
            got = window_prep(a, ets, vs, rows)
            want = prepare_window_ref(b, ets, vs, rows)
            torch.cuda.synchronize()
            err = max(max_abs_diff(got, want),
                      max_abs_diff([a.adj, a.present], [b.adj, state.present]))
            case = {"case": name, "window": label,
                    "shape": list(rows.shape), "max_abs_err": err,
                    "del_edges": int((ets == 2).sum()),
                    "exists": int(got.ev[:, fk.EV_EXISTS].sum())}
            if label == "stream":
                c = fsweep.clone_state(state)
                case["ms"] = graph_ms(lambda: window_prep(c, ets, vs, rows),
                                      20)
                case["eager_ms"] = eager_ms(
                    lambda: window_prep(c, ets, vs, rows), 20)
                case["plain_ms"] = graph_ms(
                    lambda: prepare_window_ref(c, ets, vs, rows), 1,
                    replays=2)
                case["plain_eager_ms"] = eager_ms(
                    lambda: prepare_window_ref(c, ets, vs, rows), 1)
                case.update(_bound(_prep_bytes(got, state, rows), 0))
            out["cases"].append(case)
            if err:
                raise AssertionError(f"window_prep {name}/{label}: kernel "
                                     f"differs from the plain loop by {err}")
    return out


def _add_bytes(w: int, d: int, k: int) -> int:
    """Bytes one add_window_choose call must move: scores, degrees,
    win_pos, fresh flags, subjects, the random table and the counters in
    (knobs too), w_assign and the counters out."""
    return (4 * (w * k + w + w * d + w + w * k) + w
            + 4 * (3 * k + k * k + fk.SCAL_N + 7)
            + 4 * (w + 3 * k + k * k + fk.SCAL_N))


def check_add_window_choose(dev, cases) -> dict:
    """Bit-equal to the plain loop (``windowed.add_window_fixup_ref``) for
    every policy x guard (and autoscale off too at the session's shape) on
    a pure-ADD window of each setup: the stream's first events from the
    empty state (deletions among them turned into pads) and a crafted window
    mid-stream (pads, a vertex added twice, ADDs of present vertices, rows
    naming their subject); timed (SDP) on both windows at the session's
    shape (the first window, all of whose 256 slots commit, is the session's
    own), and on the crafted ones at grqc's rows, K = 200 and 1,000. Each
    call takes the kernel ``add_dispatch`` names (lanes to K = 192, large
    above), counted by kernel; where it is the lanes kernel, the large one
    is also timed on the same inputs (uncounted)."""
    out = {"name": "add_window_choose", "cases": [],
           "launches_by_kernel": dict.fromkeys(fk.KERNELS, 0)}
    for name, (state, cfg, (et, vx, nb)) in cases.items():
        w, warm = fsweep.WINDOW_SETUPS[name][6:]
        first = init_state(state.assignment.shape[0], state.adj.shape[1],
                           state.edge_load.shape[0], 1, seed=0, device=dev)
        windows = {
            "first": (first, torch.where(et[:w] == 0, vx[:w], -1), nb[:w], 0),
            "crafted": (state, *fsweep.crafted_window(state, w, 3,
                                                      adds_only=True)[1:],
                        warm)}
        for label, (st, vs, rows, t0) in windows.items():
            args = fsweep.add_window_args(st, cfg, vs, rows, t0,
                                          pops.scores_for_state)
            n = st.assignment.shape[0]
            variant = fk.add_dispatch(w, st.edge_load.shape[0])
            for policy in POLICIES:
                for guard in ("text", "alg1"):
                    for auto in ((True, False) if name == "session"
                                 else (True,)):
                        kw = dict(n=n, policy=policy, balance_guard=guard,
                                  autoscaling=auto)
                        by = dict(fk.add_window_choose.kernel_launches)
                        got = fk.add_window_choose(*args, **kw)
                        if fk.add_window_choose.kernel_launches != {
                                k: c + (k == variant) for k, c in by.items()}:
                            raise AssertionError(
                                f"add_window_choose {name}/{label} did not "
                                f"take the {variant} kernel: "
                                f"{fk.add_window_choose.kernel_launches}")
                        out["launches_by_kernel"][variant] += 1
                        want = wnd.add_window_fixup_ref(*args, **kw)
                        torch.cuda.synchronize()
                        err = max_abs_diff(got, want)
                        case = {"case": name, "window": label,
                                "shape": [w, rows.shape[1],
                                          st.edge_load.shape[0]],
                                "kernel": variant,
                                "policy": policy, "guard": guard,
                                "autoscale": auto, "max_abs_err": err,
                                "fresh": int(args[3].sum()),
                                "committed": int((got[0] >= 0).sum())}
                        timed = (policy == "sdp" and guard == "text"
                                 and auto and (name == "session" or (
                                     label == "crafted" and name in (
                                         "grqc_wide", "k200", "k1000"))))
                        if timed:
                            def kernel():
                                fk.add_window_choose(*args, **kw)

                            def plain():
                                wnd.add_window_fixup_ref(*args, **kw)

                            d, k = rows.shape[1], st.edge_load.shape[0]
                            case["ms"] = graph_ms(kernel, 20)
                            case["eager_ms"] = eager_ms(kernel, 20)
                            if variant == "lanes":
                                # the large kernel on the same inputs,
                                # uncounted: the layout the lanes one
                                # replaced at K <= 192
                                case["large_ms"] = graph_ms(
                                    lambda: fk.add_launch(
                                        "large", *args, policy=policy,
                                        balance_guard=guard,
                                        autoscaling=auto), 20)
                            case["plain_ms"] = graph_ms(plain, 1, replays=2)
                            case["plain_eager_ms"] = eager_ms(plain, 1)
                            case.update(_bound(_add_bytes(w, d, k), 0))
                        out["cases"].append(case)
                        if err:
                            raise AssertionError(
                                f"add_window_choose {name}/{label} {policy}/"
                                f"{guard}/autoscale={auto}: kernel differs "
                                f"from the plain loop by {err}")
    return out


def check_embedding_bag(dev) -> dict:
    """f32 and bf16 tables, sum and mean, every case with -1 slots and an
    all-padding bag (BAG_CASES)."""
    eb_out = {"name": "embedding_bag", "cases": []}
    for v, d, b, l, low, off in BAG_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            table, idx = bag_case(dev, v, d, b, l, dtype, seed=v + b + l,
                                  low=low, off=off)
            width = eb.load_width(d, table.element_size(), table.data_ptr())
            for mode in ("sum", "mean"):
                by = dict(eb.embedding_bag.kernel_launches)
                got = eb.embedding_bag(table, idx, mode=mode)
                want = embedding_bag_ref(table, idx, mode=mode)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                same = torch.equal(got, want)
                eb_out["cases"].append(
                    {"shape": [v, d, b, l], "dtype": str(dtype)[6:],
                     "mode": mode, "view_offset_bytes":
                         off * table.element_size(),
                     "load_width": width, "max_abs_err": err,
                     "max_row_offset": int(idx.max()) * d,
                     "padding_slots": int((idx < 0).sum())})
                if not same or err or got[0].any():
                    raise AssertionError(
                        f"embedding_bag {v}x{d} bags {b}x{l} {dtype} {mode}: "
                        f"kernel differs from the plain version by {err}")
                if eb.embedding_bag.kernel_launches != {
                        k: n + (k == f"load{width}") for k, n in by.items()}:
                    raise AssertionError(f"embedding_bag {v}x{d} {dtype}: the "
                                         f"call did not take load{width}")
            del table, idx
    widths = {c["load_width"] for c in eb_out["cases"]}
    if widths != set(eb.LOAD_WIDTHS):
        raise AssertionError(f"embedding_bag cases took widths {widths}")
    torch.cuda.empty_cache()
    return eb_out


def _bf16_err(got, want) -> float:
    """Worst excess of |got - want| over the bf16 tolerance (<= 0 passes),
    and the max abs err."""
    diff = (got.float() - want.float()).abs()
    excess = diff - (BF16_ATOL + BF16_RTOL * want.float().abs())
    return float(excess.max()), float(diff.max())


def _attn_inputs(dev, b, h, hkv, sq, sk, d, dtype, seed, layout="bhsd"):
    """q, k, v from a seeded generator; ``layout="bshd"`` makes them the
    model's (B, S, H, D) tensors seen as (B, H, S, D) views."""
    g = torch.Generator(device=dev).manual_seed(seed)
    out = []
    for heads, s in ((h, sq), (hkv, sk), (hkv, sk)):
        if layout == "bshd":
            t = torch.randn((b, s, heads, d), generator=g, device=dev)
            out.append(t.to(dtype).transpose(1, 2))
        else:
            t = torch.randn((b, heads, s, d), generator=g, device=dev)
            out.append(t.to(dtype))
    return out


def check_flash_attention(dev) -> dict:
    """ATTN_CASES x ATTN_KW and the decode case with a q_offset in f32 at
    2e-5 (the f32 kernel); in bf16, through the model's (B, S, H, D)
    views, at one bf16 ulp: phi3-mini's and deepseek-coder's heads at a
    short S (the tensor-core prefill kernel, and a decode step on the
    split kernel), and gemma2's own prefill (S = 8,192, local and global)
    and decode (4 slots against an 8,225-slot cache) shapes."""
    fa_out = {"name": "flash_attention", "cases": []}
    cases = [(c, kw) for c in ATTN_CASES for kw in ATTN_KW]
    cases.append(((2, 4, 2, 1, 96, 16), dict(q_offset=95)))
    for (b, h, hkv, sq, sk, d), kw in cases:
        q, k, v = _attn_inputs(dev, b, h, hkv, sq, sk, d, torch.float32,
                               seed=sq * 7 + d)
        got = fa.flash_attention(q, k, v, **kw)
        want = attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        ok = bool(torch.allclose(got, want, rtol=ATTN_TOL, atol=ATTN_TOL))
        fa_out["cases"].append({"shape": [b, h, hkv, sq, sk, d], **kw,
                                "dtype": "float32", "max_abs_err": err,
                                "tol": ATTN_TOL})
        if not ok:
            raise AssertionError(f"flash_attention {[b, h, hkv, sq, sk, d]} "
                                 f"{kw}: kernel differs from the plain "
                                 f"version by {err} > {ATTN_TOL}")
    bf16_cases = []
    for arch in BF16_ARCHS:
        c = get_arch(arch).config
        heads = (c.n_heads, c.n_kv_heads, c.head_dim)
        bf16_cases += [((2, heads[0], heads[1], BF16_S, BF16_S, heads[2]),
                        dict(window=0, softcap=c.attn_softcap)),
                       ((4, heads[0], heads[1], 1, BF16_S, heads[2]),
                        dict(window=0, softcap=c.attn_softcap,
                             q_offset=BF16_S - 1))]
    cfg = get_arch(LM_ARCH).config
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    bf16_cases += [((1, hq, hkv, LM_PROMPT, LM_PROMPT, hd),
                    dict(window=w, softcap=cfg.attn_softcap))
                   for w in (cfg.window_pattern)]
    bf16_cases += [((LM_SLOTS, hq, hkv, 1, LM_MAX_LEN, hd),
                    dict(window=w, q_offset=LM_PROMPT + 5,
                         softcap=cfg.attn_softcap))
                   for w in cfg.window_pattern]
    for (b, h, hkv_, sq, sk, d), kw in bf16_cases:
        q, k, v = _attn_inputs(dev, b, h, hkv_, sq, sk, d, torch.bfloat16,
                               seed=sq + kw["window"], layout="bshd")
        how = fa.dispatch(q, k, window=kw["window"],
                          q_offset=kw.get("q_offset", 0))
        got = fa.flash_attention(q, k, v, **kw)
        want = layers.attention(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2),
                                q_offset=kw.get("q_offset", 0),
                                window=kw["window"], softcap=kw["softcap"],
                                use_kernel=False, chunk=cfg.attn_chunk)
        torch.cuda.synchronize()
        excess, err = _bf16_err(got, want.transpose(1, 2))
        fa_out["cases"].append({"shape": [b, h, hkv_, sq, sk, d], **kw,
                                "dtype": "bfloat16", "layout": "bshd views",
                                "kernel": how["kernel"],
                                "n_split": how["n_split"],
                                "max_abs_err": err, "rtol": BF16_RTOL,
                                "atol": BF16_ATOL})
        if excess > 0:
            raise AssertionError(f"flash_attention bf16 {[b, h, sq, sk, d]} "
                                 f"{kw}: the {how['kernel']} kernel differs "
                                 f"from the plain version by {err} (beyond "
                                 f"one bf16 ulp)")
        del q, k, v, got, want
    torch.cuda.empty_cache()
    return fa_out


def ell_of(g, width: int) -> np.ndarray:
    """The graph's (n, width) int32 ELL adjacency, -1 padded."""
    deg = np.diff(g.indptr)
    ell = np.full((g.n, width), -1, np.int32)
    rows = np.repeat(np.arange(g.n), deg)
    cols = np.arange(g.indptr[-1]) - np.repeat(g.indptr[:-1], deg)
    ell[rows, cols] = g.indices
    return ell


def spmm_graphs(dev) -> dict:
    """{name: ELL on ``dev``}: twitter at scale 1.0 degree-capped to 192 as
    the session holds it, and grqc uncapped (rows 2,843 wide)."""
    tw = cap_degree(load_dataset("twitter", scale=1.0), TWITTER_CAP)
    gq = load_dataset("grqc")
    return {"twitter": torch.from_numpy(ell_of(tw, TWITTER_CAP)).to(dev),
            "grqc": torch.from_numpy(ell_of(gq, int(np.diff(gq.indptr).max())))
            .to(dev)}


def check_segment_spmm(dev, graphs) -> dict:
    """Sum and mean, f32 and bf16, on twitter's ELL at F = 128 and 1433 and
    grqc's at F = 128: bit-equal to the plain version."""
    sp_out = {"name": "segment_spmm", "cases": []}
    for name, adj in graphs.items():
        for f in (SPMM_WIDTHS if name == "twitter" else SPMM_WIDTHS[:1]):
            g = torch.Generator(device=dev).manual_seed(f)
            x32 = torch.randn((adj.shape[0], f), generator=g, device=dev)
            for dtype in (torch.float32, torch.bfloat16):
                x = x32.to(dtype)
                for mode in ("sum", "mean"):
                    got = ss.segment_spmm(x, adj, mode=mode)
                    want = segment_spmm_ref(x, adj, mode=mode)
                    torch.cuda.synchronize()
                    err = float((got - want).abs().max())
                    sp_out["cases"].append(
                        {"graph": name, "shape": [adj.shape[0], adj.shape[1], f],
                         "dtype": str(dtype)[6:], "mode": mode,
                         "max_abs_err": err,
                         "valid_slots": int((adj >= 0).sum())})
                    if not torch.equal(got, want):
                        raise AssertionError(
                            f"segment_spmm {name} F={f} {dtype} {mode}: kernel "
                            f"differs from the plain version by {err}")
                    del got, want
            del x32, x
    torch.cuda.empty_cache()
    return sp_out


def phase_kernels(dev, graphs) -> dict:
    """Each kernel against its plain version on the card: bit for bit, but
    flash_attention at its stated tolerances."""
    cases = _window_cases(dev)
    out = {"phase": "kernels",
           "partition_affinity": check_partition_affinity(dev),
           "fused_chooser": check_fused_chooser(dev),
           "window_rng": check_window_rng(dev),
           "window_prep": check_window_prep(dev, cases),
           "add_window_choose": check_add_window_choose(dev, cases),
           "embedding_bag": check_embedding_bag(dev),
           "flash_attention": check_flash_attention(dev),
           "segment_spmm": check_segment_spmm(dev, graphs)}
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


_WRAPPERS = {"partition_affinity": pa.partition_affinity,
             "fused_chooser": fk.fused_window_choose,
             "window_prep": window_prep,
             "window_rng": rops.window_rng,
             "add_window_choose": fk.add_window_choose,
             "embedding_bag": eb.embedding_bag,
             "flash_attention": fa.flash_attention,
             "segment_spmm": ss.segment_spmm}
SESSION_KERNELS = ("partition_affinity", "fused_chooser", "window_prep",
                   "window_rng", "add_window_choose")


def _reset_launches():
    for fn in _WRAPPERS.values():
        fn.launches = 0
    fa.flash_attention.kernel_launches = dict.fromkeys(fa.KERNELS, 0)
    ss.segment_spmm.kernel_launches = dict.fromkeys(ss.KERNELS, 0)
    eb.embedding_bag.kernel_launches = dict.fromkeys(eb.KERNELS, 0)
    fk.fused_window_choose.kernel_launches = dict.fromkeys(fk.KERNELS, 0)
    fk.add_window_choose.kernel_launches = dict.fromkeys(fk.KERNELS, 0)


def _read_launches(names=SESSION_KERNELS) -> dict:
    return {name: _WRAPPERS[name].launches for name in names}


def _check_session_launches(launches: dict, windows: dict, what: str,
                            histograms: int = 0, every: bool = True):
    """Every session kernel launched, once a window of its kind: the prep
    scan and the fused chooser per mixed window, partition_affinity and
    the pure-ADD fixup per pure-ADD window, the RNG per window — and
    partition_affinity once more for each of the session's ``histograms``
    rebalance histograms. ``every``: each kernel at least once."""
    want = {"window_prep": windows["mixed"],
            "fused_chooser": windows["mixed"],
            "partition_affinity": windows["add"] + histograms,
            "add_window_choose": windows["add"],
            "window_rng": windows["mixed"] + windows["add"]}
    if (every and min(launches.values()) < 1) or launches != want \
            or launches["partition_affinity"] < 1:
        raise AssertionError(f"{what} missed a kernel: launched {launches}, "
                             f"windows {windows}")


def _window_kinds(part) -> dict:
    """How many of a session's full windows were pure-ADD and mixed, as
    the Partitioner counted them."""
    m = part.metrics()
    return {"add": m["add_windows"], "mixed": m["mixed_windows"]}


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
    _check_session_launches(launches, _window_kinds(part),
                            "grqc session")
    m = part.metrics()
    out = {"phase": "grqc", "n": s.n, "events": T, "max_deg": s.max_deg,
           "max_cap": cfg.max_cap, "bit_equal": True,
           "state_sha256": state_digest(part.state),
           **_scaling(part.state, cfg.k_init),
           "kernel_windows": m["kernel_windows"],
           "fallback_windows": m["fallback_windows"], "launches": launches,
           "faithful_s": round(t_ref, 3), "session_s": round(t_part, 3),
           "k200": _session_k200(s, dev)}
    emit(out)
    return out


def _session_k200(s, dev) -> dict:
    """The same stream at k_max = 200 (K_200_CAP a partition): the session
    with both kernels — the large-K fused_chooser, partition_affinity's
    shared histogram — against the plain windowed session on the card."""
    cfg = EngineConfig(k_max=200, k_init=1, max_cap=K_200_CAP, autoscale=True)
    _reset_launches()
    t = time.perf_counter()
    part = _session(s, cfg, dev, 256)
    t_part = time.perf_counter() - t
    launches = _read_launches()
    by_kernel = dict(fk.fused_window_choose.kernel_launches)
    add_by_kernel = dict(fk.add_window_choose.kernel_launches)
    plain = Partitioner.from_stream(s, cfg, policy="sdp", seed=0, window=256,
                                    device=dev).feed(s)
    plain.sync()
    assert_states_equal(part.state, plain.state,
                        "grqc k_max=200 session vs the plain session")
    _check_session_launches(launches, _window_kinds(part),
                            "grqc k_max=200 session")
    if (by_kernel["large"] != launches["fused_chooser"]
            or add_by_kernel["large"] != launches["add_window_choose"]):
        raise AssertionError(f"grqc k_max=200 session missed the large "
                             f"kernels: {by_kernel}, add {add_by_kernel}")
    return {"k_max": cfg.k_max, "max_cap": cfg.max_cap, "bit_equal": True,
            **_scaling(part.state, cfg.k_init), "launches": launches,
            "launches_by_kernel": by_kernel,
            "add_launches_by_kernel": add_by_kernel,
            "session_s": round(t_part, 3)}


class _Split:
    """Wall-clock split of a session's stages: wraps module functions with
    synchronized timers (host and device both finish inside each span)."""

    def __init__(self):
        self.seconds: dict[str, float] = {}
        self.calls: dict[str, list] = {}
        self._undo = []

    def wrap(self, module, attr, label):
        fn = getattr(module, attr)

        @functools.wraps(fn)      # keeps a wrapper's launch counter in reach
        def timed(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = fn(*a, **kw)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
            self.seconds[label] = self.seconds.get(label, 0.0) + dt
            self.calls.setdefault(label, []).append(dt)
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
    by_kernel = dict(fk.fused_window_choose.kernel_launches)
    add_by_kernel = dict(fk.add_window_choose.kernel_launches)
    windows = _window_kinds(part)
    _check_session_launches(launches, windows, "twitter session")
    if (by_kernel["lanes"] != launches["fused_chooser"]
            or add_by_kernel["lanes"] != launches["add_window_choose"]):
        raise AssertionError(f"twitter session left the lanes kernels: "
                             f"{by_kernel}, add {add_by_kernel}")
    shape = (WINDOW, part.max_deg, cfg.k_max)
    if shape != SESSION_SHAPE:
        raise AssertionError(f"twitter session ran its kernels at (W, D, K) = "
                             f"{shape}, phase kernels timed {SESSION_SHAPE}")
    peak = torch.cuda.max_memory_allocated(dev)
    st = part.state
    check_recount(st, "twitter")
    m = part.metrics()

    # wall-time split over a prefix of the same stream, every stage timed
    # with synchronizes around it (which is why it is a separate run)
    prefix = 128 * WINDOW
    sub = VertexStream(s.etype[:prefix], s.vertex[:prefix], s.nbrs[:prefix],
                       n=s.n)
    split = _Split()
    split.wrap(fops, "_prepare_window", "prep_kernel")
    split.wrap(fops, "window_rng", "rand_kernel")
    split.wrap(fk, "fused_window_choose", "fused_kernel")
    split.wrap(fk, "add_window_choose", "add_fixup_kernel")
    split.wrap(pops, "partition_affinity", "partition_affinity")
    split.wrap(fops, "_fused_lane", "mixed_window_total")
    split.wrap(fops, "run_window_adds_fused", "add_window_total")
    split.wrap(engine, "run_events", "scan_tail")
    try:
        t = time.perf_counter()
        split_part = _session(sub, cfg, dev, WINDOW)
        split_total = time.perf_counter() - t
    finally:
        split.restore()
    sec = {k: split.seconds.get(k, 0.0) for k in (
        "prep_kernel", "rand_kernel", "fused_kernel", "add_fixup_kernel",
        "partition_affinity", "mixed_window_total", "add_window_total",
        "scan_tail")}
    split_out = {
        "events": prefix, "windows": _window_kinds(split_part),
        "total_s": split_total,
        **{f"{k}_s": sec[k] for k in (
            "prep_kernel", "rand_kernel", "fused_kernel", "add_fixup_kernel",
            "partition_affinity", "scan_tail")},
        # the rest of both window kinds: set-up, the O(n) writes and
        # gathers, the wrappers' own ops
        "apply_s": (sec["mixed_window_total"] + sec["add_window_total"]
                    - sec["prep_kernel"] - sec["rand_kernel"]
                    - sec["fused_kernel"] - sec["add_fixup_kernel"]
                    - sec["partition_affinity"]),
        "mixed_window_total_s": sec["mixed_window_total"],
        "add_window_total_s": sec["add_window_total"],
        # the session's own host time: feed's chunking and padding, the
        # window dispatch, the engines' set-up
        "outside_windows_s": (split_total - sec["mixed_window_total"]
                              - sec["add_window_total"] - sec["scan_tail"]),
    }
    out = {"phase": "twitter", "scale": 1.0, "n": s.n,
           "edges_capped": g.num_edges, "events": s.num_events, **counts,
           "max_deg": s.max_deg, "session_max_deg": part.max_deg,
           "window": WINDOW, "max_cap": cfg.max_cap,
           "setup_s": round(setup_s, 3), "run_s": run_s,
           "events_per_s": s.num_events / run_s,
           "launches": launches, "launches_by_kernel": by_kernel,
           "add_launches_by_kernel": add_by_kernel,
           "windows": windows, "kernel_windows": m["kernel_windows"],
           "fallback_windows": m["fallback_windows"],
           "metrics": {k: m[k] for k in ("edge_cut", "total_edges",
                                         "edge_cut_ratio", "load_imbalance",
                                         "num_partitions", "denied_scaleout",
                                         "scale_events")},
           **_scaling(st, cfg.k_init),
           "recount_ok": True, "max_memory_allocated": peak,
           "split": split_out,
           "loops": _window_loops(s, cfg, dev, prefix)}
    emit(out)
    return out, part, g, s


def _rebalance_labels(st) -> torch.Tensor:
    """The (n, D) labels tile the rebalance's histograms read (rows of
    absent vertices -1), built as ``rebalance.passes._histograms`` does."""
    labels = pops.gather_labels(st.assignment, st.present, st.adj)
    return torch.where(st.present[:, None], labels, -1)


def _affinity_at_n(st, dev) -> dict:
    """partition_affinity on the rebalance's own (n, D, K) labels: checked
    bit-equal to the plain version, timed against its bound and against
    the same histogram as one scatter_add_."""
    labels = _rebalance_labels(st)
    w, d = labels.shape
    k = st.edge_load.shape[0]
    err = max_abs_diff(pa.partition_affinity(labels, k_max=k),
                       partition_affinity_ref(labels, k_max=k))
    if err:
        raise AssertionError(f"partition_affinity at ({w}, {d}, {k}) "
                             f"differs from the plain version by {err}")
    ones = torch.ones((w, d), dtype=torch.int32, device=dev)
    bins = (labels + 1).to(torch.int64)

    def library():
        torch.zeros((w, k + 1), dtype=torch.int32, device=dev) \
            .scatter_add_(1, bins, ones)[:, 1:]

    return {"shape": [w, d, k], "max_abs_err": err,
            "ms": graph_ms(lambda: pa.partition_affinity(labels, k_max=k),
                           20),
            "eager_ms": eager_ms(
                lambda: pa.partition_affinity(labels, k_max=k), 20),
            "plain_ms": graph_ms(
                lambda: partition_affinity_ref(labels, k_max=k), 3),
            "library_ms": graph_ms(library, 10),
            "bound_ms": (w * d + w * k + w) * 4 / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes"}


def _rebalance_trace(st, cursor, slack, cap) -> dict:
    """One rebalance (kernel histograms) traced by torch.profiler on a copy
    of ``st``: the CUDA kernels it launches and their device time, and the
    device's idle share of the traced wall time."""
    work = clone_state(st)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        rpasses.rebalance_state(work, cursor, slack, cap, m=REBALANCE_M,
                                passes=REBALANCE_PASSES)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        rows.append((us, e.key, e.count))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e3
    return {"device_ops": sum(r[2] for r in rows),
            "traced_wall_ms": wall * 1e3, "traced_kernel_ms": busy,
            "device_idle_share": 1 - busy / (wall * 1e3) if rows else None,
            "top_kernels": [{"name": k[:100], "count": c, "ms": us / 1e3}
                            for us, k, c in rows[:8]]}


def _rebalance_split(st, cursor, slack, cap) -> dict:
    """Where one rebalance's wall time goes, every stage synchronized on
    both sides (so the sum is slower than an untimed run): the label
    histograms (partition_affinity plus the gather), the migration's
    ranking, its greedy commits, the LPA iterations' own work, and the
    counters' recount after each iteration."""
    split = _Split()
    split.wrap(rpasses, "_histograms", "histograms")
    split.wrap(rpasses, "_commit", "commits")
    split.wrap(rpasses, "_recount", "recount")
    split.wrap(rpasses, "_lpa_sweep", "lpa_sweeps")
    split.wrap(rpasses, "migration_pass", "migration")
    try:
        t = time.perf_counter()
        rpasses.rebalance_state(clone_state(st), cursor, slack, cap,
                                m=REBALANCE_M, passes=REBALANCE_PASSES)
        total = time.perf_counter() - t
    finally:
        split.restore()
    c = split.calls
    hist_first = c["histograms"][0]
    hist_lpa = sum(c["histograms"][1:])
    commits = sum(c["commits"])
    ms = 1e3
    return {"total_ms": total * ms,
            "histograms_ms": sum(c["histograms"]) * ms,
            "histogram_calls": len(c["histograms"]),
            "migration_rank_ms": (c["migration"][0] - hist_first
                                  - commits) * ms,
            "commits_ms": commits * ms,
            "commit_ms_each": commits * ms / len(c["commits"]),
            "lpa_ms": (sum(c["lpa_sweeps"]) - hist_lpa
                       - sum(c["recount"])) * ms,
            "recount_ms": sum(c["recount"]) * ms}


def phase_rebalance(dev, twitter_part) -> dict:
    """The rebalance on the card: fig16's full-scale budget on the twitter
    session's final state (81,306 x 192, k_max = 16) through
    ``Partitioner.rebalance`` — its histograms on partition_affinity at W =
    n — held leaf for leaf to the same rebalance with the plain histograms
    on the same state, both to a recount, and the state before and after
    to the JAX package's pinned digests; then fig16's three streams at
    full scale, with and without a rebalance after every interval, each
    lane's final state held to the JAX package's pinned digest."""
    part = twitter_part
    if state_digest(part.state) != sc.TWITTER_SESSION_DIGEST:
        raise AssertionError("twitter session: state differs from the JAX "
                             "package's")
    st0 = clone_state(part.state)
    cursor = part.cursor
    slack = torch.tensor(part.rebalance_slack, dtype=torch.float32,
                         device=dev)
    cap = torch.tensor(part.cfg.max_cap, dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    _reset_launches()
    t = time.perf_counter()
    ev = part.rebalance(m=REBALANCE_M, passes=REBALANCE_PASSES)
    torch.cuda.synchronize()
    session_s = time.perf_counter() - t
    launches = _read_launches()
    want = dict.fromkeys(SESSION_KERNELS, 0)
    want["partition_affinity"] = REBALANCE_HISTOGRAMS
    if launches != want:
        raise AssertionError(f"twitter rebalance launched {launches}, "
                             f"expected {want}")
    t = time.perf_counter()
    plain, pstats = rpasses.rebalance_state(
        clone_state(st0), cursor, slack, cap, m=REBALANCE_M,
        passes=REBALANCE_PASSES, use_kernel=False)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t
    assert_states_equal(part.state, plain,
                        "twitter rebalance: kernel vs plain histograms")
    if state_digest(part.state) != sc.TWITTER_REBALANCE_DIGEST:
        raise AssertionError("twitter rebalance: state differs from the JAX "
                             "package's")
    if (ev["moved"], ev["cut_after"]) != (int(pstats.moved),
                                          int(pstats.cut_after)):
        raise AssertionError("twitter rebalance: stats differ")
    check_recount(part.state, "twitter rebalance (kernel)")
    check_recount(plain, "twitter rebalance (plain)")
    del plain

    # timing runs on copies of the same input, after the counted run
    def once(use_kernel):
        work = clone_state(st0)
        torch.cuda.synchronize()
        t = time.perf_counter()
        rpasses.rebalance_state(work, cursor, slack, cap, m=REBALANCE_M,
                                passes=REBALANCE_PASSES,
                                use_kernel=use_kernel)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    eager = [once(True) for _ in range(3)]
    plain_eager = [once(False) for _ in range(2)]
    # the passes' device work alone (rebalance_state less its host-side
    # exactness check) from a CUDA graph: the rebalance with no host issue
    graph_work = clone_state(st0)

    def passes():
        st, _ = rpasses.migration_pass(graph_work, m=REBALANCE_M,
                                       slack=slack, max_cap=cap)
        rpasses.lpa_pass(st, cursor, passes=REBALANCE_PASSES, slack=slack,
                         max_cap=cap)

    graph = graph_ms(passes, 1, replays=3)
    out = {"phase": "rebalance", "state": [part.n, part.max_deg,
                                           part.cfg.k_max],
           "m": REBALANCE_M, "passes": REBALANCE_PASSES,
           "moved": ev["moved"], "cut_before": ev["cut_before"],
           "cut_after": ev["cut_after"],
           "imbalance_before": ev["imbalance_before"],
           "imbalance_after": ev["imbalance_after"],
           "bit_equal_plain": True, "recount_ok": True,
           "jax_digests_ok": True,
           "launches": launches, "session_call_ms": session_s * 1e3,
           "plain_call_ms": plain_s * 1e3,
           "eager_ms": float(np.median(eager)), "eager_ms_all": eager,
           "plain_eager_ms": float(np.median(plain_eager)),
           "graph_ms": graph,
           "split": _rebalance_split(st0, cursor, slack, cap),
           "trace": _rebalance_trace(st0, cursor, slack, cap),
           "partition_affinity": _affinity_at_n(st0, dev),
           "fig16": _fig16_full(dev)}
    emit(out)
    return out


def _fig16_full(dev) -> dict:
    """fig16 at full scale on the card (the port's own streams and
    offline stand-in): every lane's final state equals the JAX package's
    pinned digest, its kernels launched once a window of their kind and
    partition_affinity five times a rebalance; the rebalanced lanes pass
    the recount. Cut ratio and normalized imbalance of each lane's final
    state, and of the offline partition of the graph the stream leaves."""
    cfg = sc.fig16_cfg()
    m = sc.FIG16_M[False]
    t0 = time.perf_counter()
    lanes = []
    for name, s in sc.fig16_streams(False):
        row = {"stream": name, "events": s.num_events}
        for rebalance in (False, True):
            _reset_launches()
            t = time.perf_counter()
            part, _ = sc.quality_lane(Partitioner, s, cfg,
                                      rebalance=rebalance, m=m, device=dev,
                                      use_kernel=True, window=WINDOW)
            secs = time.perf_counter() - t
            launches = _read_launches()
            rebalances = part.metrics()["rebalances"]
            _check_session_launches(
                launches, _window_kinds(part), f"fig16 {name}",
                histograms=REBALANCE_HISTOGRAMS * rebalances, every=False)
            digest = state_digest(part.state)
            if digest != sc.FIG16_FULL_DIGESTS[(name, rebalance)]:
                raise AssertionError(f"fig16 {name} (rebalance="
                                     f"{rebalance}): state differs from "
                                     "the JAX package's")
            if rebalance:
                check_recount(part.state, f"fig16 {name}")
            st = part.state
            mm = part.metrics()
            row["sdp+rebalance" if rebalance else "sdp"] = {
                "edge_cut_ratio": mm["edge_cut_ratio"],
                "imbalance": normalized_load_imbalance(
                    st.edge_load.cpu().numpy(), st.active.cpu().numpy()),
                "rebalances": rebalances,
                "moved": mm["rebalance_moves"], "seconds": secs,
                "launches": launches, "digest_ok": True}
        gm = materialize_graph(s)
        t = time.perf_counter()
        a = offline_partition(gm, sc.FIG16_K)
        deg = np.diff(gm.indptr)
        load = np.bincount(np.asarray(a), weights=deg, minlength=sc.FIG16_K)
        row["offline"] = {
            "edge_cut_ratio": cut_of(gm, a) / max(gm.num_edges, 1),
            "imbalance": float(load.std() / max(load.mean(), 1e-9)),
            "seconds": time.perf_counter() - t}
        lanes.append(row)
    return {"lanes": lanes, "m": m, "passes": sc.FIG16_PASSES,
            "seconds": time.perf_counter() - t0}


def _ckpt_bytes(directory: str) -> int:
    return sum(os.path.getsize(os.path.join(directory, f))
               for f in os.listdir(directory) if f.startswith("ckpt_"))


def _lifecycle(name, g, s, dev) -> dict:
    """``scenarios.run_lifecycle`` on the card, timed stage by stage; the
    restored session equals the original after the same tail, both pass
    the recount, and every session kernel launched once a window."""
    cfg = EngineConfig(**sc.LIFECYCLE_CFG[name])
    directory = os.path.join(CKPT_DIR, name)
    shutil.rmtree(directory, ignore_errors=True)
    marks, info = {}, {}

    def probe(stage, session):
        torch.cuda.synchronize()
        marks[stage] = time.perf_counter()
        if stage == "fed":
            info["peak_state_bytes"] = session.metrics()["state_bytes"]
            info["peak_geometry"] = list(session.geometry)
        elif stage == "deleted":
            mm = session.metrics()
            info["present_after_deletes"] = int(session.state.present.sum())
            info["auto_shrinks"] = mm["shrinks"]
            info["geometry_before_compact"] = list(session.geometry)
            info["allocated_before_compact"] = torch.cuda.memory_allocated(
                dev)
            torch.cuda.reset_peak_memory_stats(dev)
            marks["compact_start"] = time.perf_counter()
        elif stage == "compacted":
            info["max_memory_allocated_compact"] = \
                torch.cuda.max_memory_allocated(dev)
            info["allocated_after_compact"] = torch.cuda.memory_allocated(
                dev)
            info["compacted_state_bytes"] = session.metrics()["state_bytes"]
            info["compacted_geometry"] = list(session.geometry)
            info["relabelled"] = session._ext2int is not None

    _reset_launches()
    t0 = time.perf_counter()
    part, restored, survivors = sc.run_lifecycle(
        Partitioner, g, s, cfg, directory, probe=probe, device=dev,
        use_kernel=True, window=WINDOW)
    total = time.perf_counter() - t0
    launches = _read_launches()
    windows = {k: a + b for (k, a), b in zip(
        _window_kinds(part).items(), _window_kinds(restored).values())}
    _check_session_launches(launches, windows, f"{name} lifecycle")
    assert_states_equal(part.state, restored.state,
                        f"{name} lifecycle: restored vs original")
    check_recount(part.state, f"{name} lifecycle (original)")
    check_recount(restored.state, f"{name} lifecycle (restored)")
    ckpt = _ckpt_bytes(directory)
    shutil.rmtree(directory, ignore_errors=True)
    mm = part.metrics()
    return {"n": s.n, "events": s.num_events, "survivors": len(survivors),
            **info, "checkpoint_bytes": ckpt,
            "final_geometry": list(part.geometry),
            "shrinks": mm["shrinks"], "compactions": mm["compactions"],
            "regeometries": mm["regeometries"],
            "geometry_events": [
                {"cursor": e["cursor"], "kind": e["kind"],
                 "from": list(e["from"]), "to": list(e["to"])}
                for e in part.geometry_events],
            "compact_s": marks["compacted"] - marks["compact_start"],
            "snapshot_s": marks["snapshotted"] - marks["checked"],
            "restore_s": marks["restored"] - marks["snapshotted"],
            "tail_s": marks["done"] - marks["restored"],
            "total_s": total, "launches": launches, "windows": windows,
            "restored_equal": True, "recount_ok": True,
            "state_sha256": state_digest(part.state)}


def phase_lifecycle(dev, g, s) -> dict:
    """The long-lived session on the card: the twitter session (scale 1.0)
    bulk-deleted to an eighth of its vertices with auto_shrink on,
    compacted (the id map checked on every survivor), snapshotted without
    blocking, restored into a second card session, and fed the same tail
    as the original; then the same on grqc, whose final state must equal
    the JAX package's pinned digest."""
    out = {"phase": "lifecycle", "twitter": _lifecycle("twitter", g, s, dev)}
    gg, gs = sc.lifecycle_stream("grqc")
    grqc = _lifecycle("grqc", gg, gs, dev)
    if grqc["state_sha256"] != sc.GRQC_LIFECYCLE_DIGEST:
        raise AssertionError("grqc lifecycle: state differs from the JAX "
                             "package's")
    out["grqc"] = {**grqc, "digest_ok": True}
    emit(out)
    return out


class _PlainLoops:
    """Within it, the window pipelines run the host loops that the window
    kernels replace: the prep loop, the plain RNG and the pure-ADD loop
    (``fused_window_choose`` and ``partition_affinity`` stay kernels)."""

    def __enter__(self):
        self._undo = [(fops, "_prepare_window", fops._prepare_window),
                      (fops, "window_rng", fops.window_rng),
                      (fk, "add_window_choose", fk.add_window_choose)]
        fops._prepare_window = prepare_window_ref
        fops.window_rng = window_rng_ref
        fk.add_window_choose = wnd.add_window_fixup_ref
        return self

    def __exit__(self, *exc):
        for module, attr, fn in self._undo:
            setattr(module, attr, fn)


def _window_loops(s, cfg, dev, prefix: int) -> dict:
    """The window pipelines with the host loops (before) and with the
    window kernels (after), on one card, on the first ``prefix`` events of
    the session's stream: each window function on the same state, timed
    on the host's clock with a sync after it, for 4 pure-ADD and 4 mixed
    windows (the states after both held equal); then, over 8 windows of
    each kind with the kernels, the device's launches a window
    (torch.profiler) and its busy share of the windows' untraced wall, and
    one window of each kind replayed from a CUDA graph (capture fails on a
    read back to the host)."""
    W = WINDOW
    et = torch.as_tensor(s.etype[:prefix]).to(dev)
    vx = torch.as_tensor(s.vertex[:prefix]).to(dev)
    nb = torch.as_tensor(s.nbrs[:prefix]).to(dev)
    kinds = ["add" if np.all(s.etype[j * W:(j + 1) * W] == 0) else "mixed"
             for j in range(prefix // W)]
    by_kind = {k: [j for j, x in enumerate(kinds) if x == k]
               for k in ("add", "mixed")}
    picks = {j for js in by_kind.values()
             for j in js[len(js) // 8::len(js) // 4][:4]}
    traced = {k: js[8:16] for k, js in by_kind.items()}
    if min(len(js) for js in traced.values()) < 8:
        raise AssertionError(f"the prefix holds too few windows of a kind "
                             f"to trace 8: {traced}")
    state = init_state(s.n, nb.shape[1], cfg.k_max, cfg.k_init, seed=0,
                       device=dev)
    knobs = knob_tensor(cfg, s.n, dev)

    def run(st, j):
        sl = slice(j * W, (j + 1) * W)
        if kinds[j] == "add":
            return fops.run_window_adds_fused(
                st, vx[sl], nb[sl], j * W, policy="sdp", cfg=cfg, knobs=knobs)
        return fops.run_window_mixed_fused(
            st, et[sl], vx[sl], nb[sl], j * W, policy="sdp", cfg=cfg,
            knobs=knobs)

    def timed(st, js):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for j in js:
            st = run(st, j)
        torch.cuda.synchronize()
        return time.perf_counter() - t, st

    per_window = {"add": [], "mixed": []}
    profile, graph = {}, {}
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for j in range(len(kinds)):
        if j in picks:
            with _PlainLoops():
                before_s, b = timed(fsweep.clone_state(state), [j])
            after_s, a = timed(fsweep.clone_state(state), [j])
            assert_states_equal(a, b, f"twitter window {j}: kernels vs "
                                      f"host loops")
            per_window[kinds[j]].append(
                {"window": j, "before_s": before_s, "after_s": after_s})
            del a, b
        for kind, js in traced.items():
            if j == js[0]:
                wall_s, _ = timed(fsweep.clone_state(state), js)
                c = fsweep.clone_state(state)
                torch.cuda.synchronize()
                with torch.profiler.profile(activities=acts) as prof:
                    timed(c, js)
                n_dev, busy_us = 0, 0.0
                for e in prof.key_averages():
                    if e.device_type != torch.autograd.DeviceType.CUDA:
                        continue
                    us = getattr(e, "self_device_time_total", None)
                    busy_us += e.self_cuda_time_total if us is None else us
                    n_dev += e.count
                profile[kind] = {
                    "windows": js, "wall_ms_per_window": wall_s * 1e3 / 8,
                    "device_ops_per_window": n_dev / 8,
                    "device_busy_ms_per_window": busy_us / 1e3 / 8,
                    "device_busy_share": (busy_us / 1e6 / wall_s
                                          if n_dev else None)}
                del c
                # one window captured in a CUDA graph, which a read back to
                # the host would break (its replays re-apply the window to
                # the state it left, so their time is not a window's)
                c = fsweep.clone_state(state)
                graph_ms(lambda c=c, j=j: run(c, j), 1, replays=1)
                graph[kind] = {"window": j, "captured": True}
                del c
        state = run(state, j)

    def summary(rows):
        return {"windows": [r["window"] for r in rows],
                "before_s": [r["before_s"] for r in rows],
                "after_s": [r["after_s"] for r in rows],
                "before_s_mean": float(np.mean([r["before_s"] for r in rows])),
                "after_s_mean": float(np.mean([r["after_s"] for r in rows]))}

    return {"events": prefix, "add": summary(per_window["add"]),
            "mixed": summary(per_window["mixed"]), "profile": profile,
            "graph": graph}


def _ms_pct(seconds, q) -> float:
    return float(np.percentile(np.asarray(seconds) * 1e3, q))


def _bag_ids(batch: dict, cfg) -> torch.Tensor:
    """A request's user and item bags as one (B·F_user + B·F_item, S) list
    (every id is below both vocabularies, which are equal)."""
    s = cfg.field_slots
    return torch.cat([batch["user_ids"].reshape(-1, s),
                      batch["item_ids"].reshape(-1, s)])


def _rows_bound_ms(table, idx, n_out: int) -> float:
    """HBM time of the bytes one gather-reduce launch (embedding_bag,
    segment_spmm) must move: each table row that a valid slot names read
    once (a row named twice is still one read), every id read once, every
    output float written once."""
    d = table.shape[1]
    rows = torch.unique(idx[idx >= 0]).numel()
    nbytes = (rows * d * table.element_size() + idx.numel() * 4
              + n_out * d * 4)
    return nbytes / HBM_BYTES_PER_S * 1e3


def _rotation(fns):
    """One callable that calls ``fns`` in turn, the next one each call."""
    it = itertools.cycle(fns)
    return lambda: next(it)()


def _cold_rotation(row_bytes: int) -> int:
    """How many requests, each gathering ``row_bytes`` of table rows, to
    time in turn so that their rows add up to 4x the L2: each request's
    rows have then left the L2 when it comes round again, and its gather
    reads HBM, as a new request's does. One request replayed alone would
    find its rows in the L2 if they fit."""
    return max(1, -(-4 * L2_BYTES // row_bytes))


def time_bag(table, idxs: list, reps: int, plain_in_graph: bool) -> dict:
    """The kernel (mean bags, as the towers call it), its plain version and
    ``torch.nn.functional.embedding_bag`` — the yardstick, over the same
    ids compacted into the offsets form outside the timing; with a bf16
    table it returns bf16 — on the same table, each timed over the bags
    ``idxs`` in turn (one request's ids each; several where one request's
    rows fit the L2, see ``_cold_requests``). Bounds and rates are per
    call, averaged over ``idxs``."""
    torch.cuda.empty_cache()       # earlier graphs' pools, before big temporaries
    reps = len(idxs) * max(reps // len(idxs), 1)
    d = table.shape[1]
    kernels, plains, libraries, slot_bytes = [], [], [], 0
    for idx in idxs:
        valid = idx >= 0
        flat = idx[valid].to(torch.int64)
        offsets = torch.zeros(idx.shape[0], dtype=torch.int64,
                              device=idx.device)
        offsets[1:] = torch.cumsum(valid.sum(dim=1), 0)[:-1]
        kernels.append(functools.partial(eb.embedding_bag, table, idx,
                                         mode="mean"))
        plains.append(functools.partial(embedding_bag_ref, table, idx,
                                        mode="mean"))
        libraries.append(functools.partial(
            torch.nn.functional.embedding_bag, flat, table, offsets,
            mode="mean"))
        # every valid slot's row read, the ids and the output
        slot_bytes += (int(valid.sum()) * d * table.element_size()
                       + idx.numel() * 4 + idx.shape[0] * d * 4)
    slot_bytes /= len(idxs)
    kernel, plain, library = map(_rotation, (kernels, plains, libraries))
    lib_out = libraries[0]()
    out = {"bags": idxs[0].shape[0], "slots": idxs[0].shape[1], "dim": d,
           "table_dtype": str(table.dtype)[6:], "requests": len(idxs),
           "ms": graph_ms(kernel, reps), "eager_ms": eager_ms(kernel, reps),
           "library_ms": graph_ms(library, reps),
           "library_eager_ms": eager_ms(library, reps),
           "library_out_dtype": str(lib_out.dtype)[6:],
           "library_max_abs_diff_vs_kernel": float(
               (lib_out.float() - kernels[0]()).abs().max()),
           "bound_ms": sum(_rows_bound_ms(table, idx, idx.shape[0])
                           for idx in idxs) / len(idxs),
           "bound_by": "bytes"}
    out["all_slot_bytes"] = slot_bytes
    out["all_slot_bound_ms"] = slot_bytes / HBM_BYTES_PER_S * 1e3
    out["all_slot_gb_per_s"] = slot_bytes / (out["ms"] * 1e-3) / 1e9
    out["load_width"] = eb.load_width(d, table.element_size(),
                                      table.data_ptr())
    del lib_out
    if plain_in_graph:
        out["plain_ms"] = graph_ms(plain, max(reps // 5, len(idxs)))
        out["plain_eager_ms"] = eager_ms(plain, max(reps // 5, len(idxs)))
    else:    # a graph would keep the plain version's temporaries pooled
        out["plain_ms"] = out["plain_eager_ms"] = eager_ms(plain, 1)
    return out


def _check_scores(params, cfg, ids: dict, dev):
    """The request's bags bit-equal between the kernel and the plain bag,
    and its scores through both paths within SCORE_ATOL (expected 0).
    Returns the record and the plain path's scores."""
    batch = serve.request_tensors(ids, dev)
    for table, key in (("user_table", "user_ids"), ("item_table", "item_ids")):
        flat = batch[key].reshape(-1, cfg.field_slots)
        if not torch.equal(eb.embedding_bag(params[table], flat, mode="mean"),
                           embedding_bag_ref(params[table], flat, mode="mean")):
            raise AssertionError(f"recsys: {key} bags differ between the "
                                 "kernel and the plain version")
    got = RS.serve_score(params, batch, cfg)
    want = RS.serve_score(params, batch, cfg, use_kernel=False)
    n = ids["user_ids"].shape[0]
    if got.shape != (n,) or not torch.isfinite(got).all() \
            or float(got.abs().max()) > 1.0001 / cfg.temperature:
        raise AssertionError(f"recsys: scores of shape {tuple(got.shape)} "
                             "are not finite cosines / temperature")
    err = float((got - want).abs().max())
    if err > SCORE_ATOL:
        raise AssertionError(f"recsys: {n} scores differ from the plain "
                             f"bag's by {err} > {SCORE_ATOL}")
    return {"pairs": n, "bags_bit_equal": True, "max_abs_err": err,
            "atol": SCORE_ATOL}, want


def phase_recsys(dev) -> dict:
    """Two-tower serving at the full vocabulary and widths (CONFIG with
    bf16 tables): serve_p99 and serve_bulk through ``serve_score``,
    retrieval_cand through ``score_candidates`` over a corpus the item
    tower computes, every bag through the kernel."""
    cfg = serve.serving_config(get_arch("two-tower-retrieval"), full=True)
    torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    params = RS.init_params(
        cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    table_bytes = sum(params[k].numel() * params[k].element_size()
                      for k in ("user_table", "item_table"))

    def request(b, seed):
        t0 = time.perf_counter()
        ids = RS.make_batch(cfg, b, seed=seed)
        t1 = time.perf_counter()
        scores = RS.serve_score(params, serve.request_tensors(ids, dev), cfg)
        torch.cuda.synchronize()
        return scores, t1 - t0, time.perf_counter() - t1

    def served(b, gen_s, srv_s) -> dict:
        req_s = [g + s for g, s in zip(gen_s, srv_s)]
        return {"batch": b, "requests": len(req_s),
                "latency_ms_p50": _ms_pct(req_s, 50),
                "latency_ms_p99": _ms_pct(req_s, 99),
                "serve_ms_p50": _ms_pct(srv_s, 50),
                "serve_ms_p99": _ms_pct(srv_s, 99),
                "make_batch_ms_p50": _ms_pct(gen_s, 50),
                "pairs_per_s": b * len(req_s) / sum(req_s),
                "serve_pairs_per_s": b * len(req_s) / sum(srv_s)}

    _reset_launches()
    # serve_p99: requests of 512 pairs, ids made on the host and copied over
    b_p99 = RECSYS_SHAPES["serve_p99"].batch
    gen_s, srv_s = [], []
    for i in range(WARMUP + P99_REQUESTS):
        _, g, s = request(b_p99, seed=i)
        if i >= WARMUP:
            gen_s.append(g)
            srv_s.append(s)
    p99 = served(b_p99, gen_s, srv_s)
    p99["warmup"] = WARMUP

    # serve_bulk: requests of 262,144 pairs, the first one a warm-up
    b_bulk = RECSYS_SHAPES["serve_bulk"].batch
    gen_s, srv_s = [], []
    for i in range(1 + BULK_REQUESTS):
        scores, g, s = request(b_bulk, seed=10_000 + i)
        if i == 0:
            bulk_head = scores[:BULK_CHECK].clone()
        else:
            gen_s.append(g)
            srv_s.append(s)
    del scores
    bulk = served(b_bulk, gen_s, srv_s)
    bulk["warmup"] = 1

    # retrieval_cand: the corpus through the item tower in chunks, then
    # single queries against all of it
    shape = RECSYS_SHAPES["retrieval_cand"]
    nc = shape.n_candidates
    t = time.perf_counter()
    corpus = torch.empty((nc, cfg.tower_mlp[-1]), dtype=torch.float32,
                         device=dev)
    for c0 in range(0, nc, CORPUS_CHUNK):
        n = min(CORPUS_CHUNK, nc - c0)
        ids = RS.make_batch(cfg, n, seed=20_000 + c0 // CORPUS_CHUNK)
        corpus[c0:c0 + n] = RS.item_embed(
            params, serve.request_tensors(ids, dev), cfg)
    torch.cuda.synchronize()
    corpus_s = time.perf_counter() - t
    lat = []
    for q in range(WARMUP + QUERIES):
        t0 = time.perf_counter()
        batch = serve.request_tensors(
            RS.make_batch(cfg, shape.batch, seed=30_000 + q), dev)
        batch["cand_item_emb"] = corpus
        cand_scores = RS.score_candidates(params, batch, cfg)
        torch.cuda.synchronize()
        if q >= WARMUP:
            lat.append(time.perf_counter() - t0)
    launches = _read_launches(("embedding_bag",))
    by_kernel = dict(eb.embedding_bag.kernel_launches)
    peak = torch.cuda.max_memory_allocated(dev)
    if launches["embedding_bag"] < 1 or by_kernel["load16"] != \
            launches["embedding_bag"]:
        raise AssertionError(f"recsys serving missed the kernel or its "
                             f"16-byte loads: {launches}, {by_kernel}")
    retrieval = {"batch": shape.batch, "candidates": nc,
                 "corpus_s": corpus_s, "queries": len(lat), "warmup": WARMUP,
                 "latency_ms_p50": _ms_pct(lat, 50),
                 "latency_ms_p99": _ms_pct(lat, 99)}

    # checks: the kernel path against the plain bag on the card
    want = RS.score_candidates(params, batch, cfg, use_kernel=False)
    if cand_scores.shape != (shape.batch, nc) \
            or not torch.isfinite(cand_scores).all():
        raise AssertionError("recsys: retrieval scores are not finite "
                             f"({tuple(cand_scores.shape)})")
    err = float((cand_scores - want).abs().max())
    if err > SCORE_ATOL:
        raise AssertionError(f"recsys: retrieval scores differ from the "
                             f"plain bag's by {err} > {SCORE_ATOL}")
    checks = {"retrieval_cand": {"candidates": nc, "max_abs_err": err,
                                 "atol": SCORE_ATOL}}
    del corpus, batch, cand_scores, want
    checks["serve_p99"], _ = _check_scores(
        params, cfg, RS.make_batch(cfg, b_p99, seed=WARMUP), dev)
    bulk_ids = RS.make_batch(cfg, b_bulk, seed=10_000)
    checks["serve_bulk"], want = _check_scores(
        params, cfg, {k: v[:BULK_CHECK] for k, v in bulk_ids.items()}, dev)
    # the same pairs as scored inside the full 262,144-pair request
    err = float((bulk_head - want).abs().max())
    if err > SCORE_ATOL:
        raise AssertionError(f"recsys: serve_bulk scores differ from the "
                             f"plain bag's by {err} > {SCORE_ATOL}")
    checks["serve_bulk"]["max_abs_err_in_full_request"] = err

    # the kernel timed at both serve shapes on the full bf16 table; at
    # serve_p99 over a rotation of requests, so that their rows are read
    # from HBM (_cold_rotation: one request's 25 MB of rows fit the L2)
    table = params["user_table"]
    row_bytes = table.shape[1] * table.element_size()
    first = RS.make_batch(cfg, b_p99, seed=WARMUP)
    n_req = _cold_rotation(row_bytes * min(first["user_ids"].size,
                                           first["item_ids"].size))
    p99_batches = [serve.request_tensors(RS.make_batch(
        cfg, b_p99, seed=WARMUP + r), dev) for r in range(n_req)]
    timing = {"serve_p99": time_bag(
        table, [_bag_ids(b, cfg) for b in p99_batches], 100,
        plain_in_graph=True)}
    # a request launches two bags (user, item); their device time per request
    per_request_ms = 0.0
    for tbl, key in (("user_table", "user_ids"), ("item_table", "item_ids")):
        per_request_ms += graph_ms(_rotation([functools.partial(
            eb.embedding_bag, params[tbl],
            b[key].reshape(-1, cfg.field_slots), mode="mean")
            for b in p99_batches]), n_req * max(100 // n_req, 1))
    timing["serve_p99"]["per_request_ms"] = per_request_ms
    timing["serve_bulk"] = time_bag(
        table, [_bag_ids(serve.request_tensors(bulk_ids, dev), cfg)], 3,
        plain_in_graph=False)
    share = {"serve_p99_of_serve_p50": per_request_ms / p99["serve_ms_p50"],
             "serve_p99_of_latency_p50": per_request_ms / p99["latency_ms_p50"],
             "serve_bulk_of_serve_p50": (timing["serve_bulk"]["ms"]
                                         / bulk["serve_ms_p50"])}
    out = {"phase": "recsys", "arch": cfg.name,
           "config": vars(cfg),
           "table_bytes": table_bytes, "init_s": init_s,
           "serve_p99": p99, "serve_bulk": bulk, "retrieval_cand": retrieval,
           "launches": launches, "launches_by_kernel": by_kernel,
           "max_memory_allocated": peak,
           "checks": checks, "kernel": timing, "kernel_share": share}
    del params, table, p99_batches
    torch.cuda.empty_cache()
    emit(out)
    return out


def _load_widths_by_alignment(rows, f: int, elem_size: int) -> dict:
    """{bytes: count}, derived on the host, not read from the kernel: the
    load width csrc/segment_spmm.cu's alignment rule gives each gathered
    row (one per valid slot) — 16 where ``row * F * elem_size`` is a
    multiple of 16 in a 16-byte-aligned x, else 8, 4 or 2 (slab starts are
    multiples of 16 bytes past the row's start)."""
    off = (rows.to(torch.int64) * (f * elem_size)) % 16
    widths = torch.full_like(off, 2)
    for w in (4, 8, 16):
        widths = torch.where(off % w == 0, w, widths)
    vals, counts = torch.unique(widths, return_counts=True)
    return {int(w): int(c) for w, c in zip(vals, counts)}


def phase_spmm(dev, graphs) -> dict:
    """The segment_spmm kernel's path, ``ell_aggregate`` (the entry point
    of the JAX package that reaches it): twitter's ELL as the session holds
    it (81,306 x 192), f32 features at F = 128 and 1433, sum and mean,
    forward through the kernel and backward through autograd. Checks:
    bit-equal to the plain path, gradients equal to the plain path's, and
    the sum of all-ones features equal to each row's degree."""
    adj = graphs["twitter"]
    n = adj.shape[0]
    deg = (adj >= 0).sum(dim=1).to(torch.float32)
    _reset_launches()
    runs = []
    for f in SPMM_WIDTHS:
        g = torch.Generator(device=dev).manual_seed(f)
        x = torch.randn((n, f), generator=g, device=dev, requires_grad=True)
        w = torch.randn((n, f), generator=g, device=dev)
        for mode in ("sum", "mean"):
            out = sops.ell_aggregate(x, adj, mode)
            (grad,) = torch.autograd.grad((out * w).sum(), x)
            want = sops.ell_aggregate(x, adj, mode, False)
            (want_grad,) = torch.autograd.grad((want * w).sum(), x,
                                               retain_graph=True)
            # the sums of the magnitudes each gradient element adds up
            (mag,) = torch.autograd.grad((want * w.abs()).sum(), x)
            torch.cuda.synchronize()
            if out.shape != (n, f) or not torch.isfinite(out).all() \
                    or not torch.equal(out, want):
                raise AssertionError(f"ell_aggregate F={f} {mode}: the kernel "
                                     "path differs from the plain path")
            # the backward scatters with index_add_, atomics in no fixed
            # order: equal up to f32 summation order, whose error is below
            # (terms - 1) * 2^-24 of the summed magnitudes; at most 192 + 1
            # terms here, so 2^-16 of them bounds it
            gerr = float((grad - want_grad).abs().max())
            if bool(((grad - want_grad).abs() > 2.0 ** -16 * mag).any()):
                raise AssertionError(f"ell_aggregate F={f} {mode}: gradients "
                                     f"differ by {gerr}")
            runs.append({"features": f, "mode": mode, "grad_max_abs_err": gerr})
    ones = sops.ell_aggregate(torch.ones((n, 8), device=dev), adj, "sum")
    if not torch.equal(ones, deg[:, None].expand(n, 8)):
        raise AssertionError("ell_aggregate: sums of ones are not the degrees")
    launches = _read_launches(("segment_spmm",))
    by_kernel = dict(ss.segment_spmm.kernel_launches)
    if launches["segment_spmm"] < 1 or min(by_kernel.values()) < 1:
        raise AssertionError(f"ell_aggregate missed a kernel: {launches}, "
                             f"{by_kernel}")

    # times at F = 128 and 1433, f32 sum, against the plain version and one
    # library call, the CSR sparse product
    valid = adj >= 0
    crow = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    crow[1:] = torch.cumsum(valid.sum(dim=1), 0)
    csr = torch.sparse_csr_tensor(crow, adj[valid].to(torch.int64),
                                  torch.ones(int(crow[-1]), device=dev),
                                  size=(n, n), check_invariants=False)
    timing = {}
    ids = adj[valid]
    slab_bytes = common.load_kernel("segment_spmm").segment_spmm_slab_bytes()
    for f in SPMM_WIDTHS:
        x = torch.randn((n, f), generator=torch.Generator(device=dev)
                        .manual_seed(f + 1), device=dev)
        want = ss.segment_spmm(x, adj)
        lib_err = float((torch.sparse.mm(csr, x) - want).abs().max())
        widths = _load_widths_by_alignment(ids.cpu(), f, x.element_size())
        for _ in range(50):            # the card at its clocks, not idle
            ss.segment_spmm(x, adj)
        ms = graph_ms(lambda: ss.segment_spmm(x, adj), 20)
        gathered = ids.numel() * f * x.element_size()
        timing[f"F{f}"] = {
            "shape": [n, adj.shape[1], f], "dtype": "float32", "mode": "sum",
            "ms": ms,
            "eager_ms": eager_ms(lambda: ss.segment_spmm(x, adj), 20),
            "plain_ms": eager_ms(lambda: segment_spmm_ref(x, adj), 2),
            "library_ms": graph_ms(lambda: torch.sparse.mm(csr, x), 20),
            "library": "torch.sparse.mm (CSR, f32)",
            "library_max_abs_diff_vs_kernel": lib_err,
            "bound_ms": _rows_bound_ms(x, adj, n), "bound_by": "bytes",
            "slab_bytes": slab_bytes,
            "slab_cols": slab_bytes // x.element_size(),
            "slabs": ss.plan(n, adj.shape[1], f, x.element_size(),
                             slab_bytes).slabs,
            "load_widths_derived": {f"{b}B": c for b, c in widths.items()},
            "gathered_gb": gathered / 1e9,
            "gathered_gb_per_s": gathered / (ms * 1e-3) / 1e9}
    out = {"phase": "spmm", "graph": "twitter", "n": n,
           "dmax": adj.shape[1], "valid_slots": int(valid.sum()),
           "runs": runs, "degree_check": True, "launches": launches,
           "launches_by_kernel": by_kernel, "kernel": timing}
    del csr, x
    torch.cuda.empty_cache()
    emit(out)
    return out


def _attn_pairs(sq: int, q_offset: int, sk: int, window: int) -> int:
    """Visible (query, key) pairs of causal attention: query i at position
    q_offset + i sees keys max(0, p - window + 1) .. min(p, sk - 1)."""
    p = q_offset + np.arange(sq, dtype=np.int64)
    hi = np.minimum(p, sk - 1)
    lo = np.maximum(0, p - window + 1) if window > 0 else np.zeros_like(p)
    return int(np.maximum(hi - lo + 1, 0).sum())


def _attn_bound(q, k, window: int, q_offset: int):
    """(bound ms, bound_by, flops, bytes) of one attention call on (B, H,
    Sq, D) q and (B, Hkv, Sk, D) k: 4·D flops per visible pair and head at
    the bf16 tensor-core peak; q and the output once, and each kv head's
    visible K and V rows once (contiguous from the lowest visible key to
    the highest, all the kernel reads)."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    flops = 4 * d * h * b * _attn_pairs(sq, q_offset, sk, window)
    p_hi = min(q_offset + sq - 1, sk - 1)
    p_lo = max(0, q_offset - window + 1) if window > 0 else 0
    keys = p_hi - p_lo + 1
    nbytes = q.element_size() * (2 * b * h * sq * d + 2 * b * hkv * keys * d)
    t_ops, t_bytes = flops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes",
            flops, nbytes)


class _Recorder:
    """Wraps ``models.layers.attention`` (what every LM layer calls) and
    keeps the arguments of the calls of layers 0 and 1 — gemma2's first
    local and first global layer — of the latest step."""

    def __init__(self, n_layers: int):
        self.n_layers, self.calls, self.step = n_layers, 0, {}
        self._orig = layers.attention

    def __enter__(self):
        def recording(q, k, v, **kw):
            i = self.calls % self.n_layers
            self.calls += 1
            if i < 2:
                self.step[i] = (q, k, v, kw)
            return self._orig(q, k, v, **kw)
        layers.attention = recording
        return self

    def __exit__(self, *exc):
        layers.attention = self._orig


def _check_attention_at(rec: dict, what: str, chunk: int) -> dict:
    """Check 1: the kernel against the plain attention at the model's own
    q/k/v of layers 0 (local) and 1 (global), to one bf16 ulp."""
    out = {}
    for i, (q, k, v, kw) in sorted(rec.items()):
        kw = dict(kw, use_kernel=True)
        got = layers.attention(q, k, v, **kw)
        want = layers.attention(q, k, v, **dict(kw, use_kernel=False,
                                                chunk=chunk))
        torch.cuda.synchronize()
        excess, err = _bf16_err(got, want)
        out[f"layer{i}"] = {"window": kw["window"], "q_offset": kw["q_offset"],
                            "q": list(q.shape), "k": list(k.shape),
                            "max_abs_err": err, "rtol": BF16_RTOL,
                            "atol": BF16_ATOL}
        if excess > 0 or not torch.isfinite(got).all():
            raise AssertionError(f"lm {what} layer {i}: kernel attention "
                                 f"differs from the plain one by {err}")
    return out


def _time_attention_at(rec: dict, reps: int, plain_reps: int,
                       chunk: int, graph: bool) -> dict:
    """The kernel (which of them ran, its split count, its achieved rates),
    the plain version (query-chunked as the model's plain path runs it) and
    ``scaled_dot_product_attention`` (it has no softcap: timed with softcap
    0 and the layer's mask, a yardstick only) at the model's own q/k/v of
    layers 0 and 1."""
    out = {}
    for i, (q, k, v, kw) in sorted(rec.items()):
        qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        off, win, cap = kw["q_offset"], kw["window"], kw["softcap"]

        def kernel():
            return fa.flash_attention(qh, kh, vh, window=win, softcap=cap,
                                      q_offset=off)

        def plain():
            return layers.attention(q, k, v, q_offset=off, window=win,
                                    softcap=cap, use_kernel=False, chunk=chunk)

        bound, by, flops, nbytes = _attn_bound(qh, kh, win, off)
        how = fa.dispatch(qh, kh, window=win, q_offset=off)
        ms = graph_ms(kernel, reps) if graph else eager_ms(kernel, reps)
        row = {"window": win, "softcap": cap, "q_offset": off,
               "q": list(qh.shape), "kv": list(kh.shape),
               "kernel": how["kernel"], "n_split": how["n_split"],
               "ms": ms, "eager_ms": eager_ms(kernel, reps),
               "host_ms": host_ms(kernel, reps),
               "plain_ms": eager_ms(plain, plain_reps),
               "bound_ms": bound, "bound_by": by, "flops": flops,
               "bytes": nbytes, "tflop_per_s": flops / ms / 1e9,
               "gb_per_s": nbytes / ms / 1e6, "library_ms": None,
               "library": "none (softcap)"}
        if win == 0 and qh.shape[2] == kh.shape[2]:
            def library():
                return torch.nn.functional.scaled_dot_product_attention(
                    qh, kh, vh, is_causal=True, enable_gqa=True)
        else:
            pq = off + torch.arange(qh.shape[2], device=q.device)[:, None]
            pk = torch.arange(kh.shape[2], device=q.device)[None, :]
            mask = (pq >= pk) & ((pq - pk < win) if win else True)

            def library():
                return torch.nn.functional.scaled_dot_product_attention(
                    qh, kh, vh, attn_mask=mask[None, None], enable_gqa=True)
        row["library_softcap0_ms"] = (graph_ms(library, reps) if graph
                                      else eager_ms(library, reps))
        row["library"] = ("none (softcap); F.scaled_dot_product_attention "
                          "timed at the same shape and mask with softcap 0 "
                          "(is_causal, else a boolean mask)")
        out[f"layer{i}"] = row
    return out


def _decode_step_breakdown(params, cfg, cache_k, cache_v, pos: int) -> dict:
    """Where one decode step of the serving batch (every slot at ``pos``,
    the cache of the serve) spends its time: the step as LMServer calls it,
    eagerly (wall time with a sync after it, and the host's time to issue
    it: the call's return), the same step replayed from a CUDA graph
    (device time with no host in the way), and a torch.profiler trace of
    one eager step (each kernel's device time). The device's idle share of
    an eager step is 1 - kernel time / wall time, on the untraced wall
    (the profiler slows the host down)."""
    tok = torch.zeros((cache_k.shape[1], 1), dtype=torch.int32,
                      device=cache_k.device)

    def step():
        return T.decode_step_inplace(params, tok, cache_k, cache_v, pos,
                                     cfg)[0]

    step()
    torch.cuda.synchronize()
    wall, issue = [], []
    for _ in range(7):
        t = time.perf_counter()
        step()
        issue.append(time.perf_counter() - t)
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t)
    graph = graph_ms(step, 1, replays=5)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        step()
        torch.cuda.synchronize()
        traced_wall = time.perf_counter() - t
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        rows.append((us, e.key, e.count))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e3
    wall_ms = float(np.median(wall)) * 1e3
    attn = sum(r[0] for r in rows if "split_kernel" in r[1]
               or "combine_kernel" in r[1]) / 1e3
    return {"pos": pos, "slots": int(cache_k.shape[1]),
            "eager_wall_ms": wall_ms,
            "eager_wall_ms_all": [w * 1e3 for w in wall],
            "host_issue_ms": float(np.median(issue)) * 1e3,
            "graph_ms": graph,
            "traced_wall_ms": traced_wall * 1e3,
            "traced_kernel_ms": busy if rows else None,
            "traced_attention_kernel_ms": attn if rows else None,
            "traced_kernels": len(rows),
            "device_idle_share": 1 - busy / wall_ms if rows else None,
            "top_kernels": [{"name": k[:120], "count": c, "ms": us / 1e3}
                            for us, k, c in rows[:12]]}


def _logit_check(got, want, what: str) -> dict:
    """Checks 2 and 3: finite logits of one shape whose relative L2 error is
    at most LOGIT_REL, choosing the same token wherever the reference's
    top-1 margin exceeds the largest error."""
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"lm {what}: logits {tuple(got.shape)} are not "
                             f"finite or not {tuple(want.shape)}")
    err = float((got - want).abs().max())
    rel = float(torch.linalg.vector_norm(got - want)
                / torch.linalg.vector_norm(want))
    top = torch.topk(want, 2, dim=-1).values
    margin = float((top[..., 0] - top[..., 1]).min())
    same = bool(torch.equal(got.argmax(-1), want.argmax(-1)))
    if rel > LOGIT_REL or (margin > 2 * err and not same):
        raise AssertionError(f"lm {what}: logits differ (rel L2 {rel}, max "
                             f"abs {err}, same token {same})")
    return {"shape": list(got.shape), "max_abs_err": err, "rel_l2": rel,
            "limit_rel_l2": LOGIT_REL, "same_token": same,
            "top1_margin": margin}


def phase_lm(dev) -> dict:
    """gemma2-9b's CONFIG (bf16, 42 layers, d 3584, vocab 256,000, tied
    head) served by the port's LMServer as the JAX package's serve_lm
    serves it: 4 slots, 8 requests of 8,192-token prompts from numpy's
    seeded generator, 32 tokens each, max_len 8,225 — every attention call
    of every prefill and decode round on the flash_attention kernel."""
    cfg = get_arch(LM_ARCH).config
    torch.cuda.empty_cache()
    free_before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    params = T.init_params(cfg, generator=torch.Generator(device=dev)
                           .manual_seed(0), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    param_bytes = sum(x.numel() * x.element_size()
                      for _, x in layers.leaves(params))
    server = serve.LMServer(params, cfg, slots=LM_SLOTS, max_len=LM_MAX_LEN)
    cache_bytes = 2 * server.cache_k.numel() * server.cache_k.element_size()

    prefill_s, prefill_l, round_s, round_l = [], [], [], []
    add, rnd = server.add_request, server.decode_round

    def timed(fn, secs, counts):
        def run(*a):
            l0 = fa.flash_attention.launches
            t0 = time.perf_counter()
            r = fn(*a)               # ends in a host read of the argmax
            if r is not False:
                secs.append(time.perf_counter() - t0)
                counts.append(fa.flash_attention.launches - l0)
            return r
        return run

    server.add_request = timed(add, prefill_s, prefill_l)
    server.decode_round = timed(rnd, round_s, round_l)
    _reset_launches()
    with torch.inference_mode(), _Recorder(cfg.n_layers) as rec:
        t = time.perf_counter()
        outputs = serve.serve_requests(
            server, requests=LM_REQUESTS, prompt_len=LM_PROMPT, gen=LM_GEN,
            rng=np.random.default_rng(0))
        serve_s = time.perf_counter() - t
    launches = _read_launches(("flash_attention",))
    by_kernel = dict(fa.flash_attention.kernel_launches)
    peak = torch.cuda.max_memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    n_tokens = sum(len(v) for v in outputs.values())
    expect = cfg.n_layers * (len(prefill_s) + len(round_s))
    if sorted(outputs) != list(range(LM_REQUESTS)) \
            or any(len(v) != LM_GEN or min(v) < 0 or max(v) >= cfg.vocab
                   for v in outputs.values()):
        raise AssertionError("lm: the requests' token streams are incomplete")
    if len(prefill_s) != LM_REQUESTS or launches["flash_attention"] != expect \
            or set(prefill_l + round_l) != {cfg.n_layers}:
        raise AssertionError(f"lm: not every prefill and decode round ran the "
                             f"kernel in each layer: {launches}, prefills "
                             f"{prefill_l}, rounds {round_l}")
    # every prefill call on the tensor-core kernel, every decode call split
    if by_kernel != {"f32": 0, "prefill": cfg.n_layers * len(prefill_s),
                     "split": cfg.n_layers * len(round_s)}:
        raise AssertionError(f"lm: the bf16 calls did not take the prefill "
                             f"and split kernels: {by_kernel}")

    with torch.inference_mode():
        # the kernel at a decode round's own q/k/v (4 slots, the last round)
        decode_rec = dict(rec.step)
        timing = {"decode": _time_attention_at(decode_rec, 20, 5,
                                               cfg.attn_chunk, graph=True)}
        if any(row["kernel"] != "split" or row["n_split"] < 2
               for row in timing["decode"].values()):
            raise AssertionError(f"lm: a decode call did not split over the "
                                 f"keys: {timing['decode']}")
        step = _decode_step_breakdown(params, cfg, server.cache_k,
                                      server.cache_v,
                                      decode_rec[1][3]["q_offset"])
        del server, decode_rec, rec
        torch.cuda.empty_cache()

        # the first request again: its prompt is the generator's first draw
        prompt = np.random.default_rng(0).integers(0, cfg.vocab, LM_PROMPT) \
            .astype(np.int32)
        toks = torch.from_numpy(prompt[None]).to(dev)
        with _Recorder(cfg.n_layers) as rec:
            logits, ck, cv = T.prefill_step(params, toks, cfg)
        checks = {"attention_prefill": _check_attention_at(
            rec.step, "prefill", cfg.attn_chunk)}
        timing["prefill"] = _time_attention_at(rec.step, 10, 1,
                                               cfg.attn_chunk, graph=False)
        if any(row["kernel"] != "prefill"
               for row in timing["prefill"].values()):
            raise AssertionError(f"lm: a prefill call did not take the "
                                 f"tensor-core kernel: {timing['prefill']}")
        del rec
        plain, _, _ = T.prefill_step(params, toks, cfg, use_kernel=False)
        checks["prefill_logits"] = _logit_check(logits, plain, "prefill")
        del plain
        shape = (cfg.n_layers, 1, LM_MAX_LEN, cfg.n_kv_heads, cfg.head_dim)
        cache_k = torch.zeros(shape, dtype=cfg.torch_dtype, device=dev)
        cache_v = torch.zeros(shape, dtype=cfg.torch_dtype, device=dev)
        cache_k[:, :, :LM_PROMPT] = ck
        cache_v[:, :, :LM_PROMPT] = cv
        del ck, cv
        tok = logits.argmax(-1).to(torch.int32)[:, None]
        with _Recorder(cfg.n_layers) as rec:
            dec, _, _ = T.decode_step_inplace(params, tok, cache_k.clone(),
                                              cache_v.clone(), LM_PROMPT, cfg)
        checks["attention_decode"] = _check_attention_at(
            rec.step, "decode", cfg.attn_chunk)
        del rec
        dec_plain, _, _ = T.decode_step_inplace(params, tok, cache_k, cache_v,
                                                LM_PROMPT, cfg,
                                                use_kernel=False)
        checks["decode_logits"] = _logit_check(dec, dec_plain, "decode")
        del cache_k, cache_v, dec_plain
        torch.cuda.empty_cache()
        full, _ = T.forward(params, torch.cat([toks, tok], dim=1), cfg)
        checks["prefill_decode_vs_forward"] = _logit_check(
            dec, full[:, -1], "prefill + decode vs forward")
        del full
    checks_peak = torch.cuda.max_memory_allocated(dev)
    torch.cuda.empty_cache()

    per_kind = {kind: sum(timing[kind][f"layer{i}"]["ms"]
                          * int((cfg.windows > 0).sum() if i == 0
                                else (cfg.windows == 0).sum())
                          for i in (0, 1))
                for kind in ("prefill", "decode")}
    prefill_p50, round_p50 = _ms_pct(prefill_s, 50), _ms_pct(round_s, 50)
    out = {"phase": "lm", "arch": cfg.name, "config": {
               k: v for k, v in vars(cfg).items() if k != "moe"},
           "param_count": cfg.param_count(), "param_bytes": param_bytes,
           "cache_bytes": cache_bytes,
           "memory_allocated_before": free_before, "init_s": init_s,
           "slots": LM_SLOTS, "requests": LM_REQUESTS,
           "prompt_len": LM_PROMPT, "gen": LM_GEN, "max_len": LM_MAX_LEN,
           "prefills": len(prefill_s), "decode_rounds": len(round_s),
           "prefill_ms_p50": prefill_p50, "prefill_ms_p99": _ms_pct(prefill_s, 99),
           "decode_round_ms_p50": round_p50,
           "decode_round_ms_p99": _ms_pct(round_s, 99),
           "decode_round_ms_slowest": sorted(
               ([round(x * 1e3, 3), i] for i, x in enumerate(round_s)),
               reverse=True)[:4],
           "decode_step": step,
           "serve_s": serve_s, "generated_tokens": n_tokens,
           "tokens_per_s": n_tokens / serve_s,
           "decode_tokens_per_s": LM_SLOTS * len(round_s) / sum(round_s),
           "max_memory_allocated": peak,
           "max_memory_allocated_checks": checks_peak, "launches": launches,
           "launches_by_kernel": by_kernel,
           "kernel_ms_per_prefill": per_kind["prefill"],
           "kernel_ms_per_decode_round": per_kind["decode"],
           "kernel_share": {"prefill": per_kind["prefill"] / prefill_p50,
                            "decode_round": per_kind["decode"] / round_p50},
           "kernel": timing, "checks": checks}
    del params
    torch.cuda.empty_cache()
    emit(out)
    return out


def kernel_line(kernels: dict, twitter: dict, recsys: dict, spmm: dict,
                lm: dict, rebalance: dict) -> dict:
    pa_timed = {c["shape"][2]: c for c in kernels["partition_affinity"]["cases"]
                if "ms" in c}
    pa_case = pa_timed[K_MAX]
    fc_timed = {(c["case"], c["policy"]): c
                for c in kernels["fused_chooser"]["cases"] if "ms" in c}
    fc_case = fc_timed[("session", "sdp")]
    pa_cases = kernels["partition_affinity"]["cases"]
    fc_cases = kernels["fused_chooser"]["cases"]
    eb_cases = kernels["embedding_bag"]["cases"]
    worst_pa = max(c["max_abs_err"] for c in pa_cases)
    worst_fc = max(c["max_abs_err"] for c in fc_cases)
    eb_p99, eb_bulk = (recsys["kernel"]["serve_p99"],
                       recsys["kernel"]["serve_bulk"])
    timed = ("ms", "eager_ms", "plain_ms", "bound_ms", "library_ms")
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
         "library_ms": pa_case["library_ms"],
         "launch_floor_ms": pa_case["launch_floor_ms"],
         "k200": {k: pa_timed[200][k] for k in (
             "shape", "ms", "plain_ms", "bound_ms", "library_ms",
             "launch_floor_ms")},
         # the rebalance's histograms at W = n, launched from its own run
         "rebalance": {"launches": rebalance["launches"][
             "partition_affinity"], **rebalance["partition_affinity"]}},
        {"name": "fused_chooser", "route": "cuda",
         "source": "src/repro_torch/csrc/fused_chooser.cu",
         "replaces": "src/repro/kernels/fused_chooser/fused_chooser.py:245",
         "launches": twitter["launches"]["fused_chooser"],
         "max_abs_err": worst_fc, "shape": fc_case["shape"],
         "cases": len(fc_cases),
         "mismatches": sum(c["max_abs_err"] != 0 for c in fc_cases),
         "ms": fc_case["ms"], "plain_ms": fc_case["plain_ms"],
         "bound_ms": fc_case["bound_ms"], "bound_by": "bytes",
         "library_ms": None,
         "launches_by_kernel": twitter["launches_by_kernel"],
         "policies_ms": {p: fc_timed[("session", p)]["ms"]
                         for p in ("sdp", "ldg", "random")},
         **{label: {k: fc_timed[(label, "sdp")][k]
                    for k in ("shape", "kernel", "ms", "eager_ms",
                              "plain_ms", "bound_ms")}
            for label in ("k40", "grqc_wide", "k200", "k1000")}},
        {"name": "embedding_bag", "route": "cuda",
         "source": "src/repro_torch/csrc/embedding_bag.cu",
         "replaces": "src/repro/kernels/embedding_bag/embedding_bag.py:49",
         "launches": recsys["launches"]["embedding_bag"],
         "max_abs_err": max(c["max_abs_err"] for c in eb_cases),
         "shape": [eb_p99["bags"], eb_p99["slots"], eb_p99["dim"]],
         "cases": len(eb_cases),
         "mismatches": sum(c["max_abs_err"] != 0 for c in eb_cases),
         "ms": eb_p99["ms"], "plain_ms": eb_p99["plain_ms"],
         "bound_ms": eb_p99["bound_ms"], "bound_by": "bytes",
         "library_ms": eb_p99["library_ms"],
         "library": "torch.nn.functional.embedding_bag (bf16 output)",
         "launches_by_kernel": recsys["launches_by_kernel"],
         "all_slot_bound_ms": eb_p99["all_slot_bound_ms"],
         "all_slot_gb_per_s": eb_p99["all_slot_gb_per_s"],
         "requests_in_turn": eb_p99["requests"],
         "serve_bulk": {"shape": [eb_bulk["bags"], eb_bulk["slots"],
                                  eb_bulk["dim"]],
                        **{k: eb_bulk[k] for k in timed + (
                            "all_slot_bound_ms", "all_slot_gb_per_s")}}},
    ]
    timed_scan = timed + ("eager_ms", "plain_eager_ms", "bound_by", "kernel",
                          "large_ms")
    for name, source, replaces, main, others in (
            ("window_prep", "src/repro_torch/csrc/window_prep.cu",
             "src/repro/kernels/fused_chooser/ops.py:113",
             ("session", "stream"), (("grqc_wide", "stream"),
                                     ("odd", "stream"))),
            ("window_rng", "src/repro_torch/csrc/window_rng.cu",
             "src/repro/core/transition.py:374", None, ()),
            ("add_window_choose", "src/repro_torch/csrc/fused_chooser.cu",
             "src/repro/core/windowed.py:167",
             ("session", "first"), (("session", "crafted"),
                                    ("grqc_wide", "crafted"),
                                    ("k200", "crafted"),
                                    ("k1000", "crafted")))):
        cases = kernels[name]["cases"]
        timed_cases = {(c.get("case"), c.get("window")): c
                       for c in cases if "ms" in c}
        case = timed_cases[main if main else (None, None)]
        rows.append(
            {"name": name, "route": "cuda", "source": source,
             # no Pallas kernel: the lax.scan / XLA ops of the JAX package
             "replaces": replaces,
             "launches": twitter["launches"][name],
             "max_abs_err": max(c["max_abs_err"] for c in cases),
             "shape": case["shape"], "cases": len(cases),
             "mismatches": sum(c["max_abs_err"] != 0 for c in cases),
             "ms": case["ms"], "plain_ms": case["plain_ms"],
             "bound_ms": case["bound_ms"], "bound_by": case["bound_by"],
             "library_ms": None,
             **{k: case[k] for k in ("eager_ms", "plain_eager_ms", "kernel",
                                     "large_ms") if k in case},
             **({"launches_by_kernel": twitter["add_launches_by_kernel"]}
                if name == "add_window_choose" else {}),
             **{"_".join(o): {k: timed_cases[o][k] for k in
                              ("shape",) + timed_scan if k in timed_cases[o]}
                for o in others}})
    fa_cases = kernels["flash_attention"]["cases"]
    fa_main = lm["kernel"]["prefill"]["layer1"]          # a global layer
    rows.append(
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/flash_attention.py:90",
         "launches": lm["launches"]["flash_attention"],
         "max_abs_err": max(c["max_abs_err"] for c in fa_cases),
         "cases": len(fa_cases),
         "shape": [fa_main["q"][0], fa_main["q"][1], fa_main["kv"][1],
                   fa_main["q"][2], fa_main["kv"][2], fa_main["q"][3]],
         "ms": fa_main["ms"], "plain_ms": fa_main["plain_ms"],
         "bound_ms": fa_main["bound_ms"], "bound_by": fa_main["bound_by"],
         "library_ms": None, "library": fa_main["library"],
         "library_softcap0_ms": fa_main["library_softcap0_ms"],
         "kernel": fa_main["kernel"], "tflop_per_s": fa_main["tflop_per_s"],
         "launches_by_kernel": lm["launches_by_kernel"],
         **{f"{kind}_{name}": {k: lm["kernel"][kind][layer][k]
                               for k in timed + (
                                   "bound_by", "window", "kernel", "n_split",
                                   "tflop_per_s", "gb_per_s",
                                   "library_softcap0_ms")
                               if k in lm["kernel"][kind][layer]}
            for kind in ("prefill", "decode")
            for name, layer in (("local", "layer0"), ("global", "layer1"))
            if (kind, layer) != ("prefill", "layer1")}})
    sp_cases = kernels["segment_spmm"]["cases"]
    sp_main, sp_wide = (spmm["kernel"][f"F{f}"] for f in SPMM_WIDTHS)
    rows.append(
        {"name": "segment_spmm", "route": "cuda",
         "source": "src/repro_torch/csrc/segment_spmm.cu",
         "replaces": "src/repro/kernels/segment_spmm/segment_spmm.py:48",
         "launches": spmm["launches"]["segment_spmm"],
         "max_abs_err": max(c["max_abs_err"] for c in sp_cases),
         "cases": len(sp_cases),
         "mismatches": sum(c["max_abs_err"] != 0 for c in sp_cases),
         "shape": sp_main["shape"], "ms": sp_main["ms"],
         "plain_ms": sp_main["plain_ms"], "bound_ms": sp_main["bound_ms"],
         "bound_by": "bytes", "library_ms": sp_main["library_ms"],
         "library": sp_main["library"],
         "launches_by_kernel": spmm["launches_by_kernel"],
         "slab_bytes": sp_main["slab_bytes"],
         "gathered_gb_per_s": sp_main["gathered_gb_per_s"],
         "wide": {k: sp_wide[k] for k in timed + (
             "shape", "slabs", "gathered_gb_per_s")}})
    return {"kernels": rows}


def main() -> int:
    info = phase_device()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    graphs = spmm_graphs(dev)
    kernels = phase_kernels(dev, graphs)
    spmm = phase_spmm(dev, graphs)
    del graphs
    phase_grqc(dev)
    twitter, twitter_part, twitter_g, twitter_s = phase_twitter(dev)
    rebalance = phase_rebalance(dev, twitter_part)
    del twitter_part
    phase_lifecycle(dev, twitter_g, twitter_s)
    del twitter_g, twitter_s
    recsys = phase_recsys(dev)
    lm = phase_lm(dev)
    emit(kernel_line(kernels, twitter, recsys, spmm, lm, rebalance))
    print(info["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
