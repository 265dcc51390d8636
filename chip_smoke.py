"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc``, holds each
against its plain PyTorch version on the card (bit-equal, no tolerance,
for the exact kernels; flash_attention's f32 sums run in another order
than the plain version's, so it is held at tests/test_kernels.py's 2e-5 in
f32 and at one bf16 ulp in bf16), runs the streaming session on grqc against the
port's faithful per-event engine, drives the full-width session — the
paper's largest dataset, twitter at scale 1.0 — through
``Partitioner.feed`` with both session kernels on the path, and serves
the two-tower recsys model at its full vocabulary and widths (bf16
tables, 51.54 GB on the card) through ``serve_score`` and
``score_candidates`` with the ``embedding_bag`` kernel on the path,
aggregates twitter's ELL adjacency through ``ell_aggregate`` with the
``segment_spmm`` kernel on the path, and serves gemma2-9b at its full
width and depth (bf16, 18.48 GB of params, an 11.32 GB KV cache) through
``LMServer`` — 8 requests of 8,192-token prompts, 32 tokens each — with
every attention call of prefill and decode on the ``flash_attention``
kernel. One JSON line per phase; the last line is ``{"ok": true,
"device": {...}}``.
Any failure raises and exits non-zero without that line. Needs one CUDA
card; imports nothing of JAX.
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
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.shapes import RECSYS_SHAPES  # noqa: E402
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
from repro_torch.kernels.embedding_bag import embedding_bag as eb  # noqa: E402
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as fa  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.fused_chooser import fused_chooser as fk  # noqa: E402
from repro_torch.kernels.fused_chooser import ops as fops  # noqa: E402
from repro_torch.kernels.fused_chooser.ref import fused_window_choose_ref  # noqa: E402
from repro_torch.kernels.partition_affinity import ops as pops  # noqa: E402
from repro_torch.kernels.partition_affinity import partition_affinity as pa  # noqa: E402
from repro_torch.kernels.partition_affinity.ref import partition_affinity_ref  # noqa: E402
from repro_torch.kernels.segment_spmm import ops as sops  # noqa: E402
from repro_torch.kernels.segment_spmm import segment_spmm as ss  # noqa: E402
from repro_torch.kernels.segment_spmm.ref import segment_spmm_ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import recsys as RS  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor cores (data sheet)
EVENT_ARGS = dict(warmup_frac=0.2, del_every=3, edge_del_every=5, seed=0)
# the full-width session's kernel shapes: a window of 256 events, twitter
# degree-capped to 192 (``Partitioner.from_stream`` sizes the rows to the
# stream's max_deg exactly), 16 partition slots
WINDOW, TWITTER_CAP, K_MAX = 256, 192, 16
SESSION_SHAPE = (WINDOW, TWITTER_CAP, K_MAX)
# embedding_bag cases (V, D, B, L, lowest id): tests/test_kernels.py's
# shapes, the serve shape (4096 bags of 8 slots at D = 256), and rows past
# 2^23 at D = 256, where idx * D passes 2^31
BAG_CASES = ((10, 8, 4, 1, -1), (50, 24, 12, 5, -1), (100, 130, 7, 9, -1),
             (30, 256, 3, 4, -1), (1 << 20, 256, 4096, 8, -1),
             ((1 << 23) + 4096, 256, 1024, 8, 1 << 23))
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
# the LM phase: gemma2-9b's CONFIG served as serve_lm serves it
LM_ARCH, LM_SLOTS, LM_REQUESTS, LM_PROMPT, LM_GEN = "gemma2-9b", 4, 8, 8192, 32
LM_MAX_LEN = LM_PROMPT + LM_GEN + 1
# logits of two bf16 paths through 42 layers (kernel vs plain attention;
# prefill + decode vs one forward over S + 1 tokens, whose products run at
# other shapes): each rounds the residual stream to bf16 (2^-8) at other
# places, so they drift apart by a few bf16 ulps; a wrong mask, position
# or cache slot moves the logits by O(1). Limit on the relative L2 error:
LOGIT_REL = 2.0 ** -4
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


def bag_case(dev, v, d, b, l, dtype, seed, low=-1):
    """A (V, D) table in ``dtype`` and (B, L) int32 bags: ids in [low, V),
    about a quarter of the slots -1, bag 0 all padding — built by hand,
    since full-vocab ``make_batch`` ids are almost never -1."""
    g = torch.Generator(device=dev).manual_seed(seed)
    table = torch.randn((v, d), generator=g, device=dev).to(dtype)
    idx = torch.randint(low, v, (b, l), generator=g, device=dev,
                        dtype=torch.int32)
    pad = torch.rand((b, l), generator=g, device=dev) < 0.25
    idx = torch.where(pad, torch.full_like(idx, -1), idx)
    idx[0] = -1
    return table, idx


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
    libs = common.build_kernels(["partition_affinity", "fused_chooser",
                                 "embedding_bag", "flash_attention",
                                 "segment_spmm"])
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


def check_partition_affinity(dev) -> dict:
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
    return pa_out


def check_fused_chooser(dev) -> dict:
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
    return fc_out


def check_embedding_bag(dev) -> dict:
    """f32 and bf16 tables, sum and mean, every case with -1 slots and an
    all-padding bag (BAG_CASES)."""
    eb_out = {"name": "embedding_bag", "cases": []}
    for v, d, b, l, low in BAG_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            table, idx = bag_case(dev, v, d, b, l, dtype, seed=v + b, low=low)
            for mode in ("sum", "mean"):
                got = eb.embedding_bag(table, idx, mode=mode)
                want = embedding_bag_ref(table, idx, mode=mode)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                same = torch.equal(got, want)
                eb_out["cases"].append(
                    {"shape": [v, d, b, l], "dtype": str(dtype)[6:],
                     "mode": mode, "max_abs_err": err,
                     "max_row_offset": int(idx.max()) * d,
                     "padding_slots": int((idx < 0).sum())})
                if not same or err or got[0].any():
                    raise AssertionError(
                        f"embedding_bag {v}x{d} bags {b}x{l} {dtype} {mode}: "
                        f"kernel differs from the plain version by {err}")
            del table, idx
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
    2e-5; gemma2's own prefill (S = 8,192, local and global) and decode
    (4 slots against an 8,225-slot cache) shapes in bf16, through the
    model's (B, S, H, D) views, at one bf16 ulp."""
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
    cfg = get_arch(LM_ARCH).config
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    gemma = [((1, hq, hkv, LM_PROMPT, LM_PROMPT, hd), dict(window=w))
             for w in (cfg.window_pattern)]
    gemma += [((LM_SLOTS, hq, hkv, 1, LM_MAX_LEN, hd),
               dict(window=w, q_offset=LM_PROMPT + 5))
              for w in cfg.window_pattern]
    for (b, h, hkv_, sq, sk, d), kw in gemma:
        kw = dict(kw, softcap=cfg.attn_softcap)
        q, k, v = _attn_inputs(dev, b, h, hkv_, sq, sk, d, torch.bfloat16,
                               seed=sq + kw["window"], layout="bshd")
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
                                "max_abs_err": err, "rtol": BF16_RTOL,
                                "atol": BF16_ATOL})
        if excess > 0:
            raise AssertionError(f"flash_attention gemma2 {[b, h, sq, sk]} "
                                 f"{kw}: kernel differs from the plain "
                                 f"version by {err} (beyond one bf16 ulp)")
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
    out = {"phase": "kernels",
           "partition_affinity": check_partition_affinity(dev),
           "fused_chooser": check_fused_chooser(dev),
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
             "embedding_bag": eb.embedding_bag,
             "flash_attention": fa.flash_attention,
             "segment_spmm": ss.segment_spmm}
SESSION_KERNELS = ("partition_affinity", "fused_chooser")


def _reset_launches():
    for fn in _WRAPPERS.values():
        fn.launches = 0


def _read_launches(names=SESSION_KERNELS) -> dict:
    return {name: _WRAPPERS[name].launches for name in names}


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


def time_bag(table, idx, reps: int, plain_in_graph: bool) -> dict:
    """The kernel (mean bags, as the towers call it), its plain version and
    ``torch.nn.functional.embedding_bag`` — the yardstick, over the same
    ids compacted into the offsets form outside the timing; with a bf16
    table it returns bf16 — on the same table and ids."""
    torch.cuda.empty_cache()       # earlier graphs' pools, before big temporaries
    valid = idx >= 0
    flat = idx[valid].to(torch.int64)
    offsets = torch.zeros(idx.shape[0], dtype=torch.int64, device=idx.device)
    offsets[1:] = torch.cumsum(valid.sum(dim=1), 0)[:-1]

    def kernel():
        return eb.embedding_bag(table, idx, mode="mean")

    def plain():
        return embedding_bag_ref(table, idx, mode="mean")

    def library():
        return torch.nn.functional.embedding_bag(flat, table, offsets,
                                                 mode="mean")

    lib_out = library()
    out = {"bags": idx.shape[0], "slots": idx.shape[1],
           "dim": table.shape[1], "table_dtype": str(table.dtype)[6:],
           "ms": graph_ms(kernel, reps), "eager_ms": eager_ms(kernel, reps),
           "library_ms": graph_ms(library, reps),
           "library_eager_ms": eager_ms(library, reps),
           "library_out_dtype": str(lib_out.dtype)[6:],
           "library_max_abs_diff_vs_kernel": float(
               (lib_out.float() - kernel()).abs().max()),
           "bound_ms": _rows_bound_ms(table, idx, idx.shape[0]),
           "bound_by": "bytes"}
    del lib_out
    if plain_in_graph:
        out["plain_ms"] = graph_ms(plain, max(reps // 5, 1))
        out["plain_eager_ms"] = eager_ms(plain, max(reps // 5, 1))
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
    peak = torch.cuda.max_memory_allocated(dev)
    if launches["embedding_bag"] < 1:
        raise AssertionError(f"recsys serving missed the kernel: {launches}")
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

    # the kernel timed at both serve shapes on the full bf16 table
    table = params["user_table"]
    p99_batch = serve.request_tensors(
        RS.make_batch(cfg, b_p99, seed=WARMUP), dev)
    timing = {"serve_p99": time_bag(table, _bag_ids(p99_batch, cfg), 100,
                                    plain_in_graph=True)}
    # a request launches two bags (user, item); their device time per request
    per_request_ms = 0.0
    for tbl, key in (("user_table", "user_ids"), ("item_table", "item_ids")):
        ids = p99_batch[key].reshape(-1, cfg.field_slots)
        per_request_ms += graph_ms(functools.partial(
            eb.embedding_bag, params[tbl], ids, mode="mean"), 100)
    timing["serve_p99"]["per_request_ms"] = per_request_ms
    timing["serve_bulk"] = time_bag(
        table, _bag_ids(serve.request_tensors(bulk_ids, dev), cfg), 3,
        plain_in_graph=False)
    share = {"serve_p99_of_serve_p50": per_request_ms / p99["serve_ms_p50"],
             "serve_p99_of_latency_p50": per_request_ms / p99["latency_ms_p50"],
             "serve_bulk_of_serve_p50": (timing["serve_bulk"]["ms"]
                                         / bulk["serve_ms_p50"])}
    out = {"phase": "recsys", "arch": cfg.name,
           "config": vars(cfg),
           "table_bytes": table_bytes, "init_s": init_s,
           "serve_p99": p99, "serve_bulk": bulk, "retrieval_cand": retrieval,
           "launches": launches, "max_memory_allocated": peak,
           "checks": checks, "kernel": timing, "kernel_share": share}
    del params, table, p99_batch
    torch.cuda.empty_cache()
    emit(out)
    return out


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
    if launches["segment_spmm"] < 1:
        raise AssertionError(f"ell_aggregate missed the kernel: {launches}")

    # times at F = 128 and 1433, f32 sum, against the plain version and one
    # library call, the CSR sparse product
    valid = adj >= 0
    crow = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    crow[1:] = torch.cumsum(valid.sum(dim=1), 0)
    csr = torch.sparse_csr_tensor(crow, adj[valid].to(torch.int64),
                                  torch.ones(int(crow[-1]), device=dev),
                                  size=(n, n), check_invariants=False)
    timing = {}
    for f in SPMM_WIDTHS:
        x = torch.randn((n, f), generator=torch.Generator(device=dev)
                        .manual_seed(f + 1), device=dev)
        lib_err = float((torch.sparse.mm(csr, x)
                         - ss.segment_spmm(x, adj)).abs().max())
        timing[f"F{f}"] = {
            "shape": [n, adj.shape[1], f], "dtype": "float32", "mode": "sum",
            "ms": graph_ms(lambda: ss.segment_spmm(x, adj), 20),
            "eager_ms": eager_ms(lambda: ss.segment_spmm(x, adj), 20),
            "plain_ms": eager_ms(lambda: segment_spmm_ref(x, adj), 2),
            "library_ms": graph_ms(lambda: torch.sparse.mm(csr, x), 20),
            "library": "torch.sparse.mm (CSR, f32)",
            "library_max_abs_diff_vs_kernel": lib_err,
            "bound_ms": _rows_bound_ms(x, adj, n), "bound_by": "bytes"}
    out = {"phase": "spmm", "graph": "twitter", "n": n,
           "dmax": adj.shape[1], "valid_slots": int(valid.sum()),
           "runs": runs, "degree_check": True, "launches": launches,
           "kernel": timing}
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
    """The kernel, the plain version (query-chunked as the model's plain
    path runs it) and ``scaled_dot_product_attention`` (no softcap: timed
    with softcap 0 and no window, so only on the global layer) at the
    model's own q/k/v of layers 0 and 1."""
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
        row = {"window": win, "softcap": cap, "q_offset": off,
               "q": list(qh.shape), "kv": list(kh.shape),
               "ms": graph_ms(kernel, reps) if graph else eager_ms(kernel, reps),
               "eager_ms": eager_ms(kernel, reps),
               "plain_ms": eager_ms(plain, plain_reps),
               "bound_ms": bound, "bound_by": by, "flops": flops,
               "bytes": nbytes, "library_ms": None,
               "library": "none (softcap)"}
        if win == 0:
            if qh.shape[2] == kh.shape[2]:
                def library():
                    return torch.nn.functional.scaled_dot_product_attention(
                        qh, kh, vh, is_causal=True, enable_gqa=True)
            else:
                mask = (torch.arange(kh.shape[2], device=q.device)
                        <= off)[None, None, None, :]

                def library():
                    return torch.nn.functional.scaled_dot_product_attention(
                        qh, kh, vh, attn_mask=mask, enable_gqa=True)
            row["library_softcap0_ms"] = (graph_ms(library, reps) if graph
                                          else eager_ms(library, reps))
            row["library"] = ("none (softcap); "
                              "F.scaled_dot_product_attention timed at the "
                              "same shape with softcap 0")
        out[f"layer{i}"] = row
    return out


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

    with torch.inference_mode():
        # the kernel at a decode round's own q/k/v (4 slots, the last round)
        decode_rec = dict(rec.step)
        timing = {"decode": _time_attention_at(decode_rec, 20, 5,
                                               cfg.attn_chunk, graph=True)}
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
        timing["prefill"] = _time_attention_at(rec.step, 3, 1,
                                               cfg.attn_chunk, graph=False)
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
           "serve_s": serve_s, "generated_tokens": n_tokens,
           "tokens_per_s": n_tokens / serve_s,
           "decode_tokens_per_s": LM_SLOTS * len(round_s) / sum(round_s),
           "max_memory_allocated": peak,
           "max_memory_allocated_checks": checks_peak, "launches": launches,
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
                lm: dict) -> dict:
    pa_case = next(c for c in kernels["partition_affinity"]["cases"] if "ms" in c)
    fc_case = next(c for c in kernels["fused_chooser"]["cases"] if "ms" in c)
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
         "serve_bulk": {"shape": [eb_bulk["bags"], eb_bulk["slots"],
                                  eb_bulk["dim"]],
                        **{k: eb_bulk[k] for k in timed}}},
    ]
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
         **{f"{kind}_{name}": {k: lm["kernel"][kind][layer][k]
                               for k in timed + ("bound_by", "window")
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
         "wide": {k: sp_wide[k] for k in timed + ("shape",)}})
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
    twitter = phase_twitter(dev)
    recsys = phase_recsys(dev)
    lm = phase_lm(dev)
    emit(kernel_line(kernels, twitter, recsys, spmm, lm))
    print(info["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
