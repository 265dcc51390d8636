"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc``, holds each
against its plain PyTorch version on the card (bit-equal, no tolerance,
for the exact kernels; flash_attention's f32 sums run in another order
than the plain version's, so it is held at tests/test_kernels.py's 2e-5 in
f32 and at one bf16 ulp in bf16, on each of its three kernels: f32 CUDA
cores, the bf16 tensor-core prefill, the bf16 decode split over the keys),
runs the streaming session on grqc against the
port's faithful per-event engine and the dict/set oracle of Algorithm 1
(``core.run_reference``, on the host; and at k_max = 200, the fused
chooser's large-K kernel, against the plain session), runs fig12's four
grqc lanes — brought mid-stream by the windowed kernel sweep — through
the scan with the from-scratch scale-in recount (``cut_fn``) and with the
incremental one, bit-identical and each lane equal to the oracle (phase
``fig12``), runs the int8 compressed all-reduce over a four-entry mesh
of the card against the host's and places moonshot's parameters by the
LM sharding rules on a (data 2, model 2) mesh and back (phase ``mesh``),
drives the full-width
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
its pinned JAX digest), serves twitter's stream through
``PartitionService`` under Poisson arrivals at four times the
synchronous driver's capacity (a reader racing ingest, every answer held
to a batch boundary's state) and recovers ``RecoverableSession``s from an
injected crash, a SIGKILLed child process and a closed service, each
against its uninterrupted state (phase ``serve``), runs sweep lanes
through ``Sweep(...).windowed(256).kernel()`` — 64 grqc lanes and 16
twitter lanes, one sweep-form ``fused_chooser`` launch a window step for
all of them, each lane held to its own card session (phase ``sweep``) —
runs twitter and grqc as vertex-sharded sessions (``Partitioner(sharded=
True)``: 1, 2 and 4 row blocks on one card, one block a card where there
are several, grqc at 3; each window one ``window_prep_rows`` launch a
block, then ``window_rng`` and ``fused_chooser`` once) against the dense
card sessions, a ``FaultTolerantLoop`` over twitter windows with one
poisoned and an ``ElasticRunner`` 4 -> 2 -> 4 round trip (phase
``shard``) — trains MeshGraphNet at its full config over SDP's halo
layout of twitter (the SDP and hash card sessions' 8 blocks stacked on the
card; the first step held to the hash layout's and to the dense model's),
and runs PNA at minibatch_lg's sampled shape and SchNet and NequIP at the
molecule shape, each at its full config against the host's CPU (phase
``gnn``) — runs the recsys and GNN cells as ``launch.steps``' step
bundles on meshes of ``cuda:0`` entries: the two-tower model at its
widths with 2,097,152 rows a table, trained under the ``baseline`` and
``opt`` schemes and served, each row block bagged by ``embedding_bag``
(its launches counted exactly, one entry's block bags and block gradient
bit-equal to the plain versions); every GNN's graph-parallel bundle; and
MeshGraphNet's halo bundle over the SDP and hash layouts, one block an
entry of eight — each held to the one-card (or stacked) step, with the
wire bytes each entry sends by op (phase ``model_mesh``) — and serves
the two-tower recsys model at its full vocabulary and widths (bf16
tables, 51.54 GB on the card) through ``serve_score`` and
``score_candidates`` with the ``embedding_bag`` kernel on the path,
trains it at full width (phase ``train``: ``launch.train``'s ``--full``
config, f32 with 4,194,304 rows a table, batches of 16,384, through
``FaultTolerantLoop``; every bag's backward on the
``embedding_bag_backward`` kernel, the first step's table gradients held
bit for bit to the plain backward on the host; the trainer CLI resumed),
aggregates twitter's ELL adjacency through ``ell_aggregate`` with the
``segment_spmm`` kernel on the path, and serves gemma2-9b at its full
width and depth (bf16, 18.48 GB of params, an 11.32 GB KV cache) through
``LMServer`` — 8 requests of 8,192-token prompts, 32 tokens each — with
every attention call of prefill and decode on the ``flash_attention``
kernel (prefill on the tensor cores, decode split over the keys), serves
the MoE LM moonshot-v1-16b-a3b at its full config the same way (bf16,
56.12 GB of params, a 12.94 GB cache; phase ``moe``: its dispatch held
to the host's, its combine to a dense sum of the kept experts, its
logits to the plain attention's), and trains it at every width with 4 of
its 48 layers through ``launch.train --full`` (phase ``lm_train``: 2 x
4,096-token batches, the first step's loss and gradients held to the
plain attention's, the CLI resumed), and runs moonshot and gemma2 at
every width with 2 layers as ``launch.steps``' step bundles on a (data 2,
model 2) mesh of four ``cuda:0`` entries, each entry on its own shards
with explicit collectives (phase ``lm_mesh``: a train step under the
baseline scheme and one under the ``opt`` scheme — ZeRO-3 weights,
sequence parallelism, two microbatches —, a prefill, a 4-slot decode and
gemma2's 1-slot decode over a cache split over every axis, each held to
the one-card step). One JSON line per phase; the last
line is ``{"ok": true, "device": {...}}``.
Any failure raises and exits non-zero without that line. Needs one CUDA
card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import functools
import gc
import itertools
import json
import multiprocessing
import os
import re
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.api import scenarios as sc  # noqa: E402
from repro_torch.api.scenarios import state_digest  # noqa: E402
from repro_torch.api.partitioner import Partitioner  # noqa: E402
from repro_torch.api.serve import PartitionService  # noqa: E402
from repro_torch.api.sweep import Sweep, SweepRun  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.base import ArchDef  # noqa: E402
from repro_torch.configs.shapes import (  # noqa: E402
    GNN_SHAPES, LM_SHAPES, RECSYS_SHAPES,
)
from repro_torch.core import engine, windowed as wnd  # noqa: E402
from repro_torch.core import run_reference  # noqa: E402
from repro_torch.core import transition as tx  # noqa: E402
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
from repro_torch.graph.generators import make_graph  # noqa: E402
from repro_torch.graph.halo import build_halo_spec  # noqa: E402
from repro_torch.graph.sampler import subgraph_sizes  # noqa: E402
from repro_torch.graph.stream import (  # noqa: E402
    VertexStream, build_stream, interleaved_churn, materialize_graph,
    normalize_rows, poisson_arrivals,
)
from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels.embedding_bag import embedding_bag as eb  # noqa: E402
from repro_torch.kernels.embedding_bag import ops as bag_ops  # noqa: E402
from repro_torch.kernels.embedding_bag.ref import (  # noqa: E402
    embedding_bag_backward_ref, embedding_bag_ref,
)
from repro_torch.kernels.flash_attention import flash_attention as fa  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_lse_ref, attention_ref,
)
from repro_torch.kernels.fused_chooser import fused_chooser as fk  # noqa: E402
from repro_torch.kernels.fused_chooser import ops as fops  # noqa: E402
from repro_torch.kernels.fused_chooser import sweep as fsweep  # noqa: E402
from repro_torch.kernels.fused_chooser.ref import (  # noqa: E402
    fused_window_choose_lanes_ref, fused_window_choose_ref,
    prepare_window_ref,
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
from repro_torch.launch import steps as train_steps  # noqa: E402
from repro_torch.launch import train as trainer  # noqa: E402
from repro_torch.data import pipeline as dp  # noqa: E402
from repro_torch.optim.optimizers import (  # noqa: E402
    adamw, apply_updates, linear_warmup_cosine, tree_leaves, tree_map,
    tree_paths,
)
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import recsys as RS  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.gnn import meshgraphnet as MGN  # noqa: E402
from repro_torch.models.gnn import nequip as NQ  # noqa: E402
from repro_torch.models.gnn import pna as PNA  # noqa: E402
from repro_torch.models.gnn import schnet as SCH  # noqa: E402
from repro_torch.models.gnn import common as GC  # noqa: E402
from repro_torch.rebalance import passes as rpasses  # noqa: E402
from repro_torch.runtime import CrashError, RecoverableSession  # noqa: E402
from repro_torch.runtime import shard_session  # noqa: E402
from repro_torch.runtime.elastic import ElasticRunner  # noqa: E402
from repro_torch.runtime.fault import FaultTolerantLoop  # noqa: E402
from repro_torch.runtime.gnn_halo_train import (  # noqa: E402
    halo_batch, make_mgn_halo_loss,
)
from repro_torch.core.sharded_state import (  # noqa: E402
    per_device_state_bytes, shard_state, unshard_state,
)
from repro_torch.launch.mesh import (  # noqa: E402
    Placement, RowBlocks, SpecBlocks, _block_slices, _spec_axes, gather,
    make_mesh, make_vertices_mesh, place_tree, tree_map,
)
from repro_torch.optim import (  # noqa: E402
    compressed_allreduce_grads, init_error_feedback,
)
from repro_torch.runtime import collectives  # noqa: E402
from repro_torch.runtime import gnn_halo_train as GH  # noqa: E402
from repro_torch.runtime import gnn_mesh as GM  # noqa: E402
from repro_torch.runtime import lm_seqpar  # noqa: E402
from repro_torch.runtime import lm_sharded  # noqa: E402
from repro_torch.runtime import recsys_sharded as RSS  # noqa: E402
from repro_torch.runtime import sharding as SHR  # noqa: E402
from repro_torch.runtime import sweep as sweep_rt  # noqa: E402
from repro_torch.kernels.fused_chooser.ref import prepare_rows_ref  # noqa: E402
from repro_torch.kernels.fused_chooser.window_prep import (  # noqa: E402
    window_prep_rows,
)

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
# the checks' references (the plain versions of the window kernels, the
# faithful engine, the plain session) run on copies of their inputs on the
# host CPU: the same functions on the same inputs, each a loop of small ops
# that the host runs 3-6x faster than it issues them to the card. The plain
# versions' times (``plain_ms``) are taken on the card.
HOST = torch.device("cpu")
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
# phase shard: twitter as a sharded session of 1, 2 and 4 row blocks on one
# card (and on min(4, cards) cards where there are several), grqc at 3 (n =
# 5,242 does not divide); the feed boundaries of its twitter runs; the
# windows of the fault-tolerant loop (from the twitter window FAULT_FROM on,
# a checkpoint a window, the middle one poisoned); the profiled prefix
SHARD_WIDTHS, GRQC_SHARDS = (1, 2, 4), 3
SHARD_CHUNKS = (30_001, 77_777)
FAULT_FROM, FAULT_WINDOWS = 200, 16
SHARD_PROFILE_WINDOWS = 32
SHARD_DIR = os.path.join(ROOT, "build", "repro_torch", "smoke_shard")
# phase train: the two-tower trainer at full width (launch.train's --full
# config: every width of CONFIG, f32, 4,194,304 rows a table) on batches of
# 16,384 (configs/shapes.py's train_batch of 65,536 makes 17.2 GB of
# in-batch logits); 10 steps on fresh batches through FaultTolerantLoop,
# then steps split by CUDA events, profiled steps and 10 steps on one fixed
# batch; the trainer CLI at the smoke config (3 steps, resumed to 6)
TRAIN_BATCH, TRAIN_STEPS, TRAIN_FIXED_STEPS = 16_384, 10, 10
TRAIN_SPLIT_STEPS, TRAIN_PROFILE_STEPS = 3, 3
TRAIN_LR = 3e-4                    # launch.train's --lr default
TRAIN_CLI_STEPS, TRAIN_CLI_BATCH, TRAIN_CLI_SEED = (3, 6), 256, 2
TRAIN_DIR = os.path.join(ROOT, "build", "repro_torch", "smoke_train")
# phase moe: moonshot-v1-16b-a3b's CONFIG served as phase lm serves gemma2
# (the same slots, requests, prompts and max_len); the layer whose MoE input
# the dispatch check takes (its input has been through a full layer); the
# combine against a per-token dense f32 sum of the kept experts: the path
# rounds to bf16 after each of the three expert products and the
# activation, and once more after the combine, each within 2^-9 relative,
# so a few 2^-9 at most; a wrong position, gate or expert moves a token's
# output by O(1). Limit on the relative L2 error:
MOE_ARCH, MOE_DISPATCH_LAYER, MOE_SPLIT_REPS = "moonshot-v1-16b-a3b", 1, 5
MOE_DENSE_REL = 2.0 ** -6
# phase lm_train: launch.train --full on moonshot-v1-16b-a3b (CONFIG at
# every width, n_layers cut to FULL_TRAIN_LAYERS = 4) on batches of 2 x
# 4,096 tokens (train_4k's length; its global batch of 256 sequences cut to
# 2, which with the 35.4 GB of params, gradients and moments fits the card)
LM_TRAIN_ARCH = MOE_ARCH
LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_STEPS = 2, 4096, 10
LM_TRAIN_SPLIT_STEPS, LM_TRAIN_PROFILE_STEPS = 3, 2
LM_TRAIN_FIXED_STEPS = 6
# the first step against the plain attention's (use_kernel=False), the same
# params and batch: loss and xent are means over 8,192 tokens of two bf16
# paths 4 layers deep, so they differ far below a bf16 ulp (2^-8); limit on
# the relative difference:
LM_TRAIN_LOSS_REL = 2.0 ** -10
# the relative L2 of the router, expert (wi, wg, wo) and wq gradients: bf16
# gradients of two forwards whose routing differs where a bf16 difference
# flips a top-6 choice; a flipped (token, choice) moves its share of the
# gradient to another expert, about sqrt(2 x flip share) of the whole, so
# 0.25 allows a 3 % flip share, where a wrong combine, gate or attention
# gradient moves them by O(1). Limit:
LM_TRAIN_GRAD_REL = 2.0 ** -2
LM_TRAIN_GRADS = ("moe/router", "moe/wi", "moe/wg", "moe/wo", "attn/wq")
# the witness that separates routing flips from attention error: the plain
# attention's step fed the kernel step's own expert choices (the same
# experts, kept masks and capacity drops; its gates its own probs at them),
# so the two differ only by the attention forwards' bf16 roundings carried
# through 4 bf16 layers and the backward. Limit on each gradient's relative
# L2 against the kernel step's:
LM_TRAIN_SAME_ROUTES_REL = 2.0 ** -4
# the CLI's resume at moonshot's smoke config (f32): the embedding's
# gradient is an indexed scatter-add whose atomics may add in another order
# from run to run, so each param leaf is held to 1e-6 of its largest
# magnitude; replaying other batches moves the params by the learning rate
# (3e-4)
LM_CLI_BATCH, LM_CLI_SEQ, LM_CLI_TOL = 2, 64, 1e-6
LM_TRAIN_DIR = os.path.join(ROOT, "build", "repro_torch", "smoke_lm_train")
LM_TRAIN_RESULT = LM_TRAIN_DIR + "_result.json"
# backward cases beyond the training step's own (V, D, B, L, kind): V = 1,
# a ragged width, long bags, half the bags all padding, hot rows (long runs
# of one row), one id a bag
BWD_CASES = ((1, 16, 40, 3, "random"), (7, 130, 300, 37, "random"),
             (300, 5, 45, 2000, "padded"), (50, 256, 4096, 8, "hot"),
             (1000, 24, 512, 9, "dup"))


# every line emit prints, also kept whole in a file (a run's standard
# output may be read back cut to its tail)
LOG = os.path.join(ROOT, "build", "chip_smoke.jsonl")


_T0 = time.perf_counter()
_EMIT_LOCK = threading.Lock()


def emit(obj) -> None:
    """One JSON line, printed and appended to ``LOG``; a phase's line
    carries ``t_s``, the seconds since the script started, so the phases'
    shares of the time limit can be read."""
    if "phase" in obj:
        obj = {**obj, "t_s": round(time.perf_counter() - _T0, 3)}
    line = json.dumps(obj)
    with _EMIT_LOCK:              # the build's thread emits too
        print(line, flush=True)
        os.makedirs(os.path.dirname(LOG), exist_ok=True)
        with open(LOG, "a") as f:
            f.write(line + "\n")


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


def on_host(fn, *args, **kw):
    """``fn`` on host copies of its tensor arguments; its tensor outputs
    back on the card."""
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    out = fn(*(a.to(HOST) if isinstance(a, torch.Tensor) else a
               for a in args), **kw)
    return tuple(o.to(dev) for o in out)


# worker processes for the window choosers' host references (phase
# kernels): each reference is a Python loop over a window's slots, ~0.5-4 s
# a call on the host, and its plain version issued to the card takes
# longer (0.7-3 s a window, 8-9 s at K = 1,000; run V3, PR 27), so the
# card's plain version cannot stand in for them; 278 of them ran one after
# another in V3's phase. In workers they run beside the kernels' launches,
# every case still held to the host; the phase's timings wait until the
# workers are done.
HOST_REF_WORKERS = 6


def _host_ref(fn, args, kw):
    """``fn`` in a worker process on host tensors made from ``args``'
    numpy arrays; its tensor outputs back as numpy arrays."""
    torch.set_num_threads(1)
    out = fn(*(torch.from_numpy(a) if isinstance(a, np.ndarray) else a
               for a in args), **kw)
    return tuple(o.numpy() for o in out)


class _HostRefs:
    """A pool of ``HOST_REF_WORKERS`` spawned processes that compute host
    references (``on_host``'s, in another process) while the caller goes
    on with the card; ``want(future, dev)`` waits for one. ``close()``
    waits for every reference and stops the workers; ``close(cancel=True)``
    drops the references not yet started (a failed run)."""

    def __init__(self):
        self.pool = concurrent.futures.ProcessPoolExecutor(
            HOST_REF_WORKERS, mp_context=multiprocessing.get_context("spawn"))

    def submit(self, fn, *args, **kw):
        host = tuple(a.to(HOST).numpy() if isinstance(a, torch.Tensor)
                     else a for a in args)
        return self.pool.submit(_host_ref, fn, host, kw)

    @staticmethod
    def want(future, dev) -> tuple:
        return tuple(torch.from_numpy(o).to(dev) for o in future.result())

    def close(self, cancel: bool = False) -> None:
        self.pool.shutdown(wait=True, cancel_futures=cancel)


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
        if x.device != y.device:
            x, y = x.to(HOST), y.to(HOST)
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


def to_host(st) -> PartitionState:
    return PartitionState(*(t.to(HOST) for t in st))


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


def _chooser_inputs(dev, cases, setup):
    """A setup's window (slots ``warm .. warm + W`` of its mid-session
    state, ``cases`` from ``_window_cases``) as ``fused_window_choose``'s
    ten tensor arguments, with the state's ``n`` and the window's event
    types."""
    state, cfg, (et, vx, nb) = cases[setup]
    w, warm = fsweep.WINDOW_SETUPS[setup][6:8]
    sl = slice(warm, warm + w)
    n = state.assignment.shape[0]
    prep = fops._prepare_window(clone_state(state), et[sl], vx[sl], nb[sl])
    return n, (prep.ev, prep.src_lbl, prep.touch,
               window_rng_ref(state.key, warm, w, cfg.k_max),
               *wnd.small_args(state), knob_tensor(cfg, n, dev)), et[sl]


def _time_fused(case: dict, args, kw: dict, w: int, d: int, k: int) -> None:
    """A fused_window_choose case's kernel, eager and plain times, and its
    bound."""
    def kernel():
        fk.fused_window_choose(*args, **kw)

    def plain():
        fused_window_choose_ref(*args, **kw)

    case["ms"] = graph_ms(kernel, 20)
    case["eager_ms"] = eager_ms(kernel, 20)
    if kw["policy"] == "sdp" and k > fk.LANES_MAX_K:
        # a graph would pool the (K, K) temporaries of every slot's op
        case["plain_ms"] = case["plain_eager_ms"] = eager_ms(plain, 1)
    elif kw["policy"] == "sdp":
        case["plain_ms"] = graph_ms(plain, 1, replays=2)
        case["plain_eager_ms"] = eager_ms(plain, 1)
    case["bound_ms"] = _fused_bytes(w, d, k) / HBM_BYTES_PER_S * 1e3


def check_fused_chooser(dev, cases, refs: _HostRefs, timers: list) -> tuple:
    """Every setup x policy x guard (and autoscale off too at the
    session's shape) launched on the card, its host reference submitted
    to ``refs``; ``timers`` gets the timed cases' timings, to run once no
    worker is busy. Returns the check's line and its pending host
    comparisons (``_held_to_host``)."""
    fc_out = {"name": "fused_chooser", "cases": []}
    pending = []
    # the window kernels' setups (sweep.WINDOW_SETUPS): the session's shapes
    # (SESSION_SHAPE), a window and width off every multiple of 32, a single
    # partition slot, partitions past the warp's 32 lanes, grqc's uncapped
    # 2,843-wide rows, and 200 and 1,000 partition slots (the large-K
    # kernel)
    for label, spec in fsweep.WINDOW_SETUPS.items():
        _name, _scale, _cap, width, k_max, _max_cap, window, _warm = spec
        n, args, ets = _chooser_inputs(dev, cases, label)
        scalars = args[8]
        n_del = int((ets != 0).sum())
        guards = ("text", "alg1")
        # the plain version takes ~4 s a window at K = 1,000 on the host:
        # SDP only there (tests/test_torch_gpu.py holds every policy at
        # K = 1,000)
        for policy in (("sdp",) if label == "k1000" else POLICIES):
            for guard in guards:
                for auto in ((True, False) if label == "session"
                             else (True,)):
                    kw = dict(n=n, policy=policy, balance_guard=guard,
                              autoscaling=auto)
                    got = fk.fused_window_choose(*args, **kw)
                    want = refs.submit(fused_window_choose_ref, *args, **kw)
                    torch.cuda.synchronize()
                    scale = int(got[6][4] - scalars[4])
                    case = {"case": label, "shape": [window, width, k_max],
                            "kernel": fk.dispatch(window, k_max),
                            "policy": policy, "guard": guard,
                            "autoscale": auto,
                            "scale_events_in_window": scale,
                            "deletions_in_window": n_del}
                    pending.append((case, got, want))
                    timed = guard == "text" and auto and (
                        policy == "sdp" or (label == "session"
                                            and policy in ("ldg", "random")))
                    if timed and label in ("session", "k40", "grqc_wide",
                                           "k200", "k1000"):
                        timers.append(functools.partial(
                            _time_fused, case, args, kw, window, width,
                            k_max))
                    fc_out["cases"].append(case)
    return fc_out, pending


def _held_to_host(pending: list, dev, name: str) -> None:
    """Each ``(case, kernel outputs, host future)`` of ``pending``: the
    kernel's outputs bit-equal to the host reference's."""
    for case, got, want in pending:
        case["max_abs_err"] = err = max_abs_diff(got, _HostRefs.want(want,
                                                                     dev))
        if err:
            raise AssertionError(
                f"{name} {case['case']}/{case.get('window', '')} "
                f"{case['policy']}/{case['guard']}/autoscale="
                f"{case['autoscale']}: kernel differs from the plain "
                f"version by {err}")


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


def _rng_bound(tables: int, rows: int, k: int) -> dict:
    """window_rng's bound for ``tables`` (rows, k) tables: five threefry
    blocks of ~117 operations a slot, and 10 for each table entry's range
    reduction (five modulos and five products, masks and sums, each modulo
    counted as one operation, so a lower bound); the keys in, the tables
    out."""
    return _bound(8 * tables + tables * rows * k * 4,
                  tables * rows * (5 * 117 + 2 + 10 * k))


def check_window_rng(dev) -> dict:
    """Bit-equal to the plain version at the session's t0s, the uint32
    wrap and K from 1 to 1,000, one table and L = 16 and 64 tables (a
    sweep step's lanes) in one launch, those also held to their L
    one-table draws; timed at the session's (W, K) for L = 1, 16, 64
    (ms a launch and a table against the bound)."""
    out = {"name": "window_rng", "cases": [], "tables": []}
    for seed in (0, 2**40 + 5):
        key = prng_key(seed, device=dev)
        for t0 in (0, 114_958, 2**32 - 100):
            for k in (1, K_MAX, 200, 1000):
                got = rops.window_rng(key, t0, WINDOW, k)
                want = on_host(lambda *a: (window_rng_ref(*a),), key, t0,
                               WINDOW, k)[0]
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
                    case.update(_rng_bound(1, WINDOW, k))
                out["cases"].append(case)
                if err:
                    raise AssertionError(f"window_rng seed={seed} t0={t0} "
                                         f"k={k}: kernel differs from the "
                                         f"plain version by {err}")
    for lanes in SWEEP_TIMED_LANES:
        keys = torch.stack([prng_key(7 * j + (2**40 if j % 2 else 0),
                                     device=dev) for j in range(lanes)])
        for t0 in (114_958, 2**32 - 100):
            got = rops.window_rng(keys, t0, WINDOW, K_MAX)
            one = torch.stack([rops.window_rng(keys[j], t0, WINDOW, K_MAX)
                               for j in range(lanes)])
            want = on_host(lambda *a: (window_rng_ref(*a),), keys, t0,
                           WINDOW, K_MAX)[0]
            err = max_abs_diff([got], [want])
            if err or not torch.equal(got, one):
                raise AssertionError(f"window_rng at {lanes} tables: differs "
                                     f"from the plain version by {err}, or "
                                     "from one draw a table")
        row = {"tables": lanes, "shape": [lanes, WINDOW, K_MAX],
               "max_abs_err": err, "equal_to_one_draw_a_table": True,
               "ms": graph_ms(lambda: rops.window_rng(keys, 114_958, WINDOW,
                                                      K_MAX), 100),
               "eager_ms": eager_ms(lambda: rops.window_rng(
                   keys, 114_958, WINDOW, K_MAX), 100),
               **_rng_bound(lanes, WINDOW, K_MAX)}
        row["ms_per_table"] = row["ms"] / lanes
        out["tables"].append(row)
    return out


def _draws_held(hook, what: str) -> dict:
    """Every window_rng draw ``hook`` kept (``fops.window_rng``'s calls:
    key or keys, t0, rows, K) bit-equal to the plain version on host
    copies of its keys."""
    rows = 0
    for (key, t0, w, k), _, got, _ in hook.kept.values():
        want = window_rng_ref(key.to(HOST), t0, w, k)
        if not torch.equal(got.to(HOST), want):
            raise AssertionError(f"{what}: the window_rng draw at t0={t0} "
                                 f"({tuple(got.shape)}) differs from the "
                                 "plain version")
        rows += got.numel() // k
    return {"draws": len(hook.kept), "rows": rows,
            "bit_equal_to_plain": True}


def _prep_bytes(prep, state, rows) -> int:
    """Bytes one window_prep call must move: each slot's event, subject
    and first row entry (its u) in, and the rest of each ADD's row (the
    ADDs score their rows; no other event row is read); the scalar rows
    and both tables out, the assignment and presence (n) in, label0 and
    last_touch (n) out, and each adjacency row the window reads (the
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
    adds = int((et == 0).sum())
    return (4 * 3 * w + 4 * (d - 1) * adds + 4 * w * fk.EV_COLS
            + 8 * w * d + 5 * n + 8 * n + 4 * d * (read + written))


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


def _time_add(case: dict, args, kw: dict, variant: str, w: int, d: int,
              k: int) -> None:
    """An add_window_choose case's kernel, eager and plain times (and the
    large kernel's on the same inputs where the lanes one ran), and its
    bound."""
    def kernel():
        fk.add_window_choose(*args, **kw)

    def plain():
        wnd.add_window_fixup_ref(*args, **kw)

    case["ms"] = graph_ms(kernel, 20)
    case["eager_ms"] = eager_ms(kernel, 20)
    if variant == "lanes":
        # the large kernel on the same inputs, uncounted: the layout the
        # lanes one replaced at K <= 192
        case["large_ms"] = graph_ms(lambda: fk.add_launch(
            "large", *args, policy=kw["policy"],
            balance_guard=kw["balance_guard"],
            autoscaling=kw["autoscaling"]), 20)
    case["plain_ms"] = graph_ms(plain, 1, replays=2)
    case["plain_eager_ms"] = eager_ms(plain, 1)
    case.update(_bound(_add_bytes(w, d, k), 0))


def check_add_window_choose(dev, cases, refs: _HostRefs,
                            timers: list) -> tuple:
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
    is also timed on the same inputs (uncounted). As
    ``check_fused_chooser``: host references to ``refs``, timings to
    ``timers``; returns the line and its pending host comparisons."""
    out = {"name": "add_window_choose", "cases": [],
           "launches_by_kernel": dict.fromkeys(fk.KERNELS, 0)}
    pending = []
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
                        want = refs.submit(wnd.add_window_fixup_ref, *args,
                                           **kw)
                        torch.cuda.synchronize()
                        case = {"case": name, "window": label,
                                "shape": [w, rows.shape[1],
                                          st.edge_load.shape[0]],
                                "kernel": variant,
                                "policy": policy, "guard": guard,
                                "autoscale": auto,
                                "fresh": int(args[3].sum()),
                                "committed": int((got[0] >= 0).sum())}
                        pending.append((case, got, want))
                        timed = (policy == "sdp" and guard == "text"
                                 and auto and (name == "session" or (
                                     label == "crafted" and name in (
                                         "grqc_wide", "k200", "k1000"))))
                        if timed:
                            timers.append(functools.partial(
                                _time_add, case, args, kw, variant, w,
                                rows.shape[1], st.edge_load.shape[0]))
                        out["cases"].append(case)
    return out, pending


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


def phase_kernels(dev, graphs, cases, refs: _HostRefs) -> dict:
    """Each kernel against its plain version on the card: bit for bit, but
    flash_attention at its stated tolerances. ``cases`` are the window
    kernels' setups (``_window_cases``). The window choosers' cases run
    first, each launch's host reference in ``refs``' worker processes;
    ``refs`` is closed (every reference in, phase grqc's too) before any
    timed loop of the phase, so no worker runs beside a timing.
    ``host_refs_s``: those launches and the wait; ``check_s``: each
    check's seconds after it (the choosers' timings)."""
    out = {"phase": "kernels", "check_s": {}}
    t = time.perf_counter()
    timers = {"fused_chooser": [], "add_window_choose": []}
    pending = {}
    for name, check in (("fused_chooser", check_fused_chooser),
                        ("add_window_choose", check_add_window_choose)):
        out[name], pending[name] = check(dev, cases, refs, timers[name])
    refs.close()
    for name, held in pending.items():
        _held_to_host(held, dev, name)
    out["host_refs_s"] = time.perf_counter() - t
    for name, check, args in (
            ("partition_affinity", check_partition_affinity, ()),
            ("fused_chooser", None, ()),
            ("window_rng", check_window_rng, ()),
            ("window_prep", check_window_prep, (cases,)),
            ("add_window_choose", None, ()),
            ("embedding_bag", check_embedding_bag, ()),
            ("flash_attention", check_flash_attention, ()),
            ("segment_spmm", check_segment_spmm, (graphs,))):
        t = time.perf_counter()
        if check is None:
            for timer in timers[name]:
                timer()
        else:
            out[name] = check(dev, *args)
        out["check_s"][name] = time.perf_counter() - t
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
             "fused_chooser_sweep": fk.fused_window_choose_lanes,
             "window_prep": window_prep,
             "window_rng": rops.window_rng,
             "add_window_choose": fk.add_window_choose,
             "embedding_bag": eb.embedding_bag,
             "embedding_bag_backward": eb.embedding_bag_backward,
             "flash_attention": fa.flash_attention,
             "segment_spmm": ss.segment_spmm}
SESSION_KERNELS = ("partition_affinity", "fused_chooser", "window_prep",
                   "window_rng", "add_window_choose")
SWEEP_KERNELS = SESSION_KERNELS + ("fused_chooser_sweep",)


# every card session's feed since _reset_launches: (windows whose tables
# it draws ahead — Partitioner.windows_drawn_ahead —, window, K)
_FEEDS: list = []


def _logged_feed(feed_prepared):
    @functools.wraps(feed_prepared)
    def feed(self, chunk):
        if self.device.type == "cuda":
            _FEEDS.append((self.windows_drawn_ahead(chunk.num_events),
                           self.window, self.geometry.k_max))
        return feed_prepared(self, chunk)
    feed.logged = True
    return feed


def _expected_draws() -> int:
    """The window_rng launches the logged feeds need: each feed's windows
    drawn ahead, ``fops.windows_per_draw`` of them a launch."""
    return sum(-(-windows // fops.windows_per_draw(w, k))
               for windows, w, k in _FEEDS)


def _reset_launches():
    if not getattr(Partitioner.feed_prepared, "logged", False):
        Partitioner.feed_prepared = _logged_feed(Partitioner.feed_prepared)
    _FEEDS.clear()
    for fn in _WRAPPERS.values():
        fn.launches = 0
    fa.flash_attention.kernel_launches = dict.fromkeys(fa.KERNELS, 0)
    ss.segment_spmm.kernel_launches = dict.fromkeys(ss.KERNELS, 0)
    eb.embedding_bag.kernel_launches = dict.fromkeys(eb.KERNELS, 0)
    fk.fused_window_choose.kernel_launches = dict.fromkeys(fk.KERNELS, 0)
    fk.add_window_choose.kernel_launches = dict.fromkeys(fk.KERNELS, 0)
    fk.fused_window_choose_lanes.kernel_launches = dict.fromkeys(
        fk.SWEEP_KERNELS, 0)


def _read_launches(names=SESSION_KERNELS) -> dict:
    return {name: _WRAPPERS[name].launches for name in names}


def _check_session_launches(launches: dict, windows: dict, what: str,
                            histograms: int = 0, every: bool = True):
    """Every session kernel launched, once a window of its kind: the prep
    scan and the fused chooser per mixed window, partition_affinity and
    the pure-ADD fixup per pure-ADD window — and partition_affinity once
    more for each of the session's ``histograms`` rebalance histograms;
    the RNG exactly as often as the feeds since ``_reset_launches`` and
    the draw budget give (``_expected_draws``: one launch for many
    windows). ``every``: each kernel at least once."""
    want = {"window_prep": windows["mixed"],
            "fused_chooser": windows["mixed"],
            "partition_affinity": windows["add"] + histograms,
            "add_window_choose": windows["add"],
            "window_rng": _expected_draws()}
    if (every and min(launches.values()) < 1) or launches != want \
            or launches["partition_affinity"] < 1:
        raise AssertionError(f"{what} missed a kernel: launched {launches}, "
                             f"windows {windows}")


def _window_kinds(part) -> dict:
    """How many of a session's full windows were pure-ADD and mixed, as
    the Partitioner counted them."""
    m = part.metrics()
    return {"add": m["add_windows"], "mixed": m["mixed_windows"]}


def _grqc_chunks(T: int) -> list:
    """Phase grqc's feed boundaries: chunks of 1 and 6 events, a window
    split by one event, the rest in a few large ones."""
    return [1, 7, 300, 301, 1000, 2500, T // 2 + 3, T - 5]


def assert_matches_oracle(st, ref, what: str) -> None:
    """A state against the dict/set oracle (``core.ref.run_reference``):
    every field tests/test_sdp_engine.py's ``_assert_match`` compares —
    assignment and presence, edge_load, vertex_count, active, total_edges,
    cut_edges, num_partitions, denied_scaleout, scale_events, cut_matrix."""
    a = st.assignment.cpu().numpy()
    want = np.full(a.shape, -1, np.int64)
    for v, p in ref.assignment.items():
        want[v] = p
    got = {"assignment": a, "present": st.present.cpu().numpy(),
           "edge_load": st.edge_load.cpu().numpy(),
           "vertex_count": st.vertex_count.cpu().numpy(),
           "active": st.active.cpu().numpy(),
           "cut_matrix": st.cut_matrix.cpu().numpy(),
           **{f: int(getattr(st, f)) for f in (
               "total_edges", "cut_edges", "num_partitions",
               "denied_scaleout", "scale_events")}}
    exp = {"assignment": want, "present": want >= 0,
           "edge_load": np.asarray(ref.edge_load),
           "vertex_count": np.asarray(ref.vertex_count),
           "active": np.asarray(ref.active), "cut_matrix": ref.cut_matrix,
           "total_edges": ref.total_edges, "cut_edges": ref.cut_edges,
           "num_partitions": ref.num_partitions,
           "denied_scaleout": ref.denied, "scale_events": ref.scale_events}
    bad = [f for f in exp if not np.array_equal(got[f], exp[f])]
    if bad:
        raise AssertionError(f"{what}: {bad} differ from the oracle")


GRQC_CFG = dict(k_max=16, k_init=1, max_cap=1500, autoscale=True)


def _grqc_stream():
    return interleaved_churn(load_dataset("grqc"), **EVENT_ARGS)


def _state_arrays(st) -> tuple:
    """A state's tensors, the uint32 key viewed as int32 (for numpy)."""
    return tuple(x.view(torch.int32) if x.dtype == torch.uint32 else x
                 for x in st)


def _state_of(arrays) -> PartitionState:
    return PartitionState(*(x.view(torch.uint32) if f == "key" else x
                            for f, x in zip(PartitionState._fields, arrays)))


def grqc_faithful_on_host() -> tuple:
    """(host seconds, *state) of the faithful per-event engine on grqc's
    churn stream: phase grqc's reference, run in a ``_HostRefs`` worker
    while the earlier phases hold the card."""
    s = _grqc_stream()
    t = time.perf_counter()
    ref, _ = engine.run_stream(s, policy="sdp", cfg=EngineConfig(**GRQC_CFG),
                               seed=0, device=HOST)
    secs = time.perf_counter() - t
    return (torch.tensor(secs, dtype=torch.float64),) + _state_arrays(ref)


def grqc_k200_plain_on_host() -> tuple:
    """(host seconds, *state) of the plain windowed session at k_max = 200
    on grqc's churn stream (``_session_k200``'s reference), in a worker."""
    s = _grqc_stream()
    cfg = EngineConfig(k_max=200, k_init=1, max_cap=K_200_CAP,
                       autoscale=True)
    t = time.perf_counter()
    plain = Partitioner.from_stream(s, cfg, policy="sdp", seed=0, window=256,
                                    device=HOST).feed(s)
    secs = time.perf_counter() - t
    return (torch.tensor(secs, dtype=torch.float64),) \
        + _state_arrays(plain.state)


def grqc_host_refs(refs) -> dict:
    """Phase grqc's two host references, submitted to ``refs``' workers."""
    return {"faithful": refs.submit(grqc_faithful_on_host),
            "k200_plain": refs.submit(grqc_k200_plain_on_host)}


def _host_state(future) -> tuple:
    out = _HostRefs.want(future, HOST)
    return float(out[0]), _state_of(out[1:])


def phase_grqc(dev, host: dict) -> dict:
    """The session with both kernels against the port's faithful engine
    and the dict/set oracle of Algorithm 1 (both run on the host; the
    faithful engine in a worker process, ``host`` from
    ``grqc_host_refs``)."""
    s = _grqc_stream()
    cfg = EngineConfig(**GRQC_CFG)
    t = time.perf_counter()
    oracle = run_reference(s, policy="sdp", cfg=cfg, seed=0)
    t_oracle = time.perf_counter() - t
    T = s.num_events
    chunks = _grqc_chunks(T)
    _reset_launches()
    t = time.perf_counter()
    part = _session(s, cfg, dev, 256, chunks)
    t_part = time.perf_counter() - t
    launches = _read_launches()
    t_ref, ref = _host_state(host["faithful"])
    assert_states_equal(part.state, ref, "grqc session vs faithful engine")
    assert_matches_oracle(part.state, oracle, "grqc session")
    _check_session_launches(launches, _window_kinds(part),
                            "grqc session")
    m = part.metrics()
    out = {"phase": "grqc", "n": s.n, "events": T, "max_deg": s.max_deg,
           "max_cap": cfg.max_cap, "bit_equal": True,
           "state_sha256": state_digest(part.state),
           **_scaling(part.state, cfg.k_init),
           "kernel_windows": m["kernel_windows"],
           "fallback_windows": m["fallback_windows"], "launches": launches,
           "faithful_host_s": round(t_ref, 3),
           "oracle_s": round(t_oracle, 3), "oracle_equal": True,
           "session_s": round(t_part, 3),
           "k200": _session_k200(s, dev, host["k200_plain"])}
    emit(out)
    return out, s, cfg, to_host(part.state)


def _session_k200(s, dev, plain_future) -> dict:
    """The same stream at k_max = 200 (K_200_CAP a partition): the session
    with both kernels — the large-K fused_chooser, partition_affinity's
    shared histogram — against the plain windowed session (on the host,
    in a worker process: ``plain_future``)."""
    cfg = EngineConfig(k_max=200, k_init=1, max_cap=K_200_CAP, autoscale=True)
    _reset_launches()
    t = time.perf_counter()
    part = _session(s, cfg, dev, 256)
    t_part = time.perf_counter() - t
    launches = _read_launches()
    by_kernel = dict(fk.fused_window_choose.kernel_launches)
    add_by_kernel = dict(fk.add_window_choose.kernel_launches)
    t_plain, plain = _host_state(plain_future)
    assert_states_equal(part.state, plain,
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
            "session_s": round(t_part, 3), "plain_host_s": round(t_plain, 3)}


FIG12_SEEDS = (0, 1, 2, 3)          # benchmarks/fig12_autoscale_churn.py
# The scan resumes at event T0 and runs W events a lane. The lanes scale
# in late: lane 1 first at event 6,865 (the oracle), so [6,656, 7,168)
# holds 111 / 67 / 111 / 111 scale-ins; a scanned event costs ~9 ms of
# host issue a lane on the card, so W = 512 keeps the phase under a
# minute.
FIG12_T0 = 26 * WINDOW              # 6,656
FIG12_W = 512


def _fig12_lanes():
    """fig12's four lanes: grqc's churn streams (seeds 0-3) and its
    config, max_cap = |E| / 6."""
    g = load_dataset("grqc")
    streams = [interleaved_churn(g, warmup_frac=0.2, del_every=3,
                                 edge_del_every=5, seed=s)
               for s in FIG12_SEEDS]
    cfg = EngineConfig(k_max=16, k_init=1, max_cap=max(g.num_edges // 6, 30),
                       tolerance_param=60.0, dest_param=5.0, autoscale=True)
    return streams, cfg


def _slice_stream(s, a, b):
    return VertexStream(s.etype[a:b], s.vertex[a:b], s.nbrs[a:b], n=s.n)


def _lane_scale_ins(before, after, trace) -> list:
    """Each lane's scale-ins between two stacked states: half of (the
    growth of scale_events less the growth of num_partitions), held to the
    count of events after which the trace's partition count dropped."""
    d_ev = (after.scale_events - before.scale_events).tolist()
    d_np = (after.num_partitions - before.num_partitions).tolist()
    ins = [(e - p) // 2 for e, p in zip(d_ev, d_np)]
    npart = torch.cat([before.num_partitions[:, None],
                       trace.num_partitions], dim=1)
    drops = (npart.diff(dim=1) < 0).sum(dim=1).tolist()
    if ins != drops:
        raise AssertionError(f"fig12: scale-ins {ins} from the counters, "
                             f"{drops} from the trace")
    return ins


def phase_fig12(dev) -> dict:
    """fig12's from-scratch scale-in baseline against the incremental
    cut-matrix merge (``sweep_events(cut_fn=transition.recompute_cut)``).
    The four lanes scale in late (lane 1 first at event 6,865), so the
    lanes are first brought to event FIG12_T0 through the windowed kernel
    sweep
    (``Sweep(...).windowed(256).kernel()``); both variants then scan
    events [T0, T0 + W) from copies of those states. Checks: the two
    final states and traces bit-identical, every lane scaling in inside
    the window, and each lane's final state equal to the oracle's over
    the stream's first T0 + W events."""
    streams, cfg = _fig12_lanes()
    runs = [SweepRun("sdp", cfg, s) for s in FIG12_SEEDS]
    T0, W, L = FIG12_T0, FIG12_W, len(runs)
    windows = T0 // WINDOW
    _reset_launches()
    t = time.perf_counter()
    res = (Sweep([_prefix(s, T0) for s in streams], device=dev).lanes(runs)
           .windowed(WINDOW).kernel().run())
    torch.cuda.synchronize()
    prefix_s = time.perf_counter() - t
    launches = _read_launches(SWEEP_KERNELS)
    want = {"window_prep": L * windows, "window_rng": windows,
            "fused_chooser_sweep": windows, "fused_chooser": 0,
            "add_window_choose": 0, "partition_affinity": 0}
    if launches != want:
        raise AssertionError(f"fig12 prefix sweep: launched {launches}, "
                             f"want {want}")
    start = sweep_rt._stack([r.state for r in res])
    del res
    et, vx, nb, n, _ = sweep_rt._stack_streams(
        [_slice_stream(s, T0, T0 + W) for s in streams], W, dev)
    kns = torch.stack([knob_tensor(cfg, n, dev) for _ in runs])
    pidx = [tx.POLICY_INDEX["sdp"]] * L
    auto = [True] * L
    variants, finals = {}, {}
    for name, cut_fn in (("scan_recompute", tx.recompute_cut),
                         ("scan_incremental", None)):
        states = type(start)(*(x.clone() for x in start))
        torch.cuda.synchronize()
        t = time.perf_counter()
        finals[name] = sweep_rt.sweep_events(
            states, kns, pidx, auto, et, vx, nb, T0,
            balance_guard=cfg.balance_guard, autoscale_mode="dynamic",
            cut_fn=cut_fn)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        variants[name] = {"s": dt, "events": L * W,
                          "events_per_s": L * W / dt}
    (rs, rt), (is_, it) = finals["scan_recompute"], finals["scan_incremental"]
    for a, b in ((rs, is_), (rt, it)):
        for f in a._fields:
            if not torch.equal(getattr(a, f), getattr(b, f)):
                raise AssertionError(f"fig12: {f} differs between the "
                                     "recount and the incremental scale-in")
    ins = _lane_scale_ins(start, is_, it)
    if min(ins) < 1:
        raise AssertionError(f"fig12: a lane did not scale in inside "
                             f"[{T0}, {T0 + W}): {ins}")
    # the baseline's extra work an event: one recount's device time (a
    # CUDA graph of it on lane 0's final state) against the scan's host
    # time a lane-event, and the recount's bound (each input read once)
    lane0 = sweep_rt._unstack(is_, 0)
    recount = (lane0.assignment, lane0.present, lane0.adj)
    recount_bytes = sum(x.numel() * x.element_size() for x in recount)
    variants["recount"] = {
        "ms": graph_ms(lambda: tx.recompute_cut(*recount), 20),
        "bound_ms": recount_bytes / HBM_BYTES_PER_S * 1e3,
        "scan_ms_per_lane_event": (variants["scan_incremental"]["s"] * 1e3
                                   / (L * W))}
    t = time.perf_counter()
    for b, (s, r) in enumerate(zip(streams, runs)):
        assert_matches_oracle(sweep_rt._unstack(is_, b),
                              run_reference(_prefix(s, T0 + W), cfg=cfg,
                                            seed=r.seed),
                              f"fig12 lane {r.seed}")
    oracle_s = time.perf_counter() - t
    out = {"phase": "fig12", "lanes": L, "n": n, "max_deg": nb.shape[-1],
           "max_cap": cfg.max_cap, "t0": T0, "window": W,
           "prefix": {"events": L * T0, "s": prefix_s,
                      "launches": launches},
           **variants,
           "recompute_vs_incremental": (variants["scan_recompute"]["s"]
                                        / variants["scan_incremental"]["s"]),
           "states_equal": True, "traces_equal": True,
           "scale_ins": ins,
           "scale_events": (is_.scale_events - start.scale_events).tolist(),
           "oracle_equal": True, "oracle_s": oracle_s}
    emit(out)
    return out


MESH_RANKS = 4
MESH_BIG = 1 << 24                  # elements of the large gradient leaf
MESH_ROUNDS = 2                     # all-reduce rounds, the error carried
MESH_EF_ROUNDS = 16                 # tests/test_optim_checkpoint.py's check
MESH_LM_ARCH = "moonshot-v1-16b-a3b"
MESH_LM_LAYERS = 2


def _mesh_grads(rank: int, round_: int, dev) -> dict:
    """Rank ``rank``'s seeded gradient tree in round ``round_``: one leaf
    of 2^24 f32 and a few small ones (one all zero); rank 2's ten times
    larger, so the ranks' scales differ."""
    g = torch.Generator(device=dev).manual_seed(1000 * round_ + rank)
    k = 10.0 if rank == 2 else 1.0
    return {"big": torch.randn(MESH_BIG, generator=g, device=dev) * k,
            "bias": torch.randn(4099, generator=g, device=dev) * (1e-3 * k),
            "blk": {"a": torch.zeros(3, 5, device=dev),
                    "b": torch.randn(7, 2, 3, generator=g, device=dev) * k}}


def _float_diff(got, want) -> float:
    """The largest |difference| of two lists of float tensors, ``got`` on
    any device and ``want`` on the host (shapes and dtypes must agree)."""
    worst = 0.0
    for x, y in zip(got, want):
        x = x.cpu()
        if x.shape != y.shape or x.dtype != y.dtype:
            raise AssertionError(f"shape/dtype differ: {x.shape} {x.dtype} "
                                 f"vs {y.shape} {y.dtype}")
        if not torch.equal(x, y):
            worst = max(worst, float((x.double() - y.double()).abs().max()))
    return worst


def _sync_ms(fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def phase_mesh(dev) -> dict:
    """The port's training-mesh pieces on one card: a mesh of four
    ``cuda:0`` entries on axis ``dp`` runs ``compressed_allreduce_grads``
    (int8 payloads, error feedback) over seeded gradient trees, each round
    held bit for bit to the same call on the host; JAX's error-feedback
    check (16 rounds of a constant 0.01 gradient, mean within rtol 0.1);
    and moonshot's parameter tree (every width, 2 layers) placed by
    ``lm_param_rules`` on a (data 2, model 2) mesh of ``cuda:0`` entries
    and gathered back bit for bit."""
    mesh = make_mesh((MESH_RANKS,), ("dp",), devices=[dev] * MESH_RANKS)
    host = make_mesh((MESH_RANKS,), ("dp",), devices=[HOST] * MESH_RANKS)
    out = {"phase": "mesh", "ranks": MESH_RANKS, "big_leaf": MESH_BIG}
    err = [init_error_feedback(_mesh_grads(r, 0, dev))
           for r in range(MESH_RANKS)]
    herr = [tree_map(lambda x: x.cpu(), e) for e in err]
    rounds = []
    for i in range(MESH_ROUNDS):
        grads = [_mesh_grads(r, i, dev) for r in range(MESH_RANKS)]
        res, ms = _sync_ms(lambda: compressed_allreduce_grads(
            grads, err, mesh, "dp"))
        hgrads = [tree_map(lambda x: x.cpu(), g) for g in grads]
        t = time.perf_counter()
        hres = compressed_allreduce_grads(hgrads, herr, host, "dp")
        host_s = time.perf_counter() - t
        err_max = max(_float_diff(tree_leaves(m) + tree_leaves(e),
                                  tree_leaves(hm) + tree_leaves(he))
                      for (m, e), (hm, he) in zip(res, hres))
        if err_max:
            raise AssertionError(f"mesh: round {i}'s all-reduce differs "
                                 f"from the host's by {err_max}")
        err = [e for _, e in res]
        herr = [e for _, e in hres]
        rounds.append({"ms": ms, "host_s": host_s, "max_abs_err": err_max})
        elements = sum(x.numel() for x in tree_leaves(grads[0]))
        del grads, hgrads, res, hres
    out["allreduce"] = {
        "rounds": rounds, "bit_equal_host": True,
        "payload_bytes_per_rank": elements,
        "f32_bytes_per_rank": 4 * elements}
    del err, herr
    g = {"w": torch.full((64,), 0.01, device=dev)}
    err = [init_error_feedback(g) for _ in range(MESH_RANKS)]
    total = torch.zeros(64, device=dev)
    t = time.perf_counter()
    for _ in range(MESH_EF_ROUNDS):
        res = compressed_allreduce_grads([g] * MESH_RANKS, err, mesh, "dp")
        err = [e for _, e in res]
        total = total + res[0][0]["w"]
    torch.cuda.synchronize()
    ef_ms = (time.perf_counter() - t) * 1e3
    np.testing.assert_allclose((total / MESH_EF_ROUNDS).cpu().numpy(), 0.01,
                               rtol=0.1)
    out["error_feedback"] = {"rounds": MESH_EF_ROUNDS, "ms": ef_ms,
                             "mean": float(total.mean() / MESH_EF_ROUNDS),
                             "rtol": 0.1}
    cfg = dataclasses.replace(get_arch(MESH_LM_ARCH).config,
                              n_layers=MESH_LM_LAYERS)
    params = T.init_params(cfg, generator=torch.Generator(device=dev)
                           .manual_seed(0), device=dev)
    lm_mesh = make_mesh((2, 2), ("data", "model"), devices=[dev] * 4)
    placements = SHR.shardings_from_rules(params, SHR.lm_param_rules(lm_mesh),
                                          lm_mesh)
    placed, place_ms = _sync_ms(lambda: place_tree(params, placements))
    back, gather_ms = _sync_ms(lambda: tree_map(gather, placed))
    bad = []
    entry_bytes = [0] * 4
    specs = {}
    for path, x, y, b in zip(*SHR.tree_paths(params), tree_leaves(placed),
                             tree_leaves(back)):
        if not (isinstance(y, SpecBlocks) and torch.equal(x, b)):
            bad.append(path)
        specs[path] = list(y.spec)
        for j, sh in enumerate(y.shards):
            entry_bytes[j] += sh.numel() * sh.element_size()
    if bad:
        raise AssertionError(f"mesh: {bad} did not gather back bit-equal")
    total_bytes = sum(x.numel() * x.element_size()
                      for x in tree_leaves(params))
    out["lm_placement"] = {
        "arch": MESH_LM_ARCH, "n_layers": MESH_LM_LAYERS,
        "mesh": lm_mesh.shape, "leaves": len(specs), "specs": specs,
        "param_bytes": total_bytes, "entry_bytes": entry_bytes,
        "place_ms": place_ms, "gather_ms": gather_ms,
        "gather_bit_equal": True}
    del params, placed, back
    gc.collect()
    torch.cuda.empty_cache()
    emit(out)
    return out


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
    with _Hook(fops, "window_rng", lambda i: i, clone=False) as draws:
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
    rng_out = {**_draws_held(draws, "twitter session"),
               **_session_draw_timing(draws)}
    del draws

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
           "window_rng": rng_out, "split": split_out,
           "loops": _window_loops(s, cfg, dev, prefix)}
    emit(out)
    return out, part, g, s


def _session_draw_timing(draws) -> dict:
    """The main path's window_rng launch (the session's first draw: its
    rows cover the feed's full windows) timed again on its own key and
    shape: the kernel and the plain version from CUDA-graph replay, and
    the bound."""
    (key, t0, rows, k), _, _, _ = draws.kept[0]
    return {"shape": [rows, k], "t0": t0,
            "ms": graph_ms(lambda: rops.window_rng(key, t0, rows, k), 20),
            "eager_ms": eager_ms(lambda: rops.window_rng(key, t0, rows, k),
                                 20),
            "plain_ms": graph_ms(lambda: window_rng_ref(key, t0, rows, k),
                                 2),
            **_rng_bound(1, rows, k)}


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


# ---------------------------------------------------------------------------
# phase serve: the serving tier and crash-safe sessions on the card
# ---------------------------------------------------------------------------

SERVE_MEAN_BATCH = 24.0      # fig14's Poisson burst size (events)
SERVE_OVERLOAD = 4.0         # λ = 4 × the synchronous driver's capacity
SERVE_MAX_PENDING = 64       # fig14's ingest queue bound
SERVE_QUERY_IDS = 1024       # ids in each racing where_many
SERVE_QUERY_GAP_S = 0.002    # the racing reader's pause between queries
SERVE_SNAPSHOT_EVERY = 16384
SERVE_CRASH_AT = 0.7         # the injected crash, as a share of the stream
SERVE_RECOVER_CHUNK = 3000   # events per feed of the recovering session
SERVE_DIR = os.path.join(ROOT, "build", "repro_torch", "smoke_serve")
KILLED_CHILD = """
import os, signal, sys
from repro_torch.api import Partitioner
from repro_torch.api import scenarios as sc
from repro_torch.core.config import EngineConfig
from repro_torch.runtime import RecoverableSession

g, s = sc.lifecycle_stream("grqc")
part = Partitioner.from_stream(s, EngineConfig(**sc.LIFECYCLE_CFG["grqc"]),
                               policy="sdp", seed=0, use_kernel=True,
                               window=256, engine="windowed", device="cuda")
sess = RecoverableSession(part, sys.argv[1], snapshot_every=1536)
stop = int(sys.argv[2])
for a in range(0, stop, 500):
    b = min(a + 500, stop)
    sess.feed((s.etype[a:b], s.vertex[a:b], s.nbrs[a:b]))
sess.wait()                   # snapshots on disk, journal written
print("CHILD_FED", sess.cursor, flush=True)
os.kill(os.getpid(), signal.SIGKILL)      # no atexit, no cleanup
"""


class _Recorded(Partitioner):
    """A session that records the cursor after each dispatched batch: the
    boundaries a racing query may observe."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.boundaries = [0]

    def feed_prepared(self, chunk):
        super().feed_prepared(chunk)
        self.boundaries.append(self.cursor)
        return self


def _serve_session(s, dev, cls=Partitioner):
    return cls.from_stream(s, EngineConfig(**sc.LIFECYCLE_CFG["twitter"]),
                           policy="sdp", seed=0, use_kernel=True,
                           window=WINDOW, engine="windowed", device=dev)


def _pcts(seconds) -> dict:
    return {"p50_ms": _ms_pct(seconds, 50), "p99_ms": _ms_pct(seconds, 99)}


def _run_sync_feed(s, dev, batches, due) -> tuple:
    """fig14's naive driver: sleep to each arrival's due time, feed it,
    sync — one (padded) window per arrival."""
    part = _serve_session(s, dev)
    lat = np.empty(len(batches))
    t0 = time.perf_counter()
    for i, chunk in enumerate(batches):
        ahead = due[i] - (time.perf_counter() - t0)
        if ahead > 0:
            time.sleep(ahead)
        part.feed(chunk).sync()
        lat[i] = (time.perf_counter() - t0) - due[i]
    return part, time.perf_counter() - t0, lat


def _profiler():
    """torch.profiler over every thread: the service's kernels are launched
    from its ingest thread."""
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA],
        experimental_config=torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True))


def _profiled_busy(prof, wall_s: float) -> dict:
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        rows.append((us, e.key, e.count))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    return {"traced_wall_s": wall_s, "traced_device_s": busy,
            "device_ops": sum(r[2] for r in rows),
            "device_busy_share": busy / wall_s if rows else None,
            "top_kernels": [{"name": k[:100], "count": c, "ms": us / 1e3}
                            for us, k, c in rows[:6]]}


def _run_service(s, dev, batches, due, *, trace=False, reader=False):
    """The same arrivals through PartitionService. ``trace``: torch.profiler
    over the whole run, from the first arrival to the flush. ``reader``: a
    second thread calls where_many on SERVE_QUERY_IDS random ids every
    SERVE_QUERY_GAP_S while ingest runs, recording the cursor before and
    after each query."""
    part = _serve_session(s, dev, _Recorded)
    svc = PartitionService(part, max_pending_chunks=SERVE_MAX_PENDING,
                           policy="block")
    answers, stop = [], threading.Event()
    rng = np.random.default_rng(7)

    def read():
        while not stop.is_set():
            ids = rng.integers(0, s.n, SERVE_QUERY_IDS).astype(np.int32)
            lo = part.cursor
            t = time.perf_counter()
            got = svc.where_many(ids)
            answers.append((lo, ids, got, part.cursor,
                            time.perf_counter() - t))
            stop.wait(SERVE_QUERY_GAP_S)

    th = threading.Thread(target=read, daemon=True) if reader else None
    prof = None
    if trace:
        with _profiler():              # the profiler's one-off start-up
            torch.zeros(1, device=dev).add_(1)
        prof = _profiler()
        prof.__enter__()
    t0 = time.perf_counter()
    if th is not None:
        th.start()
    for i, chunk in enumerate(batches):
        ahead = due[i] - (time.perf_counter() - t0)
        if ahead > 0:
            time.sleep(ahead)
        svc.submit(chunk, arrival=t0 + due[i], timeout=300)
    svc.flush(timeout=300)
    dur = time.perf_counter() - t0
    if prof is not None:
        prof.__exit__(None, None, None)
    stop.set()
    if th is not None:
        th.join(timeout=300)
        if th.is_alive():
            raise AssertionError("serve: the racing reader did not stop")
    m = svc.metrics()
    lat = svc.latencies()
    svc.close()
    out = {"seconds": dur, "events_per_s": s.num_events / dur,
           **_pcts(lat), "batches_dispatched": m["batches_dispatched"],
           "mean_batch_events": s.num_events / m["batches_dispatched"],
           **{k: m[k] for k in ("coercion_s", "device_wait_s",
                                "submit_blocked_s", "max_queue_depth",
                                "device_busy_fraction")}}
    if trace:
        out["profiler"] = _profiled_busy(prof, dur)
    return part, out, answers


def _check_answers(s, dev, part, answers) -> dict:
    """Each racing answer equals a synchronous card session's labels at a
    dispatched batch boundary between the cursors read around it."""
    ref = _serve_session(s, dev)
    pending = sorted(range(len(answers)), key=lambda i: answers[i][0])
    ok = [False] * len(answers)
    prev = 0
    for c in part.boundaries:
        ref.feed((s.etype[prev:c], s.vertex[prev:c], s.nbrs[prev:c]))
        prev = c
        labels = None
        for i in pending:
            lo, ids, got, hi, _ = answers[i]
            if lo > c:
                break
            if ok[i] or hi < c:
                continue
            if labels is None:
                labels = ref.state.assignment.cpu().numpy()
            ok[i] = bool(np.array_equal(got, labels[ids]))
        pending = [i for i in pending if not ok[i]]
    if pending:
        lo, _, _, hi, _ = answers[pending[0]]
        raise AssertionError(
            f"serve: {len(pending)} of {len(answers)} racing queries match "
            f"no batch boundary (first: cursors {lo}..{hi})")
    return {"queries": len(answers), **_pcts([a[4] for a in answers]),
            "boundaries": len(part.boundaries) - 1,
            "boundaries_per_query": float(np.mean(
                [sum(lo <= c <= hi for c in part.boundaries)
                 for lo, _, _, hi, _ in answers[::max(len(answers) // 64,
                                                      1)]]))}


def _dir_bytes(directory: str) -> dict:
    out = {"journal_bytes": 0, "checkpoint_bytes": 0}
    for root, _, files in os.walk(directory):
        key = "journal_bytes" if os.path.basename(root) == "journal" \
            else "checkpoint_bytes"
        out[key] += sum(os.path.getsize(os.path.join(root, f))
                        for f in files)
    return out


def _serve_recovery(s, dev, ref) -> dict:
    """A RecoverableSession over the twitter stream, crashing (injected)
    at SERVE_CRASH_AT of it; recover() on the card, then the rest."""
    directory = os.path.join(SERVE_DIR, "crash")
    shutil.rmtree(directory, ignore_errors=True)
    T = s.num_events
    crash_at = int(SERVE_CRASH_AT * T)
    sess = RecoverableSession(_serve_session(s, dev), directory,
                              snapshot_every=SERVE_SNAPSHOT_EVERY,
                              inject_crash_after=crash_at)
    t = time.perf_counter()
    try:
        for a in range(0, T, SERVE_RECOVER_CHUNK):
            b = min(a + SERVE_RECOVER_CHUNK, T)
            sess.feed((s.etype[a:b], s.vertex[a:b], s.nbrs[a:b]))
        raise AssertionError("serve: the injected crash never fired")
    except CrashError:
        pass
    sess.wait()
    torch.cuda.synchronize()
    fed_s = time.perf_counter() - t
    snapshots, on_disk = sess.metrics()["snapshots"], _dir_bytes(directory)
    del sess
    kw = dict(policy="sdp", use_kernel=True, window=WINDOW,
              engine="windowed", device=dev)
    cfg = EngineConfig(**sc.LIFECYCLE_CFG["twitter"])
    # the restore alone (its session is dropped), then the whole recovery:
    # restore + journal replay
    t = time.perf_counter()
    restored_at = Partitioner.restore(directory, cfg, **kw).cursor
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t
    t = time.perf_counter()
    rec = RecoverableSession.recover(directory, cfg,
                                     snapshot_every=SERVE_SNAPSHOT_EVERY,
                                     **kw)
    torch.cuda.synchronize()
    recover_s = time.perf_counter() - t
    replayed = rec.cursor - restored_at
    c = rec.cursor
    rec.feed((s.etype[c:], s.vertex[c:], s.nbrs[c:]))
    rec.sync()
    # the replayed tail writes background snapshots: join them before the
    # directory goes, or a writer's rename finds it gone
    rec.wait()
    assert_states_equal(rec.state, ref.state,
                        "serve: recovered session vs the uninterrupted one")
    shutil.rmtree(directory, ignore_errors=True)
    return {"crash_at": crash_at, "fed_until_crash_s": fed_s,
            "snapshots": snapshots, **on_disk,
            "restored_cursor": restored_at, "replayed_events": replayed,
            "restore_s": restore_s, "replay_s": recover_s - restore_s,
            "recover_s": recover_s, "recovered_equal": True}


def _killed_process(dev) -> dict:
    """A child python3 feeds grqc's churn session on the card through a
    RecoverableSession and SIGKILLs itself mid-stream; this process
    recovers on the card, finishes, and meets the JAX package's digest."""
    directory = os.path.join(SERVE_DIR, "killed")
    shutil.rmtree(directory, ignore_errors=True)
    g, s = sc.lifecycle_stream("grqc")
    stop = s.num_events * 2 // 3
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", KILLED_CHILD, directory,
                          str(stop)], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    child_s = time.perf_counter() - t
    if out.returncode != -9 or f"CHILD_FED {stop}" not in out.stdout:
        raise AssertionError(f"serve: the child was not killed mid-stream "
                             f"(exit {out.returncode}): {out.stderr[-2000:]}")
    snapshot = CheckpointManager(directory, interval=1).latest()
    t = time.perf_counter()
    rec = RecoverableSession.recover(
        directory, EngineConfig(**sc.LIFECYCLE_CFG["grqc"]), policy="sdp",
        use_kernel=True, window=WINDOW, engine="windowed", device=dev)
    torch.cuda.synchronize()
    recover_s = time.perf_counter() - t
    if rec.cursor != stop:
        raise AssertionError(f"serve: recovered cursor {rec.cursor}, the "
                             f"child fed {stop}")
    rec.feed((s.etype[stop:], s.vertex[stop:], s.nbrs[stop:]))
    rec.wait()
    digest = state_digest(rec.state)
    if digest != sc.GRQC_SESSION_DIGEST:
        raise AssertionError("serve: the SIGKILL-recovered grqc session "
                             "differs from the JAX package's")
    shutil.rmtree(directory, ignore_errors=True)
    return {"events": s.num_events, "killed_at": stop,
            "restored_cursor": snapshot, "replayed_events": stop - snapshot,
            "child_s": child_s, "recover_s": recover_s, "digest_ok": True}


def _serve_recover_serve(s, dev, ref, batches) -> dict:
    """The crash-safe tier: a service over a RecoverableSession serves the
    first half of the arrivals and is closed; a service over the recovered
    session serves the rest; the end state is the whole-stream state."""
    directory = os.path.join(SERVE_DIR, "tier")
    shutil.rmtree(directory, ignore_errors=True)
    half = len(batches) // 2
    sess = RecoverableSession(_serve_session(s, dev), directory,
                              snapshot_every=SERVE_SNAPSHOT_EVERY)
    t = time.perf_counter()
    with PartitionService(sess, max_pending_chunks=SERVE_MAX_PENDING) as svc:
        for chunk in batches[:half]:
            svc.submit(chunk, timeout=300)
        svc.flush(timeout=300)
    sess.wait()
    first_s = time.perf_counter() - t
    at, snaps = sess.cursor, sess.metrics()["snapshots"]
    del sess, svc
    t = time.perf_counter()
    rec = RecoverableSession.recover(
        directory, EngineConfig(**sc.LIFECYCLE_CFG["twitter"]),
        snapshot_every=SERVE_SNAPSHOT_EVERY, policy="sdp", use_kernel=True,
        window=WINDOW, engine="windowed", device=dev)
    recover_s = time.perf_counter() - t
    if rec.cursor != at:
        raise AssertionError(f"serve: the tier recovered at {rec.cursor}, "
                             f"it had served {at}")
    t = time.perf_counter()
    with PartitionService(rec, max_pending_chunks=SERVE_MAX_PENDING) as svc:
        for chunk in batches[half:]:
            svc.submit(chunk, timeout=300)
        svc.flush(timeout=300)
    rec.wait()
    second_s = time.perf_counter() - t
    assert_states_equal(rec.state, ref.state,
                        "serve: serve-recover-serve vs the whole stream")
    shutil.rmtree(directory, ignore_errors=True)
    return {"served_before_close": at, "snapshots_before_close": snaps,
            "first_half_s": first_s, "recover_s": recover_s,
            "second_half_s": second_s, "state_equal": True}


def phase_serve(dev, s, card: str) -> dict:
    """The serving tier on the card at twitter's full size, as
    benchmarks/fig14_serving.py runs it: Poisson arrivals (mean burst 24)
    at 4 × the synchronous driver's capacity, fed by the synchronous
    driver and by PartitionService (every dispatch a padded window on the
    kernels); a reader racing ingest; then crash recovery, a SIGKILLed
    process and the crash-safe tier."""
    T = s.num_events
    t_phase = t = time.perf_counter()
    thread_errors, hook = [], threading.excepthook

    def record(args):
        thread_errors.append(f"{args.thread.name}: {args.exc_value!r}")
        hook(args)

    # a background checkpoint writer's failure (a rename into a removed
    # directory, say) fails the phase
    threading.excepthook = record
    ref = _serve_session(s, dev).feed(s)
    ref.sync()
    ref_s = time.perf_counter() - t
    if state_digest(ref.state) != sc.TWITTER_SESSION_DIGEST:
        raise AssertionError("serve: the whole-stream session differs from "
                             "the JAX package's")
    bounds, _ = poisson_arrivals(s, rate=1.0, mean_batch=SERVE_MEAN_BATCH,
                                 seed=1)
    batches = [(s.etype[a:b], s.vertex[a:b], s.nbrs[a:b])
               for a, b in zip(bounds[:-1], bounds[1:])]
    _run_sync_feed(s, dev, batches[:256], np.zeros(256))     # warm-up
    part, cap_s, cap_lat = _run_sync_feed(s, dev, batches,
                                          np.zeros(len(batches)))
    assert_states_equal(part.state, ref.state, "serve: unthrottled sync")
    capacity = T / cap_s
    lam = SERVE_OVERLOAD * capacity
    _, due = poisson_arrivals(s, rate=lam, mean_batch=SERVE_MEAN_BATCH,
                              seed=1)
    part, sync_s, sync_lat = _run_sync_feed(s, dev, batches, due)
    assert_states_equal(part.state, ref.state, "serve: sync_feed")
    drivers = {"sync_unthrottled": {"seconds": cap_s,
                                    "events_per_s": capacity,
                                    **_pcts(cap_lat)},
               "sync_feed": {"seconds": sync_s, "events_per_s": T / sync_s,
                             **_pcts(sync_lat),
                             "batches_dispatched": len(batches),
                             "mean_batch_events": T / len(batches)}}
    del part
    _reset_launches()
    with _Hook(fops, "window_rng", lambda i: i, clone=False) as draws:
        part, drivers["service"], _ = _run_service(s, dev, batches, due)
    launches = _read_launches()
    windows = _window_kinds(part)
    _check_session_launches(launches, windows, "serve: the service")
    service_draws = _draws_held(draws, "serve: the service")
    del draws
    assert_states_equal(part.state, ref.state, "serve: service")
    if state_digest(part.state) != sc.TWITTER_SESSION_DIGEST:
        raise AssertionError("serve: the service's state differs from the "
                             "JAX package's")
    del part
    part, traced, _ = _run_service(s, dev, batches, due, trace=True)
    assert_states_equal(part.state, ref.state, "serve: traced service")
    del part
    part, raced, answers = _run_service(s, dev, batches, due, reader=True)
    assert_states_equal(part.state, ref.state, "serve: raced service")
    queries = _check_answers(s, dev, part, answers)
    del part, answers
    out = {"phase": "serve", "card": card, "events": T, "n": s.n,
           "chunks": len(batches), "mean_batch": SERVE_MEAN_BATCH,
           "window": WINDOW, "engine": "windowed",
           "max_pending_chunks": SERVE_MAX_PENDING,
           "whole_stream_s": ref_s, "arrival_rate_eps": lam,
           "drivers": drivers, "launches": launches, "windows": windows,
           "window_rng_draws": service_draws,
           "states_equal": True, "digest_ok": True,
           "traced_service": traced,
           "raced_service": {**raced, "queries": queries},
           "recovery": _serve_recovery(s, dev, ref),
           "killed_process": _killed_process(dev),
           "serve_recover_serve": _serve_recover_serve(s, dev, ref, batches)}
    shutil.rmtree(SERVE_DIR, ignore_errors=True)
    threading.excepthook = hook
    if thread_errors:
        raise AssertionError(f"serve: a thread failed: {thread_errors}")
    out["thread_errors"] = 0
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phase sweep: the sweep lanes on the card
# ---------------------------------------------------------------------------

SWEEP_GRQC_LANES = 64        # fig11's largest lane count
SWEEP_TWITTER_LANES = 16
SWEEP_K200_LANES = 4
SWEEP_PREFIX_EVENTS = 2 * WINDOW    # the plain windowed lanes' prefix
SWEEP_SCAN_EVENTS = 96              # the scan lanes' prefix (per-event loop)
SWEEP_SHORT_LANES = 2
SWEEP_REBALANCE = dict(m=128, every=8 * WINDOW, passes=2, lanes=[1, 3])
# the rebalance lanes' prefix: two passes, then two windows that end short
# of the next
SWEEP_REBALANCE_EVENTS = 2 * SWEEP_REBALANCE["every"] + 2 * WINDOW
SWEEP_PROFILE_EVENTS = 64 * WINDOW   # the profiled prefix of twitter's lanes
SWEEP_TIMED_LANES = (1, 16, 64)


class _Hook:
    """Within it, ``module.<attr>`` is wrapped: its call i (counted from 0
    across the block) runs as before and, where ``key(i)`` is not None,
    keeps ``kept[key(i)] = (args, kwargs, out, after)``. ``args`` are the
    call's own arguments, or with ``clone`` copies of its tensors taken
    before the call (a kernel may write its inputs in place); ``after``
    is None, or with ``after`` copies taken after the call. A later call
    with the same key replaces the kept one."""

    def __init__(self, module, attr: str, key, clone: bool = True,
                 after: bool = False):
        self.module, self.attr, self.key = module, attr, key
        self.clone, self.after = clone, after
        self.calls, self.kept = 0, {}

    def __enter__(self):
        fn = self._fn = getattr(self.module, self.attr)

        def copy(a):
            return tuple(x.clone() if isinstance(x, torch.Tensor) else x
                         for x in a)

        def hooked(*a, **kw):
            k = self.key(self.calls)
            self.calls += 1
            if k is None:
                return fn(*a, **kw)
            before = copy(a) if self.clone else a
            out = fn(*a, **kw)
            self.kept[k] = (before, dict(kw), out,
                            copy(a) if self.after else None)
            return out

        setattr(self.module, self.attr, hooked)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self._fn)


def _capture_sweep(step: int) -> _Hook:
    """Keeps the inputs of the sweep form's launcher (``fk.sweep_launch``,
    which the counted wrapper calls) at window step ``step``."""
    return _Hook(fk, "sweep_launch", lambda i: 0 if i == step else None)


def _sweep_runs(n_lanes, sdp_cfg, other_cfg) -> list:
    """Lane b runs POLICIES[b % 6] with seed b // 6: the six policies ×
    seeds; SDP lanes take ``sdp_cfg`` (autoscale), the others
    ``other_cfg``."""
    runs = []
    for b in range(n_lanes):
        p = POLICIES[b % len(POLICIES)]
        runs.append(SweepRun(p, sdp_cfg if p == "sdp" else other_cfg,
                             b // len(POLICIES)))
    return runs


def _lane_session(s, r, dev):
    """A lane's own card session: the kernels, windows of WINDOW events,
    the tail padded into a window."""
    part = Partitioner.from_stream(s, r.cfg, policy=r.policy, seed=r.seed,
                                   use_kernel=True, window=WINDOW,
                                   engine="windowed", device=dev).feed(s)
    part.sync()
    return part


def _sweep_vs_sessions(name, s, runs, dev, kernel: str) -> dict:
    """One kernel sweep over ``s`` (the main path: launches counted around
    it alone), then each lane's own card session, timed in turn and held
    leaf for leaf to its lane; and the sweep form's inputs at the middle
    window step held to its plain version (``_sweep_form_plain``)."""
    windows = -(-s.num_events // WINDOW)
    L = len(runs)
    _reset_launches()
    held = {0, windows // 2, windows - 1}
    t = time.perf_counter()
    with _capture_sweep(windows // 2) as cap, \
            _Hook(fops, "window_rng", lambda i: i if i in held else None,
                  clone=False) as draws:
        res = Sweep(s, device=dev).lanes(runs).windowed(WINDOW).kernel().run()
        torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t
    launches = _read_launches(SWEEP_KERNELS)
    by_kernel = dict(fk.fused_window_choose_lanes.kernel_launches)
    want = {"window_prep": L * windows, "window_rng": windows,
            "fused_chooser_sweep": windows, "fused_chooser": 0,
            "add_window_choose": 0, "partition_affinity": 0}
    if launches != want or by_kernel[f"sweep_{kernel}"] != windows:
        raise AssertionError(f"sweep {name}: launched {launches} "
                             f"({by_kernel}), want {want} on sweep_{kernel}")
    sessions_s = 0.0
    for r, lane in zip(runs, res):
        t = time.perf_counter()
        part = _lane_session(s, r, dev)
        sessions_s += time.perf_counter() - t
        assert_states_equal(lane.state, part.state,
                            f"sweep {name}: lane {r.policy}/{r.seed} vs its "
                            "card session")
        del part
    return {"lanes": L, "events": s.num_events, "windows": windows,
            "n": s.n, "max_deg": s.max_deg, "k_max": runs[0].cfg.k_max,
            "sweep_s": sweep_s,
            "lane_events_per_s": L * s.num_events / sweep_s,
            "sessions_s": sessions_s,
            "session_events_per_s": L * s.num_events / sessions_s,
            "speedup": sessions_s / sweep_s, "launches": launches,
            "launches_by_kernel": by_kernel, "lanes_equal_sessions": True,
            # the first, middle and last window step's one draw for every
            # lane, each held to the plain version
            "window_rng_draws": {"steps": sorted(held),
                                 **_draws_held(draws, f"sweep {name}")},
            "policies": [r.policy for r in runs],
            "plain": _sweep_form_plain(cap.kept[0], res[0].state,
                                       f"sweep {name}", windows // 2)}, res


def _sweep_form_plain(inputs, lane_state, what: str, step: int) -> dict:
    """The sweep form's counted wrapper on one of the main path's launches
    (``inputs``: every lane's own window of its own state, as
    ``_capture_sweep`` keeps them), with the lanes' flags and again with
    every scale gate flipped; in each, the first lane of each policy held
    bit for bit to the plain version (``fused_window_choose_lanes_ref``, on
    the host) on the same inputs. ``lane_state``: a lane's state, for
    ``n``."""
    (_kernel, *tensors, flags), kw, _, _ = inputs
    kw = {**kw, "n": lane_state.assignment.shape[0]}
    pidx = flags[:, 0].tolist()
    pick = [pidx.index(i) for i in sorted(set(pidx))]
    sel = torch.tensor(pick, device=flags.device)
    t = time.perf_counter()
    worst = 0
    for flip in (False, True):
        f = flags.clone()
        if flip:
            f[:, 1] = 1 - f[:, 1]
        got = fk.fused_window_choose_lanes(*tensors, f, **kw)
        want = on_host(fused_window_choose_lanes_ref,
                       *(x[sel] for x in tensors), f[sel], **kw)
        err = max_abs_diff([x[sel] for x in got], want)
        if err:
            raise AssertionError(f"{what}: the sweep form differs from its "
                                 f"plain version at window step {step} "
                                 f"(gates flipped: {flip}) by {err}")
        worst = max(worst, err)
    return {"window_step": step, "lanes": int(flags.shape[0]),
            "lanes_checked": pick, "gates": ["sweep's", "flipped"],
            "dynamic": kw["dynamic"], "max_abs_err": worst,
            "s": time.perf_counter() - t}


def _prefix(s, t):
    return VertexStream(s.etype[:t], s.vertex[:t], s.nbrs[:t], n=s.n)


def _sweep_short(s, runs, dev) -> dict:
    """Short prefixes of the two host-looped lanes: the plain windowed
    lanes (``use_kernel=False``) against each lane's card session, and the
    scan lanes (with traces) against ``run_stream`` on the card."""
    sub = _prefix(s, SWEEP_PREFIX_EVENTS)
    t = time.perf_counter()
    plain = Sweep(sub, device=dev).lanes(runs).windowed(WINDOW).run()
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t
    for r, lane in zip(runs, plain):
        assert_states_equal(lane.state, _lane_session(sub, r, dev).state,
                            f"sweep plain lane {r.policy} vs its session")
    sub = _prefix(s, SWEEP_SCAN_EVENTS)
    t = time.perf_counter()
    scan = Sweep(sub, device=dev).lanes(runs).chunked(50).run()
    torch.cuda.synchronize()
    scan_s = time.perf_counter() - t
    for r, lane in zip(runs, scan):
        st, tr = engine.run_stream(sub, policy=r.policy, cfg=r.cfg,
                                   seed=r.seed, device=dev)
        assert_states_equal(lane.state, st, f"sweep scan lane {r.policy}")
        for f in tr._fields:
            if not torch.equal(getattr(tr, f), getattr(lane.trace, f)):
                raise AssertionError(f"sweep scan lane {r.policy}: trace "
                                     f"{f} differs from run_stream's")
    return {"lanes": len(runs),
            "windowed_plain": {"events": SWEEP_PREFIX_EVENTS,
                               "sweep_s": plain_s, "equal_sessions": True},
            "scan": {"events": SWEEP_SCAN_EVENTS, "chunk": 50,
                     "sweep_s": scan_s, "equal_run_stream": True,
                     "traces_equal": True}}


def _sweep_k200(s, dev) -> dict:
    """The large layout: grqc at k_max = 200, four lanes through the
    sweep's large kernel, each lane equal to its card session; the first
    window held to the plain lanes on the card."""
    runs = _sweep_runs(
        SWEEP_K200_LANES,
        EngineConfig(k_max=200, k_init=1, max_cap=K_200_CAP, autoscale=True),
        EngineConfig(k_max=200, k_init=4, max_cap=1 << 30,
                        autoscale=False))
    out, _ = _sweep_vs_sessions("grqc k200", s, runs, dev, "large")
    sub = _prefix(s, WINDOW)
    kern = Sweep(sub, device=dev).lanes(runs).windowed(WINDOW).kernel().run()
    plain = Sweep(sub, device=dev).lanes(runs).windowed(WINDOW).run()
    for r, a, b in zip(runs, kern, plain):
        assert_states_equal(a.state, b.state,
                            f"sweep k200 lane {r.policy} vs the plain lane")
    out["prefix_equal_plain_lanes"] = WINDOW
    return out


def _sweep_rebalance(s, runs, dev) -> dict:
    """Rebalance lanes: the first four grqc lanes with
    ``rebalance(m=128, every=2048, passes=2, lanes=[1, 3])`` on the
    stream's first SWEEP_REBALANCE_EVENTS. The gated-off lanes equal the
    sweep without rebalance; each rebalanced lane equals a card session fed
    in chunks of ``every`` events and rebalanced after each full chunk, and
    its counters a from-scratch recount."""
    runs = runs[:4]
    rb = SWEEP_REBALANCE
    s = _prefix(s, SWEEP_REBALANCE_EVENTS)
    base = Sweep(s, device=dev).lanes(runs).windowed(WINDOW).kernel().run()
    t = time.perf_counter()
    res = (Sweep(s, device=dev).lanes(runs).windowed(WINDOW).kernel()
           .rebalance(rb["m"], every=rb["every"], passes=rb["passes"],
                      lanes=rb["lanes"]).run())
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t
    T = s.num_events
    moved = {}
    for b, (r, lane) in enumerate(zip(runs, res)):
        if b not in rb["lanes"]:
            assert_states_equal(lane.state, base[b].state,
                                f"sweep rebalance: gated-off lane {b}")
            continue
        check_recount(lane.state, f"sweep rebalance lane {b}")
        part = Partitioner.from_stream(s, r.cfg, policy=r.policy,
                                       seed=r.seed, use_kernel=True,
                                       window=WINDOW, engine="windowed",
                                       device=dev)
        for a in range(0, T, rb["every"]):
            e = min(a + rb["every"], T)
            part.feed((s.etype[a:e], s.vertex[a:e], s.nbrs[a:e]))
            if e - a == rb["every"]:
                part.rebalance(m=rb["m"], passes=rb["passes"])
        assert_states_equal(lane.state, part.state,
                            f"sweep rebalance lane {b} vs its session")
        moved[b] = int((lane.state.assignment
                        != base[b].state.assignment).sum())
    return {**rb, "lanes_rebalanced": rb["lanes"], "events": T,
            "sweep_s": sweep_s, "passes_run": T // rb["every"],
            "vertices_moved_vs_unrebalanced": moved,
            "gated_off_equal": True, "rebalanced_equal_sessions": True}


def _sweep_form_timing(dev, cases) -> dict:
    """The sweep form (one launch; a setup's window replicated on L lanes
    of the six policies in turn, every scale gate on) against the
    single-session kernel at the same window, device ms from CUDA-graph
    replay: at twitter's shape (256, 192, 16) and grqc's rows (256, 2,843,
    16), L = 1, 16, 64. Every launch's lanes are held bit for bit to the
    single-session kernel; at L = 1 on twitter's shape also to the plain
    version, which is timed there once (eager: one lane's slot loop is
    ~1 s of host-issued ops)."""
    out = {}
    for setup, label in (("session", "twitter_shape"),
                         ("grqc_wide", "grqc_shape")):
        n, one, _ = _chooser_inputs(dev, cases, setup)
        w, d = one[1].shape
        k = one[3].shape[1]
        singles = [fk.launch("lanes", *one, policy=p, balance_guard="text",
                             autoscaling=True) for p in POLICIES]
        rows = []
        for lanes in SWEEP_TIMED_LANES:
            args = tuple(x.unsqueeze(0).expand((lanes,) + x.shape)
                         .contiguous() for x in one)
            flags = torch.tensor([[b % len(POLICIES), 1]
                                  for b in range(lanes)],
                                 dtype=torch.int32, device=dev)

            def sweep_call(args=args, flags=flags):
                return fk.sweep_launch("lanes", *args, flags,
                                       balance_guard="text", dynamic=True)
            got = sweep_call()
            err = max(max_abs_diff([x[b] for x in got],
                                   singles[b % len(POLICIES)])
                      for b in range(lanes))
            if err:
                raise AssertionError(f"sweep form differs from the single "
                                     f"kernel at {setup}, L = {lanes}")
            row = {"lanes": lanes, "shape": [lanes, w, d, k],
                   "ms": graph_ms(sweep_call, 10),
                   "max_abs_err_vs_single": err,
                   **_bound(lanes * _fused_bytes(w, d, k), 0)}
            if setup == "session" and lanes == 1:
                t = time.perf_counter()
                want = fused_window_choose_lanes_ref(
                    *args, flags, n=n, balance_guard="text", dynamic=True)
                torch.cuda.synchronize()
                row["plain_ms"] = (time.perf_counter() - t) * 1e3
                row["max_abs_err"] = max_abs_diff(got, want)
                if row["max_abs_err"]:
                    raise AssertionError("sweep form differs from its plain "
                                         "version")
            rows.append(row)
        out[label] = {"single_sdp_ms": graph_ms(lambda: fk.launch(
            "lanes", *one, policy="sdp", balance_guard="text",
            autoscaling=True), 10), "lanes": rows}
    return out


def _sweep_profile(s, runs, dev) -> dict:
    """torch.profiler over a run of the lanes ``runs`` (twitter's 16, or
    grqc's 64) on the stream's first SWEEP_PROFILE_EVENTS (set-up
    included): the host-issued device ops per window step and the
    device's busy share."""
    s = _prefix(s, SWEEP_PROFILE_EVENTS)
    windows = -(-s.num_events // WINDOW)
    with _profiler() as prof:
        t = time.perf_counter()
        Sweep(s, device=dev).lanes(runs).windowed(WINDOW).kernel().run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    busy = _profiled_busy(prof, wall)
    return {"lanes": len(runs), "events": s.num_events,
            "window_steps": windows, **busy,
            "device_ops_per_window_step": busy["device_ops"] / windows}


def phase_sweep(dev, twitter_s, cases, card: str) -> dict:
    """The sweep lanes on the card (``Sweep(...).windowed(256).kernel()``:
    per window step each lane's window_prep and window_rng, then one
    sweep-form fused_chooser launch for every lane): grqc at scale 1.0
    with fig11's 64 lanes (six policies × seeds, SDP with autoscale at
    max_cap 1,500, the others ``default_cfg(k=4, k_max=16)``), twitter at
    scale 1.0 with 16, each lane equal to its own card session and the
    sweep timed against those sessions in turn; the large layout at
    k_max = 200; short prefixes of the plain and scan lanes; rebalance
    lanes; the sweep form's device time at L = 1, 16, 64 against the
    single-session kernel; a profile of the twitter lanes and one of
    grqc's 64. In each of the grqc, twitter and K = 200 sweeps, one
    launch's lanes are also held to the sweep form's plain version
    (``_sweep_form_plain``); in the grqc and twitter sweeps the first,
    middle and last window step's window_rng draw (all lanes in one
    launch) to the plain RNG."""
    t_phase = time.perf_counter()
    part_s = {}

    def part(name, fn, *a):
        t = time.perf_counter()
        r = fn(*a)
        part_s[name] = time.perf_counter() - t
        return r

    grqc = interleaved_churn(load_dataset("grqc"), **EVENT_ARGS)
    sdp_cfg = EngineConfig(k_max=16, k_init=1, max_cap=1500, autoscale=True)
    other_cfg = EngineConfig(k_max=16, k_init=4, max_cap=1 << 30,
                             autoscale=False)
    runs = _sweep_runs(SWEEP_GRQC_LANES, sdp_cfg, other_cfg)
    grqc_out, res = part("grqc", _sweep_vs_sessions, "grqc", grqc, runs, dev,
                         "lanes")
    del res
    rebalance = part("rebalance", _sweep_rebalance, grqc, runs, dev)
    short = part("short", _sweep_short, grqc, runs[:SWEEP_SHORT_LANES], dev)
    k200 = part("k200", _sweep_k200, grqc, dev)
    tw_runs = _sweep_runs(
        SWEEP_TWITTER_LANES,
        EngineConfig(k_max=K_MAX, k_init=1, max_cap=40000, autoscale=True),
        other_cfg)
    twitter_out, res = part("twitter", _sweep_vs_sessions, "twitter",
                            twitter_s, tw_runs, dev, "lanes")
    del res
    out = {"phase": "sweep", "card": card, "grqc": grqc_out,
           "twitter": twitter_out, "k200": k200, "short": short,
           "rebalance": rebalance,
           "sweep_form": part("sweep_form", _sweep_form_timing, dev, cases),
           "profile": part("profile", _sweep_profile, twitter_s, tw_runs,
                           dev),
           "profile_64": part("profile_64", _sweep_profile, grqc, runs,
                              dev)}
    out["part_s"] = part_s
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phase shard: vertex-sharded sessions, the fault-tolerant loop, the elastic
# runner
# ---------------------------------------------------------------------------

class _RowCapture(_Hook):
    """Hooks ``shard_session.window_prep_rows`` (the counted wrapper, so the
    main path's launches still count) and keeps copies of the inputs and
    outputs of every block's launch in window ``at``, and of the block's
    adjacency after it — to be held to the plain loop on the host after the
    run."""

    def __init__(self, at: int, blocks: int):
        self.at, self.blocks = at, blocks
        super().__init__(
            shard_session, "window_prep_rows",
            lambda i: i % blocks if i // blocks == at else None, after=True)

    def check(self, what: str) -> dict:
        """Every kept launch against the plain loop on host copies: the
        emissions and the block's adjacency after the window."""
        if len(self.kept) != self.blocks:
            raise AssertionError(f"{what}: kept {len(self.kept)} row-block "
                                 f"launches of window {self.at}, want "
                                 f"{self.blocks}")
        t = time.perf_counter()
        err = 0
        for (adj, *args, lo), _, out, after in self.kept.values():
            adj_h = adj.to(HOST)
            want = prepare_rows_ref(adj_h, *(a.to(HOST) for a in args), lo)
            err = max(err, max_abs_diff([o.to(HOST) for o in out], want),
                      max_abs_diff([after[0].to(HOST)], [adj_h]))
        if err:
            raise AssertionError(f"{what}: window_prep_rows differs from its "
                                 f"plain loop by {err} at window {self.at}")
        return {"window": self.at, "blocks": self.blocks,
                "max_abs_err": err, "host_s": time.perf_counter() - t}


def _feed_chunks(part, s, bounds):
    T = s.num_events
    cuts = [0] + [c for c in bounds if 0 < c < T] + [T]
    for a, b in zip(cuts[:-1], cuts[1:]):
        part.feed((s.etype[a:b], s.vertex[a:b], s.nbrs[a:b]))
    return part.sync()


def _rows_launches() -> dict:
    return {"window_prep_rows": window_prep_rows.launches,
            "fused_chooser": fk.fused_window_choose.launches,
            "window_rng": rops.window_rng.launches}


def _reset_rows_launches():
    _reset_launches()
    window_prep_rows.launches = 0


def _sharded_run(s, cfg, devices, bounds, want, what: str) -> dict:
    """One sharded card session over ``devices`` (row blocks) fed ``s`` in
    the chunks ``bounds``: timed, its launches read (the row-block prep P
    times a window, the chooser and the RNG once, nothing else), the
    middle window's row-block launches held to the plain loop, and the
    final state held to ``want`` (a host state)."""
    p = len(devices)
    T = s.num_events
    cuts = [0] + [c for c in bounds if 0 < c < T] + [T]
    windows = sum(-(-(b - a) // WINDOW) for a, b in zip(cuts[:-1], cuts[1:]))
    torch.cuda.reset_peak_memory_stats(devices[0])
    cap = _RowCapture(windows // 2, p)
    _reset_rows_launches()
    with cap:
        t = time.perf_counter()
        part = Partitioner.from_stream(s, cfg, policy="sdp", seed=0,
                                       window=WINDOW, sharded=True,
                                       shard_devices=devices)
        _feed_chunks(part, s, bounds)
        run_s = time.perf_counter() - t
    launches = _rows_launches()
    others = {k: v for k, v in _read_launches().items()
              if k not in launches and v}
    m = part.metrics()
    want_l = {"window_prep_rows": p * m["mixed_windows"],
              "fused_chooser": m["mixed_windows"],
              "window_rng": m["mixed_windows"]}
    # windows on the kernels (a card mesh) or their plain versions
    counted = m["kernel_windows" if devices[0].type == "cuda"
                else "fallback_windows"]
    if launches != want_l or others or counted != windows \
            or m["mixed_windows"] != windows:
        raise AssertionError(f"{what}: launches {launches} (others "
                             f"{others}), windows {m['mixed_windows']} of "
                             f"{windows}, want {want_l}")
    got = unshard_state(part.state, n=s.n)
    assert_states_equal(got, want, what)
    return {"blocks": p, "devices": sorted({str(d) for d in devices}),
            "events": s.num_events, "windows": windows, "run_s": run_s,
            "events_per_s": s.num_events / run_s, "launches": launches,
            "per_device_state_bytes": m["per_device_state_bytes"],
            "state_bytes": m["state_bytes"], "n_rows": part.n,
            "max_memory_allocated": torch.cuda.max_memory_allocated(
                devices[0]),
            "plain_check": cap.check(what), "bit_equal": True}


def _shard_profile(s, cfg, devices) -> dict:
    """torch.profiler over the first SHARD_PROFILE_WINDOWS windows of a
    sharded session: host-issued device ops per window and the device's
    busy share."""
    t_end = SHARD_PROFILE_WINDOWS * WINDOW
    part = Partitioner.from_stream(s, cfg, policy="sdp", seed=0,
                                   window=WINDOW, sharded=True,
                                   shard_devices=devices)
    part.feed((s.etype[:WINDOW], s.vertex[:WINDOW], s.nbrs[:WINDOW]))
    part.sync()
    with _profiler() as prof:
        t = time.perf_counter()
        part.feed((s.etype[WINDOW:t_end], s.vertex[WINDOW:t_end],
                   s.nbrs[WINDOW:t_end]))
        part.sync()
        wall = time.perf_counter() - t
    busy = _profiled_busy(prof, wall)
    return {"windows": SHARD_PROFILE_WINDOWS - 1, **busy,
            "device_ops_per_window": busy["device_ops"]
            / (SHARD_PROFILE_WINDOWS - 1)}


def _rows_bytes(adj, ets, vs, rows, fresh) -> int:
    """Bytes one row-block launch (the block of rows 0 .. n_loc - 1) must
    move on this window's data: each slot's event, subject and first row
    entry (its u) in, and the rest of the row of each fresh ADD the block
    owns (``fresh``: the plain version's owner-masked flag) — no other
    event row is read —; both emissions (W x D and W x 4) out; the presence
    at the window's start of each owned vertex the window names; and each
    row of the block that a chain walks (fresh ADDs, DEL_VERTEXes,
    DEL_EDGEs) read once, unless a fresh ADD starts the chain (it
    overwrites the row unread), and written once if a fresh ADD or a
    DEL_EDGE writes it."""
    w, d = rows.shape
    n_loc = adj.shape[0]
    et, v, u, fr = (x.tolist() for x in (ets, vs, rows[:, 0], fresh))
    first, wrote, named = {}, set(), set()
    for j in range(w):
        if v[j] < 0:                           # a pad
            continue
        slots = []                             # (row, writes, a fresh ADD)
        if et[j] == 0 and fr[j]:
            slots.append((v[j], True, True))
        elif et[j] == 1:
            slots.append((v[j], False, False))
        elif et[j] == 2 and u[j] >= 0:
            slots.append((v[j], True, False))
            if u[j] != v[j]:
                slots.append((u[j], True, False))
        for x in (v[j], u[j]):
            if 0 <= x < n_loc:
                named.add(x)
        for x, writes, add in slots:
            if x < n_loc:
                first.setdefault(x, add)
                if writes:
                    wrote.add(x)
    read = sum(not add for add in first.values())
    return (4 * 3 * w + 4 * (d - 1) * sum(map(bool, fr)) + len(named)
            + 4 * (w * d + 4 * w) + 4 * d * (read + len(wrote)))


def _rows_timing(dev, st, s, t0) -> dict:
    """The row-block form at twitter's shape: block 0 of four (n / 4 rows,
    D = 192) against the window at ``t0``, from CUDA-graph replay; its
    plain loop on the card; the bound."""
    mesh = make_vertices_mesh(devices=[dev] * 4)
    sh = shard_state(PartitionState(*(t.to(dev) for t in st)), mesh)
    adj, present = sh.adj.blocks[0], sh.present.blocks[0]
    sl = slice(t0, t0 + WINDOW)
    ets, vs, rows = (torch.as_tensor(x).to(dev) for x in (
        s.etype[sl], s.vertex[sl], normalize_rows(s.nbrs[sl], adj.shape[1])))
    out = {"shape": [WINDOW, adj.shape[1], adj.shape[0]], "t0": t0}
    got_adj = adj.clone()
    got = window_prep_rows(got_adj, present, ets, vs, rows, 0)
    want_adj = adj.to(HOST)
    want = prepare_rows_ref(want_adj, present.to(HOST), ets.to(HOST),
                            vs.to(HOST), rows.to(HOST), 0)
    out["max_abs_err"] = max(
        max_abs_diff([g.to(HOST) for g in got], want),
        max_abs_diff([got_adj.to(HOST)], [want_adj]))
    if out["max_abs_err"]:
        raise AssertionError(f"window_prep_rows at {out['shape']}: kernel "
                             "differs from the plain loop by "
                             f"{out['max_abs_err']}")
    c = adj.clone()
    out["ms"] = graph_ms(lambda: window_prep_rows(c, present, ets, vs, rows,
                                                  0), 20)
    out["eager_ms"] = eager_ms(lambda: window_prep_rows(
        c, present, ets, vs, rows, 0), 20)
    out["plain_ms"] = graph_ms(lambda: prepare_rows_ref(
        c, present, ets, vs, rows, 0), 1, replays=2)
    out.update(_bound(_rows_bytes(adj, ets.to(HOST), vs.to(HOST),
                                  rows.to(HOST), want.flags[:, 0]), 0))
    return out


def _fault_loop(dev, s, cfg, devices) -> dict:
    """FaultTolerantLoop over FAULT_WINDOWS twitter windows of a sharded
    state (a checkpoint a window), the middle one poisoned: one failure,
    restored and skipped; the state equals the dense mixed windows fed
    without it, at their own t0s."""
    t_phase = time.perf_counter()
    t_start = FAULT_FROM * WINDOW
    base = Partitioner.from_stream(s, cfg, policy="sdp", seed=0,
                                   window=WINDOW, engine="windowed",
                                   use_kernel=True, device=dev)
    base.feed((s.etype[:t_start], s.vertex[:t_start], s.nbrs[:t_start]))
    base.sync()
    start = to_host(base.state)
    del base
    n, width = start.adj.shape
    windows = []
    for i in range(FAULT_FROM, FAULT_FROM + FAULT_WINDOWS):
        sl = slice(i * WINDOW, (i + 1) * WINDOW)
        windows.append((i * WINDOW, *(torch.as_tensor(x).to(dev) for x in (
            s.etype[sl], s.vertex[sl], normalize_rows(s.nbrs[sl], width)))))
    bad = FAULT_WINDOWS // 2
    batches = windows[:bad] + ["poison"] + windows[bad + 1:]
    knobs = knob_tensor(cfg, n, dev)

    def step_fn(state, batch):
        if isinstance(batch, str):
            raise RuntimeError("poisoned window")
        t0, et, vx, nb = batch
        return shard_session.sharded_window(
            state, et, vx, nb, t0, n_sem=n, policy="sdp", cfg=cfg,
            knobs=knobs), {}

    ckpt_dir = os.path.join(SHARD_DIR, "fault")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    mesh = make_vertices_mesh(devices=devices)
    loop = FaultTolerantLoop(CheckpointManager(ckpt_dir, interval=1,
                                               keep=2))
    t = time.perf_counter()
    got, step = loop.run(
        shard_state(PartitionState(*(x.to(dev) for x in start)), mesh),
        batches, step_fn)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t
    events = [e["event"] for e in loop.events]
    if events != ["failure"] or step != FAULT_WINDOWS - 1:
        raise AssertionError(f"fault loop: events {events}, step {step}")
    want = PartitionState(*(x.to(dev) for x in start))
    for t0, et, vx, nb in windows[:bad] + windows[bad + 1:]:
        want = fops.run_window_mixed_fused(want, et, vx, nb, t0,
                                           policy="sdp", cfg=cfg,
                                           knobs=knobs)
    assert_states_equal(unshard_state(got, n=n), want,
                        "fault loop vs the dense windows without the "
                        "poisoned one")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    return {"windows": FAULT_WINDOWS, "poisoned": FAULT_FROM + bad,
            "blocks": len(devices), "events": events, "final_step": step,
            "loop_s": loop_s, "bit_equal": True,
            "s": time.perf_counter() - t_phase}


def _elastic(dev, state) -> dict:
    """ElasticRunner: a sharded twitter state placed on 4 row blocks,
    re-scaled to 2 and back to 4 (each re-scale a blocking checkpoint):
    bit-equal to itself."""
    rows = state.adj.shape[0]

    def placements(mesh, tree):
        return tree_map(lambda x: Placement(
            mesh, "vertices" if isinstance(x, RowBlocks)
            or (np.ndim(x) >= 1 and np.shape(x)[0] == rows) else None), tree)

    ckpt_dir = os.path.join(SHARD_DIR, "elastic")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    runner = ElasticRunner(lambda devs: make_vertices_mesh(devices=devs),
                           placements,
                           CheckpointManager(ckpt_dir, interval=1, keep=1))
    want = to_host(unshard_state(state))
    t = time.perf_counter()
    st = runner.place([dev] * 4, state, {}, step=0)
    widths = [len(st.params.adj.blocks)]
    for k in (2, 4):
        st = runner.rescale(st, [dev] * k)
        widths.append(len(st.params.adj.blocks))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    assert_states_equal(to_host(unshard_state(st.params)), want,
                        "elastic 4 -> 2 -> 4")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    return {"widths": widths, "bit_equal": True, "s": secs}


def phase_shard(dev, s, twitter_host, grqc_s, grqc_cfg, grqc_host,
                card: str) -> dict:
    """Vertex-sharded sessions on the card (``Partitioner(sharded=True)``:
    each window a ``window_prep_rows`` launch per row block, one
    ``window_rng`` and one ``fused_chooser`` launch, the blocks' applies):
    twitter at scale 1.0, unchanged, at 1, 2 and 4 row blocks on one card,
    each equal to a dense card session (``engine="windowed"``) on the same
    chunks and to the twitter phase's final state; grqc at 3 blocks (n does
    not divide) against phase grqc's session; each run's middle window held
    to the row-block plain loop; a FaultTolerantLoop with a poisoned window;
    an ElasticRunner 4 -> 2 -> 4 round trip; twitter over several cards
    where the machine has them."""
    t_phase = time.perf_counter()
    part_s = {}
    cfg = EngineConfig(k_max=K_MAX, k_init=1, max_cap=40000, autoscale=True)
    t = time.perf_counter()
    dense = Partitioner.from_stream(s, cfg, policy="sdp", seed=0,
                                    window=WINDOW, engine="windowed",
                                    use_kernel=True, device=dev)
    _feed_chunks(dense, s, SHARD_CHUNKS)
    want = to_host(dense.state)
    dense_s = time.perf_counter() - t
    del dense
    assert_states_equal(want, twitter_host,
                        "twitter windowed session vs phase twitter's")
    part_s["dense"] = dense_s
    runs = {}
    for p in SHARD_WIDTHS:
        t = time.perf_counter()
        runs[f"P{p}"] = _sharded_run(s, cfg, [dev] * p, SHARD_CHUNKS, want,
                                     f"twitter at P = {p}")
        runs[f"P{p}"]["profile"] = _shard_profile(s, cfg, [dev] * p)
        part_s[f"P{p}"] = time.perf_counter() - t
    count = torch.cuda.device_count()
    if count > 1:
        p = min(4, count)
        t = time.perf_counter()
        runs["cards"] = _sharded_run(
            s, cfg, [torch.device("cuda", i) for i in range(p)],
            SHARD_CHUNKS, want, f"twitter on {p} cards")
        part_s["cards"] = time.perf_counter() - t
    else:
        runs["cards"] = {"skipped": f"torch.cuda.device_count() = {count}: "
                         "no second card to place a block on"}
    t = time.perf_counter()
    grqc = _sharded_run(grqc_s, grqc_cfg, [dev] * GRQC_SHARDS,
                        _grqc_chunks(grqc_s.num_events), grqc_host,
                        f"grqc at P = {GRQC_SHARDS}")
    part_s["grqc"] = time.perf_counter() - t
    t = time.perf_counter()
    timing = _rows_timing(dev, want, s, (FAULT_FROM + 8) * WINDOW)
    part_s["rows_timing"] = time.perf_counter() - t
    t = time.perf_counter()
    fault = _fault_loop(dev, s, cfg, [dev] * 2)
    part_s["fault"] = time.perf_counter() - t
    t = time.perf_counter()
    sharded = shard_state(PartitionState(*(x.to(dev) for x in want)),
                          make_vertices_mesh(devices=[dev] * 4))
    elastic = _elastic(dev, sharded)
    del sharded
    part_s["elastic"] = time.perf_counter() - t
    out = {"phase": "shard", "card": card, "twitter": runs, "grqc": grqc,
           "dense_windowed_s": dense_s, "rows_kernel": timing,
           "fault": fault, "elastic": elastic, "part_s": part_s,
           "phase_s": time.perf_counter() - t_phase}
    emit(out)
    return out



# ---------------------------------------------------------------------------
# phase gnn: the GNNs on the card, MeshGraphNet over SDP's halo layout
# ---------------------------------------------------------------------------

GNN_SHARDS = 8                 # examples/train_gnn_partitioned.py: k = P
GNN_FEAT = GNN_SHAPES["ogb_products"].d_feat          # 100
GNN_HALO_F = 128               # MeshGraphNet's hidden width: a layer's rows
GNN_WARMUP, GNN_STEPS = 2, 8
GNN_SPLIT_STEPS, GNN_PROFILE_STEPS = 2, 2
GNN_SMALL_STEPS = 8            # PNA's and SchNet's steps on their batch
# the first step's loss (relative) and each gradient leaf's relative L2:
# between the SDP layout, the hash layout and the dense model on the card
# (the sums accumulate in f64, so only the matmuls' f32 rounding differs),
# and between an arch's f32 step on the card and the host's f64 step on
# the same max / min choices
GNN_LOSS_REL, GNN_GRAD_REL = 1e-5, 1e-4
F32_FLOPS = 67e12          # H100 SXM f32 outside the tensor cores (data sheet)
# MeshGraphNet's 15 layers at twitter's 1,224,660 edges keep ~7.5 GB of
# activations a layer without remat (~110 GB); with it, h and e a layer
GNN_REMAT_PEAK = 40e9
GNN_MB = GNN_SHAPES["minibatch_lg"]
GNN_MOL = GNN_SHAPES["molecule"]


def _gnn_config(arch_id: str):
    return get_arch(arch_id).config


def _rel_l2(got, want) -> float:
    d = torch.linalg.vector_norm((got - want).double())
    n = torch.linalg.vector_norm(want.double())
    return float(d / n) if float(n) > 0 else float(d)


def _loss_and_grads(loss_fn, params, batch, cfg) -> tuple:
    loss, _, grads = train_steps.value_and_grad(loss_fn, params, batch, cfg)
    return float(loss), dict(layers.leaves(grads))


def _distance(got: tuple, want: tuple) -> dict:
    """``(loss, grads)`` against ``(loss, grads)``: the loss's relative
    distance, each gradient leaf's relative L2 over the entries finite on
    both sides, whether the non-finite entries are the same, and their
    count in ``want``."""
    (lg, gg), (lw, gw) = got, want
    rel, nonfinite, same = {}, {}, True
    for k, w in gw.items():
        g, w = gg[k].to(HOST).double(), w.to(HOST).double()
        fin = torch.isfinite(w)
        same = same and torch.equal(torch.isfinite(g), fin)
        if not bool(fin.all()):
            nonfinite[k] = int((~fin).sum())
        both = fin & torch.isfinite(g)
        rel[k] = _rel_l2(g[both], w[both])
    worst = max(rel, key=rel.get)
    return {"loss": lg, "reference_loss": lw,
            "loss_rel": abs(lg - lw) / abs(lw), "grad_rel_l2_max": rel[worst],
            "grad_rel_l2_max_leaf": worst, "same_nonfinite": same,
            "nonfinite_entries": nonfinite}


def _hold(got: tuple, want: tuple, what: str,
          nonfinite_ok: bool = False) -> dict:
    """``_distance``, which must show the loss within GNN_LOSS_REL, each
    gradient leaf within GNN_GRAD_REL, the same non-finite entries on both
    sides, and none unless ``nonfinite_ok``."""
    d = _distance(got, want)
    if not (np.isfinite(d["loss"]) and d["loss_rel"] <= GNN_LOSS_REL
            and d["grad_rel_l2_max"] <= GNN_GRAD_REL and d["same_nonfinite"]
            and (nonfinite_ok or not d["nonfinite_entries"])):
        raise AssertionError(f"{what}: {d} (limits: loss {GNN_LOSS_REL}, "
                             f"gradients {GNN_GRAD_REL})")
    return d


def _f64(tree: dict) -> dict:
    """A tree's f32 tensors as f64."""
    return {k: _f64(v) if isinstance(v, dict) else
            v.double() if v.dtype == torch.float32 else v
            for k, v in tree.items()}


class _Winners:
    """Within it, ``models.gnn.common``'s segment max and min keep each
    call's winners — the (E, F) mask of the valid entries equal to their
    segment's extremum — in ``winners``; with ``forced``, call i instead
    takes ``forced[i]``'s winners, its value their mean and its gradient
    shared evenly among them, as a tie's is: a step fed another step's
    choices."""

    NAMES = ("segment_max_pad", "segment_min_pad")

    def __init__(self, forced: list | None = None):
        self.forced, self.winners = forced, []

    def __enter__(self):
        self._fns = {name: getattr(GC, name) for name in self.NAMES}
        for name, fn in self._fns.items():
            setattr(GC, name, self._wrap(fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self._fns.items():
            setattr(GC, name, fn)

    def _wrap(self, fn):
        def call(data, seg_ids, n, fill):
            valid = (seg_ids >= 0)[:, None]
            if self.forced is None:
                out = fn(data, seg_ids, n, fill=fill)
                win = valid & (data == out[seg_ids.clamp(min=0).long()])
                self.winners.append(win.to(HOST))
                return out
            win = self.forced[len(self.winners)].to(data.device)
            self.winners.append(win)
            cnt = GC.segment_sum_pad(win.to(data.dtype), seg_ids, n)
            val = GC.segment_sum_pad(torch.where(win, data, 0.0), seg_ids,
                                     n) / torch.clamp(cnt, min=1.0)
            return torch.where(cnt > 0, val, fill)
        return call


def _gnn_layout(g, s, dev, policy: str) -> tuple:
    """A card session of twitter's insert stream at k_init = k_max =
    GNN_SHARDS without autoscale, as examples/train_gnn_partitioned.py
    builds its layout, and the HaloSpec of its assignment."""
    cfg = EngineConfig(k_max=GNN_SHARDS, k_init=GNN_SHARDS, autoscale=False)
    _reset_launches()
    t = time.perf_counter()
    part = Partitioner.from_stream(s, cfg, policy=policy, seed=0,
                                   use_kernel=True, window=WINDOW, device=dev)
    part.feed(s)
    part.sync()
    session_s = time.perf_counter() - t
    launches = _read_launches()
    windows = _window_kinds(part)
    _check_session_launches(launches, windows, f"gnn: the {policy} session",
                            every=False)
    m = part.metrics()
    assign = part.state.assignment.to(HOST).numpy().copy()
    del part
    assign[assign < 0] = 0
    t = time.perf_counter()
    spec = build_halo_spec(g, assign, GNN_SHARDS)
    spec_s = time.perf_counter() - t
    return spec, {
        "policy": policy, "session_s": session_s, "launches": launches,
        "windows": windows, "edge_cut_ratio": m["edge_cut_ratio"],
        "load_imbalance": m["load_imbalance"], "spec_s": spec_s,
        "published_rows": int((spec.publish_idx >= 0).sum()),
        "halo_rows": int((spec.halo_map[..., 0] >= 0).sum()),
        "block_rows_Nb": spec.block_size, "B_max": spec.publish_size,
        "H_max": spec.halo_size, "E_max": int(spec.senders.shape[1]),
        "collective_bytes_per_layer": spec.collective_bytes_per_layer(
            GNN_HALO_F)}


def _gnn_mgn(dev, g) -> tuple:
    """(a) MeshGraphNet's CONFIG trained over SDP's halo layout of twitter,
    its first step held to the hash layout's and to the dense model's; the
    result and the two layouts (``{policy: HaloSpec}``)."""
    arch = get_arch("meshgraphnet")
    cfg = _gnn_config("meshgraphnet")
    s = build_stream(g, seed=0)
    spec, layouts = {}, {}
    for policy in ("sdp", "hash"):
        spec[policy], layouts[policy] = _gnn_layout(g, s, dev, policy)
    del s
    published = {p: layouts[p]["published_rows"] for p in layouts}
    if not published["sdp"] < published["hash"]:
        raise AssertionError(f"gnn: SDP publishes no fewer rows than hash: "
                             f"{layouts}")
    batch_np = GC.graph_to_batch(g, GNN_FEAT, seed=0)
    batches = {"dense": trainer.batch_tensors(batch_np, dev)}
    loss_fns = {"dense": MGN.loss_fn}
    for policy in ("sdp", "hash"):
        batches[policy] = trainer.batch_tensors(halo_batch(
            spec[policy], batch_np["node_feat"], batch_np["targets"]), dev)
        loss_fns[policy] = make_mgn_halo_loss(cfg, spec[policy].block_size)
    del batch_np
    params = MGN.init_params(cfg, GNN_FEAT, generator=torch.Generator(
        device=dev).manual_seed(0), device=dev)

    # the first step three ways
    base = torch.cuda.memory_allocated(dev)
    first, first_s, first_peak = {}, {}, {}
    for name in ("sdp", "hash", "dense"):
        torch.cuda.reset_peak_memory_stats(dev)
        t = time.perf_counter()
        first[name] = _loss_and_grads(loss_fns[name], params, batches[name],
                                      cfg)
        torch.cuda.synchronize()
        first_s[name] = time.perf_counter() - t
        first_peak[name] = torch.cuda.max_memory_allocated(dev) - base
    checks = {"sdp_vs_dense": _hold(first["sdp"], first["dense"],
                                    "gnn: SDP layout vs dense"),
              "hash_vs_dense": _hold(first["hash"], first["dense"],
                                     "gnn: hash layout vs dense"),
              "sdp_vs_hash": _hold(first["sdp"], first["hash"],
                                   "gnn: SDP layout vs hash layout")}
    del first
    if max(first_peak.values()) > GNN_REMAT_PEAK:
        raise AssertionError(f"gnn: a remat step's peak {first_peak} passes "
                             f"{GNN_REMAT_PEAK / 1e9:.0f} GB")
    for name in ("hash", "dense"):
        del batches[name]

    # training on the SDP layout
    n_steps = GNN_WARMUP + GNN_STEPS + GNN_SPLIT_STEPS + GNN_PROFILE_STEPS
    opt = adamw(linear_warmup_cosine(TRAIN_LR, n_steps // 10 + 1, n_steps))
    opt_state = opt.init(params)
    loss_fn, hb = loss_fns["sdp"], batches["sdp"]
    step = train_steps.train_step(loss_fn, cfg, opt)
    torch.cuda.reset_peak_memory_stats(dev)
    losses, step_s = [], []
    for _ in range(GNN_WARMUP + GNN_STEPS):
        t = time.perf_counter()
        params, opt_state, m = step(params, opt_state, hb)
        losses.append(float(m["loss"]))
        step_s.append(time.perf_counter() - t)
    peak = torch.cuda.max_memory_allocated(dev)
    split = []
    for _ in range(GNN_SPLIT_STEPS):
        params, opt_state, ms = _split_step(loss_fn, params, opt_state, hb,
                                            opt, cfg)
        split.append(ms)
    torch.cuda.synchronize()
    with _profiler() as prof:
        t = time.perf_counter()
        for _ in range(GNN_PROFILE_STEPS):
            params, opt_state, _ = step(params, opt_state, hb)
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t
    busy = _profiled_busy(prof, traced_s)
    del prof, params, opt_state, step, hb, batches, loss_fns
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"gnn: MeshGraphNet's losses {losses}")
    first_rel = abs(losses[0] - checks["sdp_vs_dense"]["loss"]) \
        / abs(checks["sdp_vs_dense"]["loss"])
    if first_rel > GNN_LOSS_REL:
        raise AssertionError(f"gnn: the trainer's first loss {losses[0]} vs "
                             f"the checked step's")
    timed = np.asarray(step_s[GNN_WARMUP:])
    step_ms = _ms_pct(timed, 50)
    n_edges = 2 * g.num_edges
    flops = 3.0 * train_steps._gnn_flops_fwd(arch, g.n, n_edges, GNN_FEAT)
    return spec, {
        "arch": cfg.name, "config": dataclasses.asdict(cfg),
        "reduced": {"graph": ["ogb_products", "twitter (cap 192)"],
                    "n_nodes": [GNN_SHAPES["ogb_products"].n_nodes, g.n],
                    "n_edges": [GNN_SHAPES["ogb_products"].n_edges,
                                g.num_edges]},
        "n_nodes": g.n, "directed_edges": n_edges, "d_feat": GNN_FEAT,
        "shards": GNN_SHARDS, "layouts": layouts,
        "sdp_over_hash_published": published["sdp"] / published["hash"],
        "first_step": checks, "first_step_s": first_s,
        "first_step_peak_bytes_above_inputs": first_peak,
        "losses": losses, "step_s": step_s, "step_ms_p50": step_ms,
        "step_ms_max": float(timed.max() * 1e3),
        "split_ms_p50": {k: float(np.median([x[k] for x in split]))
                         for k in split[0]},
        "split_ms": split, "max_memory_allocated": peak, "busy": busy,
        "model_flops_per_step": flops,
        "model_flops_per_s": flops / (step_ms * 1e-3),
        "model_flop_share": flops / (step_ms * 1e-3) / F32_FLOPS,
        "model_flop_share_of": "67 TFLOP/s f32 outside the tensor cores "
                               "(TF32 off)"}


def _gnn_small(dev, arch_id: str, mod, params, batch_np, steps: int) -> dict:
    """(b)-(d): one arch's first step on the card held to the same step on
    the host's CPU in f64, fed the card step's max / min winners (PNA's),
    then ``steps`` AdamW steps on the card on the same batch (none for
    NequIP, whose gradients are non-finite here). Two f32 steps sit as far
    apart as their own roundings put each from exact arithmetic, and a
    max or min whose two best entries are within an ulp may pick either:
    so the reference is the exact step on the same choices, and the host's
    f32 step and its own choices are reported beside it."""
    cfg = _gnn_config(arch_id)
    batch = trainer.batch_tensors(batch_np, dev)
    t = time.perf_counter()
    with _Winners() as card:
        got = _loss_and_grads(mod.loss_fn, params, batch, cfg)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t
    host_params = tree_map(lambda x: x.to(HOST), params)
    host_batch = trainer.batch_tensors(batch_np, HOST)
    t = time.perf_counter()
    with _Winners(forced=card.winners):
        want = _loss_and_grads(mod.loss_fn, _f64(host_params),
                               _f64(host_batch), cfg)
    host_s = time.perf_counter() - t
    with _Winners() as host:
        host_f32 = _loss_and_grads(mod.loss_fn, host_params, host_batch, cfg)
    flips = sum(int((a != b).sum()) for a, b in zip(card.winners,
                                                     host.winners))
    out = {"arch": cfg.name, "config": dataclasses.asdict(cfg),
           "nodes": int(batch_np["node_mask"].shape[0]),
           "edges": int(batch_np["senders"].shape[0]),
           "params": sum(x.numel() for x in tree_leaves(params)),
           "first_step": _hold(got, want, f"gnn: {arch_id} card vs host",
                               nonfinite_ok=arch_id == "nequip"),
           "first_step_card_s": card_s, "first_step_host_f64_s": host_s,
           "host_f32_vs_reference": _distance(host_f32, want),
           "card_vs_host_f32": _distance(got, host_f32),
           "winner_entries": sum(int(w.sum()) for w in card.winners),
           "winners_differing_card_host_f32": flips}
    del got, want, host_f32, card, host, host_params, host_batch
    if steps:
        opt = adamw(linear_warmup_cosine(TRAIN_LR, steps // 10 + 1, steps))
        opt_state = opt.init(params)
        step = train_steps.train_step(mod.loss_fn, cfg, opt)
        losses, step_s = [], []
        for _ in range(steps):
            t = time.perf_counter()
            params, opt_state, m = step(params, opt_state, batch)
            losses.append(float(m["loss"]))
            step_s.append(time.perf_counter() - t)
        del opt_state, step
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"gnn: {arch_id}'s losses {losses}")
        out.update(losses=losses, step_ms_p50=_ms_pct(np.asarray(
            step_s[1:]), 50))
    return out


def _gnn_warm_up(dev) -> None:
    """A first step of each arch's CONFIG on a tiny batch, so that what the
    libraries keep for the process (cuBLAS's and cuBLASLt's workspaces)
    is allocated before the phase reads the card's allocation."""
    g = make_graph("mesh", 64, 170, seed=0)
    mol = trainer.batch_tensors(GC.batch_molecules(2, 12, 24, seed=0), dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    for arch_id, mod in (("meshgraphnet", MGN), ("pna", PNA)):
        params = mod.init_params(_gnn_config(arch_id), 8, generator=gen,
                                 device=dev)
        _loss_and_grads(mod.loss_fn, params, trainer.batch_tensors(
            GC.graph_to_batch(g, 8, seed=0), dev), _gnn_config(arch_id))
    for arch_id, mod in (("schnet", SCH), ("nequip", NQ)):
        params = mod.init_params(_gnn_config(arch_id), generator=gen,
                                 device=dev)
        _loss_and_grads(mod.loss_fn, params, mol, _gnn_config(arch_id))
    torch.cuda.synchronize()


def _live_blocks() -> set:
    """(address, bytes) of the caching allocator's live blocks."""
    return {(b["address"], b["size"])
            for seg in torch.cuda.memory_snapshot() for b in seg["blocks"]
            if b["state"] == "active_allocated"}


def phase_gnn(dev, g, card: str) -> tuple:
    """The GNN slice on the card, every arch at its published CONFIG: (a)
    MeshGraphNet trained over SDP's halo layout of twitter (8 blocks
    stacked on the card; the SDP and hash card sessions' HaloSpecs, the
    first step held to the hash layout's and to the dense model's), (b) PNA
    at minibatch_lg's sampled shape, (c) SchNet and (d) NequIP at the
    molecule shape, each held to the host's CPU. The card's allocation
    must be back where it was when the phase ends. Returns the phase's
    line and the SDP and hash layouts (phase ``model_mesh`` reuses them)."""
    t_phase = time.perf_counter()
    _gnn_warm_up(dev)
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated(dev)
    blocks_before = _live_blocks()
    part_s = {}
    t = time.perf_counter()
    specs, mgn = _gnn_mgn(dev, g)
    part_s["meshgraphnet"] = time.perf_counter() - t

    t = time.perf_counter()
    mb = next(dp.graph_minibatches(g, GNN_MB.d_feat, GNN_MB.batch_nodes,
                                   GNN_MB.fanout, seed=0))
    sample_s = time.perf_counter() - t
    want = subgraph_sizes(GNN_MB.batch_nodes, GNN_MB.fanout)
    got = (mb["node_mask"].shape[0], mb["senders"].shape[0])
    if got != want:
        raise AssertionError(f"gnn: minibatch of {got}, expected {want}")
    gen = torch.Generator(device=dev).manual_seed(0)
    pna = _gnn_small(dev, "pna", PNA, PNA.init_params(
        _gnn_config("pna"), GNN_MB.d_feat, generator=gen, device=dev), mb,
        GNN_SMALL_STEPS)
    pna.update(shape=GNN_MB.name, sample_s=sample_s,
               reduced={"graph": ["reddit (not in the repo)",
                                  "twitter (cap 192)"]})
    del mb
    part_s["pna"] = time.perf_counter() - t - sample_s

    mol = GC.batch_molecules(GNN_MOL.mol_batch, GNN_MOL.n_nodes,
                             GNN_MOL.n_edges, seed=0)
    isolated = int((np.bincount(mol["receivers"], minlength=mol[
        "node_mask"].shape[0]) == 0).sum())
    t = time.perf_counter()
    schnet = _gnn_small(dev, "schnet", SCH, SCH.init_params(
        _gnn_config("schnet"), generator=gen, device=dev), mol,
        GNN_SMALL_STEPS)
    part_s["schnet"] = time.perf_counter() - t
    t = time.perf_counter()
    nequip = _gnn_small(dev, "nequip", NQ, NQ.init_params(
        _gnn_config("nequip"), generator=gen, device=dev), mol, 0)
    part_s["nequip"] = time.perf_counter() - t
    for x in (schnet, nequip):
        x.update(shape=GNN_MOL.name, atoms_receiving_no_edge=isolated)
    del gen, mol
    gc.collect()
    torch.cuda.empty_cache()
    after = torch.cuda.memory_allocated(dev)
    out = {"phase": "gnn", "card": card, "meshgraphnet": mgn, "pna": pna,
           "schnet": schnet, "nequip": nequip, "part_s": part_s,
           "memory_allocated_before_after": [before, after],
           "phase_s": time.perf_counter() - t_phase}
    if after > before:
        # the line first, so that a failed run still shows the figures
        out["blocks_allocated_since"] = sorted(_live_blocks()
                                               - blocks_before)[:20]
        emit(out)
        raise AssertionError(f"gnn: the card holds {after} bytes after the "
                             f"phase, {before} before it")
    emit(out)
    return out, specs


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
    """The window pipelines with the host loops (before: the plain RNG
    drawing the window's own table) and with the window kernels (after:
    the window's rows of one draw for the prefix, as a session takes
    them), on one card, on the first ``prefix`` events of the session's
    stream: each window function on the same state, timed on the host's
    clock with a sync after it, for 4 pure-ADD and 4 mixed windows (the
    states after both held equal); then, over 8 windows of
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
    # the prefix's tables in one draw, as the session draws a feed's: each
    # window with the kernels takes its rows as an input
    tables = rops.window_rng(state.key, 0, len(kinds) * W, cfg.k_max)

    def run(st, j, plain=False):
        sl = slice(j * W, (j + 1) * W)
        tab = None if plain else tables[sl]
        if kinds[j] == "add":
            return fops.run_window_adds_fused(
                st, vx[sl], nb[sl], j * W, policy="sdp", cfg=cfg, knobs=knobs,
                rand_tab=tab)
        return fops.run_window_mixed_fused(
            st, et[sl], vx[sl], nb[sl], j * W, policy="sdp", cfg=cfg,
            knobs=knobs, rand_tab=tab)

    def timed(st, js, plain=False):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for j in js:
            st = run(st, j, plain)
        torch.cuda.synchronize()
        return time.perf_counter() - t, st

    per_window = {"add": [], "mixed": []}
    profile, graph = {}, {}
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for j in range(len(kinds)):
        if j in picks:
            with _PlainLoops():
                before_s, b = timed(fsweep.clone_state(state), [j], True)
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
                # the state it left, so their time is not a window's); the
                # graph holds the window's kernels and torch ops, its table
                # rows an input drawn before it
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


def _same_bits(a, b) -> bool:
    """Equal as bit patterns (+0.0 and -0.0 told apart)."""
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.view(torch.int32), b.view(torch.int32))


def _plain_backward_on_host(g, idx, v: int, mode: str) -> torch.Tensor:
    return on_host(lambda *a, **kw: (embedding_bag_backward_ref(*a, **kw),),
                   g, idx, v, mode=mode)[0]


def _check_backward(g, idx, v: int, mode: str, got, what: str) -> dict:
    """``got`` (the kernel's table gradient for cotangent ``g`` over bags
    ``idx``) bit-equal to the plain backward on host copies, and a second
    run (uncounted: a fresh ``backward_order`` and ``backward_launch``'s
    pass into a NaN-filled table, so every row must be written) bit-equal
    to it."""
    want = _plain_backward_on_host(g, idx, v, mode)
    same = _same_bits(got, want)
    err = 0.0 if same else float((got - want).abs().max())
    del want
    order = eb.backward_order(idx, v)
    again = torch.full_like(got, float("nan"))
    eb.backward_launch(g, idx, order, again, mode == "mean")
    torch.cuda.synchronize()
    same_again = _same_bits(again, got)
    del again, order
    if not same or not same_again:
        raise AssertionError(f"embedding_bag_backward {what}: bit-equal to "
                             f"the plain backward on the host: {same} (max "
                             f"abs {err}); to a second run: {same_again}")
    return {"shape": [v, g.shape[1], idx.shape[0], idx.shape[1]],
            "mode": mode, "max_abs_err": err, "bit_equal_to_host": True,
            "two_launches_equal": same_again,
            "padding_slots": int((idx < 0).sum())}


def _bwd_inputs(dev, v, d, b, l, kind, seed):
    """(idx, g): ids in [-1, V) (``padded``: half the bags all -1; ``hot``:
    ids from 3 rows; ``dup``: one id a bag), a bag gradient spread over
    e^±9 with -0.0 entries."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    idx = torch.randint(-1, v, (b, l), generator=gen, device=dev,
                        dtype=torch.int32)
    if kind == "padded":
        idx[::2] = -1
    elif kind == "hot":
        idx = torch.randint(0, min(v, 3), (b, l), generator=gen, device=dev,
                            dtype=torch.int32)
    elif kind == "dup":
        idx[:] = idx[:, :1].clamp(min=0)
    idx[0, 0] = -1
    g = torch.randn((b, d), generator=gen, device=dev) * torch.exp(
        torch.rand((b, 1), generator=gen, device=dev) * 18 - 9)
    g[torch.rand((b, d), generator=gen, device=dev) < 0.05] = -0.0
    return idx, g


def _clock() -> str:
    """The card's SM clock, temperature and power draw, as ``nvidia-smi``
    reads them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,temperature.gpu,power.draw",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()


def _time_backward(g, idx, v: int, mode: str) -> dict:
    """The backward at the training step's bags, device ms from CUDA-graph
    replay: the whole function (the order and the pass, what a training
    step runs: ``ms``; also issued eagerly, ``function_eager_ms``, as an
    eager caller pays it), the order alone (``backward_order``: int32
    counts, scan, placement, long-run sort), the pass alone (every row of
    the table written once, on a built order), a torch fill of the table
    (the dense write by itself), the plain version, and ``index_add_`` of
    the slot gradients into the table (the library call); with the
    function's bound (g and the ids read, the table written) and the
    pass's (g, the order and the counts read, the table written). The
    pass is timed first and again last (``pass_again_ms``), each after
    ``nvidia-smi``'s reading of the SM clock, temperature and power: the
    phase's first timing has read up to 16 % slow. Each timed call drops
    its output, so one 4.29 GB table is live at a time."""
    torch.cuda.empty_cache()
    b, l = idx.shape
    d = g.shape[1]
    mean = mode == "mean"
    order = eb.backward_order(idx, v)

    def time_pass():
        out = torch.empty((v, d), dtype=torch.float32, device=g.device)
        return _clock(), graph_ms(
            lambda: eb.backward_launch(g, idx, order, out, mean), 10)
    clock, pass_ms = time_pass()
    out = torch.empty((v, d), dtype=torch.float32, device=g.device)
    order_ms = graph_ms(lambda: eb.backward_order(idx, v) is None, 10)
    fill_ms = graph_ms(out.zero_, 10)
    valid = idx >= 0
    gs = g / torch.clamp(order.counts, min=1)[:, None].float() if mean else g
    slots = torch.where(valid[..., None], gs[:, None, :].expand(b, l, d),
                        0.0).reshape(-1, d)
    safe = torch.where(valid, idx, 0).reshape(-1).to(torch.int64)
    library_ms = graph_ms(lambda: out.index_add_(0, safe, slots), 10)
    del slots, safe, gs, out
    function_ms = graph_ms(
        lambda: eb.embedding_bag_backward(g, idx, v, mode=mode) is None, 10)
    function_eager_ms = eager_ms(
        lambda: eb.embedding_bag_backward(g, idx, v, mode=mode) is None, 10)
    plain_ms = graph_ms(
        lambda: embedding_bag_backward_ref(g, idx, v, mode=mode) is None, 2)
    clock_again, pass_again_ms = time_pass()
    touched = torch.unique(idx[valid]).numel()
    n_valid = int(valid.sum())
    pass_bytes = (g.numel() * 4 + (v + 1) * 4 + n_valid * 4
                  + (b * 4 if mean else 0) + v * d * 4)
    fn_bytes = g.numel() * 4 + idx.numel() * 4 + v * d * 4
    del order
    torch.cuda.empty_cache()
    return {"shape": [v, d, b, l], "mode": mode, "touched_rows": touched,
            "ms": function_ms, "plain_ms": plain_ms,
            "library_ms": library_ms,
            "library": "Tensor.index_add_ of the (B*L, D) slot gradients "
                       "into the table (atomics, no fixed order; no zero "
                       "fill counted)",
            "bound_ms": fn_bytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "function_bytes": fn_bytes,
            "function_ms": function_ms,
            "function_eager_ms": function_eager_ms,
            "function_bound_ms": fn_bytes / HBM_BYTES_PER_S * 1e3,
            "order_ms": order_ms, "pass_ms": pass_ms,
            "pass_again_ms": pass_again_ms,
            "clock_temp_power": [clock, clock_again],
            "pass_bound_ms": pass_bytes / HBM_BYTES_PER_S * 1e3,
            "pass_bytes": pass_bytes, "fill_ms": fill_ms,
            "gb_per_s": fn_bytes / (function_ms * 1e-3) / 1e9}


def _split_step(loss_fn, params, opt_state, batch, opt, cfg):
    """One train step (``launch.steps.train_step``'s ops) with CUDA events
    between its forward, backward and optimizer: returns the new params
    and state, and the three times in ms."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    tree = tree_map(lambda x: x.detach().requires_grad_(True), params)
    loss, _ = loss_fn(tree, batch, cfg)
    ev[1].record()
    grads = iter(torch.autograd.grad(loss, tree_leaves(tree)))
    ev[2].record()
    upd, opt_state = opt.update(tree_map(lambda _: next(grads), tree),
                                opt_state, params)
    params = apply_updates(params, upd)
    ev[3].record()
    torch.cuda.synchronize()
    names = ("forward_ms", "backward_ms", "optimizer_ms")
    return params, opt_state, {n: ev[i].elapsed_time(ev[i + 1])
                               for i, n in enumerate(names)}


def _train_cli(dev, arch_id: str, directory: str, tol: float = 0.0) -> dict:
    """``launch.train.main`` on the card at the arch's smoke config: 3
    steps with a checkpoint, then resumed to 6 — and the JAX package's
    resume semantics (the batches start again from 0) held to in-process
    steps, from the CLI's own ``build_*`` function, on batches 0, 1, 2,
    0, 1, 2 with each run's own schedule: every param leaf within ``tol``
    of its largest magnitude (0: bit for bit)."""
    shutil.rmtree(directory, ignore_errors=True)
    arch = get_arch(arch_id)
    first, last = TRAIN_CLI_STEPS
    args = ["--arch", arch_id, "--ckpt-dir", directory,
            "--ckpt-interval", str(first), "--seed", str(TRAIN_CLI_SEED)]
    shape = ({"batch": TRAIN_CLI_BATCH, "seq": None} if arch.family == "recsys"
             else {"batch": LM_CLI_BATCH, "seq": LM_CLI_SEQ})
    args += ["--batch", str(shape["batch"])]
    if shape["seq"] is not None:
        args += ["--seq", str(shape["seq"])]
    t = time.perf_counter()
    for n in TRAIN_CLI_STEPS:
        if trainer.main(args + ["--steps", str(n)]) != 0:
            raise AssertionError(f"{arch_id}: the CLI's run to {n} failed")
    cli_s = time.perf_counter() - t
    build = {"lm": trainer.build_lm, "recsys": trainer.build_recsys}
    cfg, loss_fn, params, batches = build[arch.family](
        arch, argparse.Namespace(full=False, seed=TRAIN_CLI_SEED, **shape),
        dev)
    batches = [trainer.batch_tensors(next(batches), dev)
               for _ in range(first)]
    state = None
    for n in TRAIN_CLI_STEPS:
        opt = adamw(linear_warmup_cosine(TRAIN_LR, n // 10 + 1, n))
        step = train_steps.train_step(loss_fn, cfg, opt)
        state = opt.init(params) if state is None else state
        for b in batches:
            params, state, _ = step(params, state, b)
    got, at = CheckpointManager(directory).restore((params, state))
    pairs = list(zip(tree_leaves(got[0]), tree_leaves(params)))
    worst = max(float((x - y).abs().max() / y.abs().max().clamp(min=1e-30))
                for x, y in pairs)
    bits = all(_same_bits(x, y) for x, y in pairs)
    same = at == last and (bits if tol == 0 else worst <= tol) \
        and int(got[1]["count"]) == int(state["count"]) == last
    shutil.rmtree(directory, ignore_errors=True)
    if not same:
        raise AssertionError(f"{arch_id}: the CLI's resumed run differs from "
                             f"batches 0..2 stepped twice (worst leaf "
                             f"{worst}, limit {tol})")
    return {"steps": list(TRAIN_CLI_STEPS), **shape, "resumed_at": first,
            "cli_s": cli_s, "equals_replayed_batches": same,
            "bit_equal": bits, "worst_leaf_rel_diff": worst, "limit": tol}


def phase_train(dev, card: str) -> dict:
    """Two-tower training at full width through the port's trainer:
    ``launch.steps.train_step`` (AdamW, the CLI's linear warmup and cosine)
    over ``data.recsys_batches`` in ``FaultTolerantLoop``, every bag's
    forward on ``embedding_bag`` and backward on ``embedding_bag_backward``.
    The first step's table gradients are held bit for bit to the plain
    backward on host copies of its cotangents and bags, and its loss to
    the plain bag's (``use_kernel=False``)."""
    arch = get_arch("two-tower-retrieval")
    cfg = trainer.training_config(arch, full=True)
    torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    params = RS.init_params(
        cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    opt = adamw(linear_warmup_cosine(TRAIN_LR, TRAIN_STEPS // 10 + 1,
                                     TRAIN_STEPS))
    opt_state = opt.init(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    state_bytes = sum(x.numel() * x.element_size() for x in
                      tree_leaves(params) + tree_leaves(opt_state["mu"])
                      + tree_leaves(opt_state["nu"]))
    step = train_steps.train_step(RS.loss_fn, cfg, opt)
    with torch.no_grad():
        plain_loss = float(RS.loss_fn(params, trainer.batch_tensors(
            RS.make_batch(cfg, TRAIN_BATCH, seed=0), dev), cfg,
            use_kernel=False)[0])

    losses, step_s, first = [], [], {}
    hook = _Hook(bag_ops, "embedding_bag_backward",
                 lambda i: i if i < 2 else None, clone=False)

    def stepper(state, batch):
        params, opt_state = state
        t0 = time.perf_counter()
        if not losses:
            with hook:
                params, opt_state, metrics = step(
                    params, opt_state, trainer.batch_tensors(batch, dev))
        else:
            params, opt_state, metrics = step(
                params, opt_state, trainer.batch_tensors(batch, dev))
        losses.append(float(metrics["loss"]))
        step_s.append(time.perf_counter() - t0)
        if len(losses) == 1:             # the first step's gradients
            first["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
            for (g, idx, v), kw, got, _ in hook.kept.values():
                table = "user" if idx.shape[0] == TRAIN_BATCH * \
                    cfg.user_fields else "item"
                first[table] = _check_backward(g, idx, v, kw["mode"], got,
                                               f"first step, {table} table")
                first[f"{table}_inputs"] = (g, idx, v, kw["mode"])
            hook.kept.clear()
            torch.cuda.reset_peak_memory_stats(dev)
        return (params, opt_state), metrics

    loop = FaultTolerantLoop(CheckpointManager(
        os.path.join(TRAIN_DIR, "loop"), interval=10 ** 9))
    _reset_launches()
    t = time.perf_counter()
    (params, opt_state), final = loop.run(
        (params, opt_state), itertools.islice(dp.recsys_batches(
            cfg, TRAIN_BATCH, seed=0), TRAIN_STEPS), stepper)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t
    launches = _read_launches(("embedding_bag", "embedding_bag_backward"))
    peak = torch.cuda.max_memory_allocated(dev)
    failures = [e for e in loop.events if e["event"] == "failure"]
    if failures or final != TRAIN_STEPS or len(losses) != TRAIN_STEPS:
        raise AssertionError(f"train: the loop failed: {failures}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train: a loss is not finite: {losses}")
    if losses[0] != plain_loss:
        raise AssertionError(f"train: the first step's loss {losses[0]} "
                             f"differs from the plain bag's {plain_loss}")
    want = {"embedding_bag": 2 * TRAIN_STEPS,
            "embedding_bag_backward": 2 * TRAIN_STEPS}
    if launches != want:
        raise AssertionError(f"train: launches {launches}, expected {want}")

    # the step split into forward, backward and optimizer; then profiled
    batches = dp.recsys_batches(cfg, TRAIN_BATCH, seed=0,
                                start_step=TRAIN_STEPS)
    split = []
    for _ in range(TRAIN_SPLIT_STEPS):
        batch = trainer.batch_tensors(next(batches), dev)
        params, opt_state, ms = _split_step(RS.loss_fn, params, opt_state,
                                            batch, opt, cfg)
        split.append(ms)
    profiled = [trainer.batch_tensors(next(batches), dev)
                for _ in range(TRAIN_PROFILE_STEPS)]
    torch.cuda.synchronize()
    with _profiler() as prof:
        t = time.perf_counter()
        for batch in profiled:
            params, opt_state, _ = step(params, opt_state, batch)
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t
    busy = _profiled_busy(prof, traced_s)
    del prof, profiled

    # one fixed batch, a fresh optimizer state: the loss must fall
    del opt_state
    opt_state = opt.init(params)
    fixed = trainer.batch_tensors(RS.make_batch(cfg, TRAIN_BATCH, seed=10_000),
                                  dev)
    fixed_losses = []
    for _ in range(TRAIN_FIXED_STEPS):
        params, opt_state, m = step(params, opt_state, fixed)
        fixed_losses.append(float(m["loss"]))
    if not all(np.isfinite(fixed_losses)) \
            or not fixed_losses[-1] < fixed_losses[0]:
        raise AssertionError(f"train: the fixed batch's loss did not fall: "
                             f"{fixed_losses}")
    del params, opt_state, fixed, step
    torch.cuda.empty_cache()

    g, idx, v, mode = first.pop("user_inputs")
    kernel = {"user": _time_backward(g, idx, v, mode)}
    g, idx, v, mode = first.pop("item_inputs")
    kernel["item"] = _time_backward(g, idx, v, mode)
    del g, idx
    cases = []
    for i, (v, d, b, l, kind) in enumerate(BWD_CASES):
        idx, g = _bwd_inputs(dev, v, d, b, l, kind, seed=100 + i)
        for mode in ("sum", "mean"):
            got = eb.embedding_bag_backward(g, idx, v, mode=mode)
            cases.append({"kind": kind, **_check_backward(
                g, idx, v, mode, got, f"{kind} {v}x{d} {b}x{l}")})
    del idx, g, got
    cli = _train_cli(dev, "two-tower-retrieval", TRAIN_DIR)
    torch.cuda.empty_cache()

    after_first = np.asarray(step_s[1:])
    split_p50 = {k: float(np.median([s[k] for s in split])) for k in split[0]}
    step_ms = _ms_pct(after_first, 50)
    out = {"phase": "train", "arch": cfg.name, "config": vars(cfg),
           "reduced": {"user_vocab": [arch.config.user_vocab, cfg.user_vocab],
                       "item_vocab": [arch.config.item_vocab, cfg.item_vocab],
                       "batch": [RECSYS_SHAPES["train_batch"].batch,
                                 TRAIN_BATCH]},
           "card": card, "batch": TRAIN_BATCH, "init_s": init_s,
           "params_and_moments_bytes": state_bytes,
           "steps": TRAIN_STEPS, "loop_s": loop_s,
           "step_ms_p50": step_ms, "step_ms_max": float(after_first.max()
                                                      * 1e3),
           "first_step_s": step_s[0],
           "samples_per_s": TRAIN_BATCH / (step_ms * 1e-3),
           "losses": losses, "plain_first_loss": plain_loss,
           "first_loss_equals_plain": losses[0] == plain_loss,
           "split_ms_p50": split_p50, "split_ms": split,
           "launches": launches,
           "launches_per_step": {k: n / TRAIN_STEPS
                                 for k, n in launches.items()},
           "max_memory_allocated": peak,
           "max_memory_allocated_first_step": first.pop("peak_bytes"),
           "busy": busy, "fixed_batch_losses": fixed_losses,
           "first_step": first, "kernel": kernel, "cases": cases,
           "cli": cli,
           "backward_share_of_step": {
               "passes_ms": (kernel["user"]["pass_ms"]
                             + kernel["item"]["pass_ms"]),
               "functions_ms": (kernel["user"]["function_ms"]
                                + kernel["item"]["function_ms"]),
               "step_ms_p50": step_ms}}
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


class _Recorder(_Hook):
    """Keeps the arguments, as given, of the calls of
    ``models.layers.attention`` (what every LM layer calls) of layers 0 to
    ``keep`` - 1 — by default 0 and 1, gemma2's first local and first
    global layer — of the latest step."""

    def __init__(self, n_layers: int, keep: int = 2):
        super().__init__(layers, "attention",
                         lambda i: i % n_layers if i % n_layers < keep
                         else None, clone=False)

    @property
    def step(self) -> dict:
        """{layer: (q, k, v, keyword arguments)}."""
        return {i: (*a, kw) for i, (a, kw, _, _) in self.kept.items()}


def _check_attention_at(rec: dict, what: str, chunk: int,
                        label: str = "layer") -> dict:
    """Check 1: the kernel against the plain attention at the model's own
    q/k/v of layers 0 (local) and 1 (global), to one bf16 ulp; the rows
    are named ``f"{label}{i}"``."""
    out = {}
    for i, (q, k, v, kw) in sorted(rec.items()):
        kw = dict(kw, use_kernel=True)
        got = layers.attention(q, k, v, **kw)
        want = layers.attention(q, k, v, **dict(kw, use_kernel=False,
                                                chunk=chunk))
        torch.cuda.synchronize()
        excess, err = _bf16_err(got, want)
        out[f"{label}{i}"] = {"window": kw["window"],
                              "q_offset": kw["q_offset"],
                              "q": list(q.shape), "k": list(k.shape),
                              "max_abs_err": err, "rtol": BF16_RTOL,
                              "atol": BF16_ATOL}
        if excess > 0 or not torch.isfinite(got).all():
            raise AssertionError(f"lm {what} {label} {i}: kernel attention "
                                 f"differs from the plain one by {err}")
    return out


def _time_attention_at(rec: dict, reps: int, plain_reps: int,
                       chunk: int, graph: bool) -> dict:
    """The kernel (which of them ran, its split count, its achieved rates),
    the plain version (query-chunked as the model's plain path runs it) and
    ``scaled_dot_product_attention`` at the model's own q/k/v of the
    recorded layers: with the layer's mask, ``is_causal`` where the query
    and key lengths match and there is no window, else a boolean mask. It
    has no softcap: at a softcap layer it is timed with softcap 0, a
    yardstick only (``library_softcap0_ms``); at a layer without one it
    computes the same function (``library_ms``)."""
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
        lib_ms = graph_ms(library, reps) if graph else eager_ms(library, reps)
        if cap > 0:
            row["library_softcap0_ms"] = lib_ms
            row["library"] = ("none (softcap); F.scaled_dot_product_attention "
                              "timed at the same shape and mask with softcap "
                              "0 (is_causal, else a boolean mask)")
        else:
            row["library_ms"] = lib_ms
            row["library"] = ("F.scaled_dot_product_attention (is_causal, "
                              "else a boolean mask)")
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


def _serve_lm(server, cfg, what: str) -> dict:
    """``serve_requests`` on ``server`` at the LM phases' schedule (4 slots,
    8 requests of 8,192-token prompts from numpy's seeded generator, 32
    tokens each), each prefill and decode round timed on the host's clock
    (each ends in a host read of its argmax) with its flash_attention
    launches counted, the last decode round's attention arguments of
    layers 0 and 1 kept (``decode_rec``). Checks the token streams, that
    every prefill and round ran the kernel in each layer, and that every
    prefill call took the tensor-core kernel and every decode call the
    split one."""
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
    # the wrappers hold the server's bound methods: as its attributes they
    # would make a cycle that keeps the server (its cache, its params)
    # alive until a garbage collection
    del server.add_request, server.decode_round
    launches = _read_launches(("flash_attention",))
    by_kernel = dict(fa.flash_attention.kernel_launches)
    expect = cfg.n_layers * (len(prefill_s) + len(round_s))
    if sorted(outputs) != list(range(LM_REQUESTS)) \
            or any(len(v) != LM_GEN or min(v) < 0 or max(v) >= cfg.vocab
                   for v in outputs.values()):
        raise AssertionError(f"{what}: the requests' token streams are "
                             f"incomplete")
    if len(prefill_s) != LM_REQUESTS or launches["flash_attention"] != expect \
            or set(prefill_l + round_l) != {cfg.n_layers}:
        raise AssertionError(f"{what}: not every prefill and decode round ran "
                             f"the kernel in each layer: {launches}, prefills "
                             f"{prefill_l}, rounds {round_l}")
    # every prefill call on the tensor-core kernel, every decode call split
    if by_kernel != {"f32": 0, "prefill": cfg.n_layers * len(prefill_s),
                     "split": cfg.n_layers * len(round_s)}:
        raise AssertionError(f"{what}: the bf16 calls did not take the "
                             f"prefill and split kernels: {by_kernel}")
    return {"outputs": outputs, "serve_s": serve_s, "prefill_s": prefill_s,
            "round_s": round_s, "launches": launches,
            "launches_by_kernel": by_kernel, "decode_rec": dict(rec.step)}


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

    run = _serve_lm(server, cfg, "lm")
    prefill_s, round_s = run["prefill_s"], run["round_s"]
    outputs, serve_s = run["outputs"], run["serve_s"]
    launches, by_kernel = run["launches"], run["launches_by_kernel"]
    peak = torch.cuda.max_memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    n_tokens = sum(len(v) for v in outputs.values())

    with torch.inference_mode():
        # the kernel at a decode round's own q/k/v (4 slots, the last round)
        decode_rec = run.pop("decode_rec")
        timing = {"decode": _time_attention_at(decode_rec, 20, 5,
                                               cfg.attn_chunk, graph=True)}
        if any(row["kernel"] != "split" or row["n_split"] < 2
               for row in timing["decode"].values()):
            raise AssertionError(f"lm: a decode call did not split over the "
                                 f"keys: {timing['decode']}")
        step = _decode_step_breakdown(params, cfg, server.cache_k,
                                      server.cache_v,
                                      decode_rec[1][3]["q_offset"])
        del server, decode_rec, run
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


def _routing_diff(kernel: list, plain: list) -> dict:
    """The share of (token, layer) top-k sets that two paths route
    differently, from each layer's (T, k) expert choices."""
    diff = [(torch.sort(a, dim=1).values != torch.sort(b, dim=1).values)
            .any(dim=1) for a, b in zip(kernel, plain)]
    per_layer = [float(d.float().mean()) for d in diff]
    return {"share": float(torch.stack(diff).float().mean()),
            "layers": len(diff), "tokens": int(diff[0].numel()),
            "max_layer_share": max(per_layer),
            "first_layer_differing": next(
                (i for i, x in enumerate(per_layer) if x > 0), None)}


def _route_hook() -> _Hook:
    """Keeps every ``models.moe.route`` call's outputs (probs, gate,
    expert), by call: one a layer."""
    return _Hook(moe, "route", lambda i: i, clone=False)


def _choices(hook: _Hook) -> list:
    return [hook.kept[i][2][2] for i in sorted(hook.kept)]


def _check_dispatch(p, h, mcfg) -> dict:
    """One layer's dispatch on the card against the host: from the card's
    own choices (``route`` at the layer's recorded input), every (token,
    choice)'s running count at its expert, the kept mask and the kept load
    recomputed on the host, integer for integer; then ``moe_apply``'s
    output against a per-token dense f32 sum of the kept experts, each
    token's chosen experts run on its row alone and weighted by its
    gates."""
    b, s, d = h.shape
    t, e, k = b * s, mcfg.n_experts, mcfg.top_k
    xf = h.reshape(t, d)
    _, gate, expert = moe.route(p, xf, mcfg)
    plan = moe.dispatch_plan(expert, t, mcfg)
    y, _, load = moe.moe_apply(p, h, mcfg)
    fe = expert.cpu().numpy().reshape(-1)        # one group: token-major
    pos = np.empty(fe.size, np.int64)
    seen = np.zeros(e, np.int64)
    for j, ex in enumerate(fe):
        pos[j] = seen[ex]
        seen[ex] += 1
    keep = pos < plan.cap
    want_load = np.bincount(fe[keep], minlength=e).astype(np.float32)
    exact = {"pos": np.array_equal(plan.pos.cpu().numpy().reshape(-1), pos),
             "keep": np.array_equal(plan.keep.cpu().numpy().reshape(-1), keep),
             "load": np.array_equal(load.cpu().numpy(), want_load),
             "idx_e": np.array_equal(plan.idx_e.cpu().numpy().reshape(-1),
                                     np.where(keep, fe, e)),
             "idx_c": np.array_equal(plan.idx_c.cpu().numpy().reshape(-1),
                                     np.where(keep, pos, 0))}
    if not all(exact.values()):
        raise AssertionError(f"moe: the card's dispatch differs from the "
                             f"host's at layer {MOE_DISPATCH_LAYER}: {exact}")
    ref = torch.zeros((t, d), dtype=torch.float32, device=h.device)
    tok = torch.arange(t, device=h.device).repeat_interleave(k)
    kept = torch.from_numpy(keep).to(h.device)
    flat_e, flat_g = expert.reshape(-1), gate.reshape(-1)
    for ex in range(e):
        sel = torch.nonzero((flat_e == ex) & kept).squeeze(1)
        rows = tok[sel]
        x = xf[rows].float()
        w = {n: p[n][ex].float() for n in ("wi", "wg", "wo")}
        ye = (torch.nn.functional.silu(x @ w["wg"]) * (x @ w["wi"])) @ w["wo"]
        ref.index_add_(0, rows, ye * flat_g[sel, None])
    got = y.reshape(t, d).float()
    rel = float(torch.linalg.vector_norm(got - ref)
                / torch.linalg.vector_norm(ref))
    if not torch.isfinite(got).all() or rel > MOE_DENSE_REL:
        raise AssertionError(f"moe: the combined output differs from the "
                             f"dense sum of the kept experts by {rel}")
    return {"layer": MOE_DISPATCH_LAYER, "tokens": t, "cap": plan.cap,
            "exact": exact, "dropped": int((~keep).sum()),
            "max_load": int(want_load.max()), "min_load": int(want_load.min()),
            "dense_rel_l2": rel, "limit_rel_l2": MOE_DENSE_REL,
            "dense_max_abs_err": float((got - ref).abs().max())}


class _StageMarks:
    """Within it, each named ``module.attr`` records a CUDA event as it is
    entered and as it returns: ``marks`` lists (attr, "in" or "out",
    event, output) in call order, the output only for the attrs in
    ``keep`` (a whole step's intermediates would not fit beside a large
    model). The path runs as it is, only marked."""

    def __init__(self, targets, keep=()):
        self.targets, self.keep, self.marks = targets, keep, []

    def __enter__(self):
        self._fns = []
        for module, attr in self.targets:
            fn = getattr(module, attr)
            self._fns.append((module, attr, fn))

            def hooked(*a, _fn=fn, _attr=attr, **kw):
                self._mark(_attr, "in", None)
                out = _fn(*a, **kw)
                self._mark(_attr, "out", out)
                return out

            setattr(module, attr, hooked)
        return self

    def _mark(self, attr: str, io: str, out):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.marks.append((attr, io, ev, out if attr in self.keep else None))

    def __exit__(self, *exc):
        for module, attr, fn in self._fns:
            setattr(module, attr, fn)


# the MoE layer's stages on the real path, each between two marks: the
# q/k/v projections and rope; the attention (the kernel); the output
# projection, residual and ln2 (to the router's entry); router + dispatch
# (route, the aux loss, the positions, the buffer scatter); the expert
# GEMMs (three batched products over the experts); the combine (gather,
# gates, sum) and the kept load
MOE_STAGES = {"qkv_ms": (("_qkv", "in"), ("_qkv", "out")),
              "attention_ms": (("attention", "in"), ("attention", "out")),
              "out_ln2_ms": (("attention", "out"), ("route", "in")),
              "router_dispatch_ms": (("route", "in"), ("dispatch", "out")),
              "expert_gemms_ms": (("experts", "in"), ("experts", "out")),
              "combine_ms": (("combine", "in"), ("kept_load", "out"))}


def _moe_layer_split(run, reps: int = MOE_SPLIT_REPS) -> dict:
    """The MoE layers of ``run`` (the real prefill or decode step) cut by
    CUDA events into ``MOE_STAGES``, marked where the path calls
    ``transformer._qkv``, ``layers.attention`` and ``moe``'s stage
    functions (``_StageMarks``): each stage the median over every layer of
    ``reps`` runs after a warm-up. Where the host issues slower than the
    card runs, a stage's time includes the card's wait for it."""
    targets = [(T, "_qkv"), (layers, "attention"),
               *((moe, f) for f in ("route", "dispatch_plan", "dispatch",
                                    "experts", "combine", "kept_load"))]
    rows, cap = [], None
    for rep in range(reps + 1):
        with _StageMarks(targets, keep=("dispatch_plan",)) as sm:
            run()
        torch.cuda.synchronize()
        if rep == 0:
            continue
        layer = None
        for attr, io, ev, out in sm.marks:
            if (attr, io) == ("_qkv", "in"):
                layer = {}
                rows.append(layer)
            layer[(attr, io)] = ev
            if (attr, io) == ("dispatch_plan", "out"):
                cap = out.cap
    med = {name: float(np.median([r[a].elapsed_time(r[b]) for r in rows]))
           for name, (a, b) in MOE_STAGES.items()}
    return {**med, "layer_ms": sum(med.values()), "cap": cap, "reps": reps,
            "layers_timed": len(rows) // reps}


def _moe_bytes(cfg) -> dict:
    """Bytes a token's MoE layer must read at the least: the router, and
    the chosen experts' weights (each expert's once per step however many
    tokens take it)."""
    m = cfg.moe
    expert = 3 * cfg.d_model * m.d_ff_expert * 2
    return {"expert_bytes": expert, "all_experts_bytes": m.n_experts * expert,
            "router_bytes": cfg.d_model * m.n_experts * 4}


def phase_moe(dev, card: str) -> dict:
    """moonshot-v1-16b-a3b's CONFIG (bf16, 48 layers, d 2048, 64 experts
    top 6 with expert ff 1408, vocab 163,840: 56.12 GB) served by the
    port's LMServer as phase lm serves gemma2 — 4 slots, 8 requests of
    8,192-token prompts from numpy's seeded generator, 32 tokens each,
    max_len 8,225 (a 12.94 GB cache) — every attention call of every
    prefill and decode round on the flash_attention kernel, the router,
    dispatch and expert products as plain ops (``models/moe.py``; the JAX
    package's MoE is XLA ops with no Pallas kernel).

    Checks: every attention call of one prefill and one decode round
    against the plain attention, to one bf16 ulp; the prefill and decode
    logits against the ``use_kernel=False`` path at LOGIT_REL, with the
    share of (token, layer) top-k sets the two paths route differently;
    one layer's dispatch recomputed on the host from the card's own
    choices and its combine against a dense sum (``_check_dispatch``).
    Phase lm's "prefill + decode vs forward" check is left out: the
    capacity depends on the token count, so a forward over S + 1 tokens
    dispatches with another capacity than the prefill over S and the
    one-token decode (the JAX package's own test skips it for MoE,
    tests/test_models_lm.py:39-40)."""
    cfg = get_arch(MOE_ARCH).config
    gc.collect()                  # phase lm's model must be gone
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated(dev)
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
    run = _serve_lm(server, cfg, "moe")
    prefill_s, round_s = run["prefill_s"], run["round_s"]
    serve_s, launches = run["serve_s"], run["launches"]
    by_kernel = run["launches_by_kernel"]
    peak = torch.cuda.max_memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    n_tokens = sum(len(v) for v in run["outputs"].values())

    prompt = np.random.default_rng(0).integers(0, cfg.vocab, LM_PROMPT) \
        .astype(np.int32)            # the first request's prompt
    toks = torch.from_numpy(prompt[None]).to(dev)
    with torch.inference_mode():
        decode_rec = run.pop("decode_rec")
        timing = {"decode": _time_attention_at(decode_rec, 20, 5,
                                               cfg.attn_chunk, graph=True)}
        if any(row["kernel"] != "split" or row["n_split"] < 2
               for row in timing["decode"].values()):
            raise AssertionError(f"moe: a decode call did not split over the "
                                 f"keys: {timing['decode']}")
        pos = decode_rec[1][3]["q_offset"]
        step = _decode_step_breakdown(params, cfg, server.cache_k,
                                      server.cache_v, pos)
        last = torch.from_numpy(server.tokens[:, None].copy()).to(dev)
        split = {"decode": _moe_layer_split(lambda: T.decode_step_inplace(
            params, last, server.cache_k, server.cache_v, pos, cfg))}
        split["decode"]["tokens"] = LM_SLOTS
        del server, decode_rec, run, last
        torch.cuda.empty_cache()
        split["prefill"] = _moe_layer_split(
            lambda: T.prefill_step(params, toks, cfg))
        split["prefill"]["tokens"] = LM_PROMPT
        torch.cuda.synchronize()
        with _profiler() as prof:
            t = time.perf_counter()
            T.prefill_step(params, toks, cfg)
            torch.cuda.synchronize()
            traced = time.perf_counter() - t
        prefill_busy = _profiled_busy(prof, traced)
        del prof

        # every layer's attention call of one prefill, its routing, and
        # the dispatch layer's MoE input
        with _Recorder(cfg.n_layers, keep=cfg.n_layers) as rec, \
                _route_hook() as routes, \
                _Hook(T, "moe_apply", lambda i: 0 if i == MOE_DISPATCH_LAYER
                      else None, clone=False) as moe_in:
            logits, ck, cv = T.prefill_step(params, toks, cfg)
        checks = {"attention_prefill": _check_attention_at(
            rec.step, "moe prefill", cfg.attn_chunk)}
        timing["prefill"] = _time_attention_at({0: rec.step[0]}, 10, 1,
                                               cfg.attn_chunk, graph=False)
        if timing["prefill"]["layer0"]["kernel"] != "prefill":
            raise AssertionError(f"moe: a prefill call did not take the "
                                 f"tensor-core kernel: {timing['prefill']}")
        del rec
        kernel_routes = _choices(routes)
        del routes
        (mp, h, _), _, _, _ = moe_in.kept[0]
        checks["dispatch"] = _check_dispatch(mp, h, cfg.moe)
        del moe_in, mp, h
        with _route_hook() as routes:
            plain, _, _ = T.prefill_step(params, toks, cfg, use_kernel=False)
        checks["prefill_logits"] = _logit_check(logits, plain, "moe prefill")
        checks["prefill_routing"] = _routing_diff(kernel_routes,
                                                  _choices(routes))
        del plain, routes, kernel_routes
        shape = (cfg.n_layers, 1, LM_MAX_LEN, cfg.n_kv_heads, cfg.head_dim)
        cache_k = torch.zeros(shape, dtype=cfg.torch_dtype, device=dev)
        cache_v = torch.zeros(shape, dtype=cfg.torch_dtype, device=dev)
        cache_k[:, :, :LM_PROMPT] = ck
        cache_v[:, :, :LM_PROMPT] = cv
        del ck, cv
        torch.cuda.empty_cache()
        tok = logits.argmax(-1).to(torch.int32)[:, None]
        with _Recorder(cfg.n_layers, keep=cfg.n_layers) as rec, \
                _route_hook() as routes:
            dec, _, _ = T.decode_step_inplace(params, tok, cache_k.clone(),
                                              cache_v.clone(), LM_PROMPT, cfg)
        checks["attention_decode"] = _check_attention_at(
            rec.step, "moe decode", cfg.attn_chunk)
        del rec
        kernel_routes = _choices(routes)
        with _route_hook() as routes:
            dec_plain, _, _ = T.decode_step_inplace(
                params, tok, cache_k, cache_v, LM_PROMPT, cfg,
                use_kernel=False)
        checks["decode_logits"] = _logit_check(dec, dec_plain, "moe decode")
        checks["decode_routing"] = _routing_diff(kernel_routes,
                                                 _choices(routes))
        del cache_k, cache_v, dec_plain, routes, kernel_routes
    checks_peak = torch.cuda.max_memory_allocated(dev)
    del params
    torch.cuda.empty_cache()

    kernel_prefill = timing["prefill"]["layer0"]["ms"] * cfg.n_layers
    kernel_decode = timing["decode"]["layer0"]["ms"] * cfg.n_layers
    prefill_p50, round_p50 = _ms_pct(prefill_s, 50), _ms_pct(round_s, 50)
    out = {"phase": "moe", "arch": cfg.name, "card": card, "config": {
               **{k: v for k, v in vars(cfg).items() if k != "moe"},
               "moe": vars(cfg.moe)},
           "param_count": cfg.param_count(),
           "active_param_count": cfg.active_param_count(),
           "param_bytes": param_bytes, "cache_bytes": cache_bytes,
           "memory_allocated_before": before, "init_s": init_s,
           "slots": LM_SLOTS, "requests": LM_REQUESTS,
           "prompt_len": LM_PROMPT, "gen": LM_GEN, "max_len": LM_MAX_LEN,
           "prefills": len(prefill_s), "decode_rounds": len(round_s),
           "prefill_ms_p50": prefill_p50,
           "prefill_ms_p99": _ms_pct(prefill_s, 99),
           "decode_round_ms_p50": round_p50,
           "decode_round_ms_p99": _ms_pct(round_s, 99),
           "serve_s": serve_s, "generated_tokens": n_tokens,
           "tokens_per_s": n_tokens / serve_s,
           "decode_tokens_per_s": LM_SLOTS * len(round_s) / sum(round_s),
           "prefill_tokens_per_s": LM_PROMPT / (prefill_p50 * 1e-3),
           "decode_step": step, "prefill_busy": prefill_busy,
           "layer_split": split, "moe_bytes": _moe_bytes(cfg),
           "max_memory_allocated": peak,
           "max_memory_allocated_checks": checks_peak,
           "launches": launches, "launches_by_kernel": by_kernel,
           "kernel_ms_per_prefill": kernel_prefill,
           "kernel_ms_per_decode_round": kernel_decode,
           "kernel_share": {"prefill": kernel_prefill / prefill_p50,
                            "decode_round": kernel_decode / round_p50},
           "kernel": timing, "checks": checks}
    emit(out)
    return out


class _ForcedRoutes(_Hook):
    """Within it, ``models.moe.route``'s call i (one a layer) routes to
    ``choices[i]``: its experts those, its gates the call's own probs at
    them, normalised as ``route`` normalises its top k — a path fed
    another path's expert choices."""

    def __init__(self, choices: list):
        super().__init__(moe, "route", lambda i: i, clone=False)
        self.choices = choices

    def __enter__(self):
        fn = self._fn = getattr(self.module, self.attr)

        def forced(p, xf, cfg, expert_load=None):
            i = self.calls
            self.calls += 1
            expert = self.choices[i]
            probs, _, _ = fn(p, xf, cfg, expert_load)
            gate = torch.gather(probs, 1, expert)
            out = (probs, gate / torch.sum(gate, dim=-1, keepdim=True),
                   expert)
            self.kept[i] = ((p, xf, cfg), {}, out, None)
            return out

        setattr(self.module, self.attr, forced)
        return self


def _lm_first_step(loss_fn, params, batch, cfg) -> dict:
    """The first step's loss, xent, aux and gradients of the router, the
    experts and wq, with the kernel, with the plain attention
    (``use_kernel=False``, query-chunked), and with the plain attention fed
    the kernel step's expert choices (``_ForcedRoutes``: the witness that
    separates routing flips from attention error), on the same params and
    batch — before the optimizer's moments exist, so they fit beside each
    other. Every attention call of the kernel step's forward against the
    plain attention at its own q/k/v (``_check_attention_at``); its
    flash_attention launches (the forward's only: the backward recomputes
    through the plain version), and the share of (token, layer) top-k sets
    the kernel and plain forwards route differently."""
    got = {}
    runs = (("kernel", True), ("plain", False), ("plain_kernel_routes", False))
    for name, use_kernel in runs:
        l0 = fa.flash_attention.launches
        hook = (_ForcedRoutes(got["kernel"]["choices"])
                if name == "plain_kernel_routes" else _route_hook())
        with hook as routes, _Recorder(cfg.n_layers, keep=cfg.n_layers) \
                as rec:
            loss, metrics, grads = train_steps.value_and_grad(
                functools.partial(loss_fn, use_kernel=use_kernel), params,
                batch, cfg)
        launched = fa.flash_attention.launches - l0   # not the check's
        if name == "kernel":
            with torch.no_grad():
                attention = _check_attention_at(
                    {i: (*(x.detach() for x in a[:3]), a[3])
                     for i, a in rec.step.items()},
                    "lm_train forward", cfg.attn_chunk)
        del rec
        keep = {}
        for path in LM_TRAIN_GRADS:
            a, b = path.split("/")
            keep[path] = grads["layers"][a][b]
        got[name] = {"loss": float(loss),
                     **{k: float(v) for k, v in metrics.items()},
                     "launches": launched,
                     "grads": keep, "choices": _choices(routes)}
        del grads, routes, keep
        torch.cuda.empty_cache()
    k, p, f = got["kernel"], got["plain"], got["plain_kernel_routes"]

    def rel_l2(a, b):
        return {path: float(torch.linalg.vector_norm(
                    a["grads"][path].float() - b["grads"][path].float())
                    / torch.linalg.vector_norm(b["grads"][path].float()))
                for path in LM_TRAIN_GRADS}

    scalars = ("loss", "xent", "aux", "launches")
    out = {"kernel": {n: k[n] for n in scalars},
           "plain": {n: p[n] for n in scalars},
           "plain_kernel_routes": {n: f[n] for n in scalars},
           "attention_forward": attention,
           "routing": _routing_diff(k["choices"], p["choices"]),
           "loss_rel": {n: abs(k[n] - p[n]) / abs(p[n])
                        for n in ("loss", "xent")},
           "limit_loss_rel": LM_TRAIN_LOSS_REL,
           "grad_rel_l2": rel_l2(k, p),
           "limit_grad_rel_l2": LM_TRAIN_GRAD_REL,
           "same_routes": {
               "routes_equal": len(f["choices"]) == cfg.n_layers and all(
                   torch.equal(a, b) for a, b in zip(f["choices"],
                                                     k["choices"])),
               "loss_rel": {n: abs(k[n] - f[n]) / abs(f[n])
                            for n in ("loss", "xent")},
               "grad_rel_l2": rel_l2(k, f),
               "limit_grad_rel_l2": LM_TRAIN_SAME_ROUTES_REL}}
    same = out["same_routes"]
    finite = all(np.isfinite([x[n] for x in (k, p, f)]).all()
                 for n in ("loss", "xent", "aux"))
    if not finite or max(out["loss_rel"].values()) > LM_TRAIN_LOSS_REL \
            or max(same["loss_rel"].values()) > LM_TRAIN_LOSS_REL:
        raise AssertionError(f"lm_train: the first step's loss differs from "
                             f"the plain attention's: {out}")
    if max(out["grad_rel_l2"].values()) > LM_TRAIN_GRAD_REL \
            or not all(np.isfinite(list(out["grad_rel_l2"].values()))):
        raise AssertionError(f"lm_train: the first step's gradients differ "
                             f"from the plain attention's: {out}")
    if not same["routes_equal"] \
            or max(same["grad_rel_l2"].values()) > LM_TRAIN_SAME_ROUTES_REL \
            or not all(np.isfinite(list(same["grad_rel_l2"].values()))):
        raise AssertionError(f"lm_train: on the same expert choices the "
                             f"first step's gradients differ from the plain "
                             f"attention's: {out}")
    if k["launches"] != cfg.n_layers or p["launches"] != 0 \
            or f["launches"] != 0:
        raise AssertionError(f"lm_train: flash_attention launched "
                             f"{k['launches']} / {p['launches']} / "
                             f"{f['launches']} times in the kernel / plain "
                             f"steps, not {cfg.n_layers} / 0 / 0")
    return out


def phase_lm_train(dev, card: str) -> dict:
    """LM training at full width through the port's trainer:
    ``launch.train.build_lm`` for ``--arch moonshot-v1-16b-a3b --full``
    (CONFIG at every width, n_layers cut to FULL_TRAIN_LAYERS: bf16, 2.95 B
    params) on ``token_batches`` of 2 x 4,096 tokens, AdamW with the CLI's
    warmup and cosine, ``FaultTolerantLoop`` over 10 steps; every layer's
    attention forward on flash_attention (its backward recomputes through
    the plain version, as the JAX package's custom_vjp does), the MoE and
    the vocab-chunked loss as plain ops. The first step is held to the
    plain attention's (``_lm_first_step``); every loss finite; a fixed
    batch's loss falls; the trainer CLI at the smoke config resumes as
    its replayed batches (``_train_cli``). Runs in a process of its own
    (``phase_lm_train_process``) whose allocator grows its segments in
    place, as the trainer CLI's ``--full`` LM run has it; the phase checks
    that it does."""
    arch = get_arch(LM_TRAIN_ARCH)
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    t = time.perf_counter()
    cfg, loss_fn, params, batches = trainer.build_lm(arch, argparse.Namespace(
        full=True, seed=0, batch=LM_TRAIN_BATCH, seq=LM_TRAIN_SEQ), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    if cfg != dataclasses.replace(arch.config,
                                  n_layers=trainer.FULL_TRAIN_LAYERS):
        raise AssertionError(f"lm_train: --full built {cfg}")
    first = trainer.batch_tensors(dp.lm_batch(
        cfg.vocab, LM_TRAIN_BATCH, LM_TRAIN_SEQ, seed=0, step=0), dev)
    checked = _lm_first_step(loss_fn, params, first, cfg)
    first_peak = torch.cuda.max_memory_allocated(dev)
    del first
    opt = adamw(linear_warmup_cosine(TRAIN_LR, LM_TRAIN_STEPS // 10 + 1,
                                     LM_TRAIN_STEPS))
    opt_state = opt.init(params)
    state_bytes = sum(x.numel() * x.element_size() for x in
                      tree_leaves(params) + tree_leaves(opt_state["mu"])
                      + tree_leaves(opt_state["nu"]))
    step = train_steps.train_step(loss_fn, cfg, opt)
    torch.cuda.reset_peak_memory_stats(dev)

    losses, step_s = [], []

    def stepper(state, batch):
        params, opt_state = state
        t0 = time.perf_counter()
        params, opt_state, metrics = step(
            params, opt_state, trainer.batch_tensors(batch, dev))
        losses.append(float(metrics["loss"]))
        step_s.append(time.perf_counter() - t0)
        return (params, opt_state), metrics

    loop = FaultTolerantLoop(CheckpointManager(
        os.path.join(LM_TRAIN_DIR, "loop"), interval=10 ** 9))
    _reset_launches()
    t = time.perf_counter()
    (params, opt_state), final = loop.run(
        (params, opt_state), itertools.islice(batches, LM_TRAIN_STEPS),
        stepper)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t
    launches = _read_launches(("flash_attention",))
    by_kernel = dict(fa.flash_attention.kernel_launches)
    peak = torch.cuda.max_memory_allocated(dev)
    # the segments grow in place, as launch.train.grow_segments has them
    expandable = [seg.get("is_expandable")
                  for seg in torch.cuda.memory_snapshot()]
    if not expandable or not all(expandable):
        raise AssertionError(f"lm_train: the allocator's segments are fixed "
                             f"({len(expandable)} segments): "
                             f"launch.train.grow_segments did not take")
    failures = [e for e in loop.events if e["event"] == "failure"]
    if failures or final != LM_TRAIN_STEPS or len(losses) != LM_TRAIN_STEPS:
        raise AssertionError(f"lm_train: the loop failed: {failures}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"lm_train: a loss is not finite: {losses}")
    # forward only, on the tensor-core kernel
    if launches["flash_attention"] != cfg.n_layers * LM_TRAIN_STEPS \
            or by_kernel["prefill"] != launches["flash_attention"]:
        raise AssertionError(f"lm_train: launches {launches} {by_kernel}, "
                             f"expected {cfg.n_layers} a step on prefill")

    batches = dp.token_batches(cfg.vocab, LM_TRAIN_BATCH, LM_TRAIN_SEQ,
                               seed=0, start_step=LM_TRAIN_STEPS)
    split = []
    for _ in range(LM_TRAIN_SPLIT_STEPS):
        batch = trainer.batch_tensors(next(batches), dev)
        params, opt_state, ms = _split_step(loss_fn, params, opt_state,
                                            batch, opt, cfg)
        split.append(ms)
    profiled = [trainer.batch_tensors(next(batches), dev)
                for _ in range(LM_TRAIN_PROFILE_STEPS)]
    torch.cuda.synchronize()
    with _profiler() as prof:
        t = time.perf_counter()
        for batch in profiled:
            params, opt_state, _ = step(params, opt_state, batch)
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t
    busy = _profiled_busy(prof, traced_s)
    del prof, profiled

    # one fixed batch, a fresh optimizer state: the loss must fall
    del opt_state
    opt_state = opt.init(params)
    fixed = trainer.batch_tensors(dp.lm_batch(
        cfg.vocab, LM_TRAIN_BATCH, LM_TRAIN_SEQ, seed=10_000, step=0), dev)
    fixed_losses = []
    for _ in range(LM_TRAIN_FIXED_STEPS):
        params, opt_state, m = step(params, opt_state, fixed)
        fixed_losses.append(float(m["loss"]))
    if not all(np.isfinite(fixed_losses)) \
            or not fixed_losses[-1] < fixed_losses[0]:
        raise AssertionError(f"lm_train: the fixed batch's loss did not "
                             f"fall: {fixed_losses}")
    del params, opt_state, fixed, step
    torch.cuda.empty_cache()
    cli = _train_cli(dev, LM_TRAIN_ARCH, LM_TRAIN_DIR, tol=LM_CLI_TOL)
    torch.cuda.empty_cache()

    tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
    after_first = np.asarray(step_s[1:])
    step_ms = _ms_pct(after_first, 50)
    split_p50 = {k: float(np.median([s[k] for s in split])) for k in split[0]}
    flops = 3 * train_steps._lm_flops_fwd(cfg, tokens,
                                          kv_len=LM_TRAIN_SEQ // 2)
    shape = LM_SHAPES["train_4k"]
    out = {"phase": "lm_train", "arch": cfg.name, "card": card,
           "config": {**{k: v for k, v in vars(cfg).items() if k != "moe"},
                      "moe": vars(cfg.moe)},
           "reduced": {"n_layers": [arch.config.n_layers, cfg.n_layers],
                       "batch": [shape.global_batch, LM_TRAIN_BATCH],
                       "seq": [shape.seq_len, LM_TRAIN_SEQ]},
           "param_count": cfg.param_count(),
           "active_param_count": cfg.active_param_count(),
           "memory_allocated_before": before, "init_s": init_s,
           "params_grads_moments_bytes": trainer.lm_state_bytes(cfg),
           "params_and_moments_bytes": state_bytes,
           "steps": LM_TRAIN_STEPS, "loop_s": loop_s,
           "step_ms_p50": step_ms,
           "step_ms_max": float(after_first.max() * 1e3),
           "first_step_s": step_s[0],
           "tokens_per_s": tokens / (step_ms * 1e-3),
           "losses": losses, "first_step": checked,
           "loop_first_loss_equals_checked":
               losses[0] == checked["kernel"]["loss"],
           "split_ms_p50": split_p50, "split_ms": split,
           "model_flops_per_step": flops,
           "model_flop_share": flops / (step_ms * 1e-3) / BF16_FLOPS,
           "launches": launches, "launches_by_kernel": by_kernel,
           "launches_per_step": {k: n / LM_TRAIN_STEPS
                                 for k, n in launches.items()},
           "max_memory_allocated": peak,
           "max_memory_allocated_first_step_checks": first_peak,
           "expandable_segments": len(expandable),
           "busy": busy, "fixed_batch_losses": fixed_losses, "cli": cli}
    emit(out)
    return out


def phase_lm_train_process(card: str) -> dict:
    """Phase lm_train in a child process, started as ``python -m
    repro_torch.launch.train --arch moonshot-v1-16b-a3b --full`` starts:
    ``launch.train.grow_segments`` before the process first uses CUDA, so
    the phase runs on the allocator settings the CLI gives such a run,
    with the card this process has freed. The child prints the phase's
    line; its dict comes back through a file."""
    gc.collect()                  # phase moe's model must be gone
    torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(LM_TRAIN_RESULT), exist_ok=True)
    if os.path.exists(LM_TRAIN_RESULT):
        os.remove(LM_TRAIN_RESULT)
    rc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--phase", "lm_train",
         "--card", card, "--t0", repr(_T0)], cwd=ROOT).returncode
    if rc != 0 or not os.path.exists(LM_TRAIN_RESULT):
        raise AssertionError(f"lm_train: the phase's process exited with "
                             f"{rc}")
    with open(LM_TRAIN_RESULT) as f:
        return json.load(f)


def lm_train_main(card: str) -> int:
    """The child of ``phase_lm_train_process``."""
    trainer.grow_segments()       # before this process first uses CUDA
    dev = torch.device("cuda", 0)
    torch.cuda.init()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = phase_lm_train(dev, card)
    with open(LM_TRAIN_RESULT, "w") as f:
        json.dump(out, f)
    return 0


# phase lm_mesh: launch.steps' LM bundles (build_lm) on a (data 2, model 2)
# mesh of four cuda:0 entries, each entry running its own shards with
# explicit collectives (runtime.lm_sharded; the opt scheme's train step
# runtime.lm_seqpar): moonshot and gemma2 at every width of CONFIG,
# n_layers cut to 2 (48 and 42 layers cannot share one 80 GB card with a
# one-card reference, and four entries on one card shard nothing away); a
# baseline train step at train_4k's length with one sequence a data rank,
# an opt train step at that length with batch 8 (each microbatch two rows
# a data rank: its MoE tokens regrouped into JAX's dispatch groups and its
# microbatches spread over the data ranks), a prefill of 2 x 4,096 tokens,
# a decode of 4 slots at 8,192 keys and, for gemma2, a decode of one slot
# whose cache is split over every axis. The loss's vocabulary chunk is cut
# to 1,024 tokens on both paths (four entries' logits share one card; the
# chunk changes only the order of the loss's sums)
LM_MESH_ARCHS = (MOE_ARCH, LM_ARCH)
LM_MESH_DIMS, LM_MESH_LAYERS, LM_MESH_XENT_CHUNK = (2, 2), 2, 1024
LM_MESH_BATCH, LM_MESH_OPT_BATCH, LM_MESH_SEQ = 2, 8, 4096
LM_MESH_SLOTS, LM_MESH_KEYS = 4, 8192
LM_MESH_REPS = 3
# the sharded step against the one-card step on the same params and inputs
# (both on flash_attention): they differ by where bf16 partial products are
# rounded and summed (row-parallel products summed over model in bf16, as
# GSPMD sums them), so the loss by far less than a bf16 ulp and the
# gradients (mu after step one is (1 - b1) x the clipped gradient) as phase
# lm_train's kernel and plain steps do: 2^-2 relative L2 where MoE routes
# may flip, 2^-4 on the same routes (the one-card step fed the sharded
# step's expert choices) and for a dense model; logits, the prefill's
# caches and the decode's written slot within phase lm's 2^-4, for the MoE
# model on the same routes (held to a few tokens' logits, one flipped
# near-tie moves them by O(1)); every other cache slot unchanged
LM_MESH_LOSS_REL = LM_TRAIN_LOSS_REL
LM_MESH_GRAD_REL = LM_TRAIN_GRAD_REL
LM_MESH_SAME_ROUTES_REL = LM_TRAIN_SAME_ROUTES_REL
# flash_attention's log-sum-exp (the sequence-sharded decode's merge
# weights) against the plain version's: f32 sums of the same bf16 products
# in another order, through exp2 / log2
LSE_ATOL = 1e-4


def _mesh_arch(arch_id: str) -> ArchDef:
    a = get_arch(arch_id)
    cfg = dataclasses.replace(a.config, n_layers=LM_MESH_LAYERS,
                              xent_chunk=LM_MESH_XENT_CHUNK)
    return ArchDef(arch_id, "lm", cfg, a.smoke_config, a.source,
                   skip_shapes=a.skip_shapes)


def _zeros_placed(spec, placement) -> SpecBlocks:
    """A zero ``SpecBlocks`` of ``spec``'s shape and dtype placed as
    ``placement``, each block made on its entry (no whole tensor)."""
    mesh = placement.mesh
    return SpecBlocks(mesh, placement.spec, spec.shape, [
        torch.zeros(tuple(x.stop - x.start for x in sl), dtype=spec.dtype,
                    device=d)
        for sl, d in zip(_block_slices(mesh, placement.spec, spec.shape),
                         mesh.devices)])


def _entry_bytes(tree: dict) -> list:
    """Each entry's bytes of a dict of ``SpecBlocks``."""
    leaves = tree_leaves(tree)
    return [sum(x.shards[e].numel() * x.shards[e].element_size()
                for x in leaves) for e in range(len(leaves[0].shards))]


def _mesh_hook(module, attr: str, n: int) -> _Hook:
    """Keeps the arguments, as given, of the first ``n`` calls of
    ``module.<attr>`` in a sharded call: ``layers.attention`` (a prefill,
    a decode over a cache split over heads; one call an entry a layer) or
    ``lm_sharded.flash_attention`` (a decode's key blocks where the cache
    is split over the sequence). A train step keeps its forward calls by
    ``_forward_key``."""
    return _Hook(module, attr, lambda i: i if i < n else None, clone=False)


def _mesh_attention(hook: _Hook, what: str, chunk: int) -> dict:
    """The kernel against the plain attention at each call ``hook`` kept,
    on that call's own q/k/v, to one bf16 ulp (``_check_attention_at``);
    uncounted."""
    rec = {i: (*(x.detach() for x in a), kw)
           for i, (a, kw, _, _) in hook.kept.items()}
    n0 = fa.flash_attention.launches
    with torch.no_grad():
        out = _check_attention_at(rec, what, chunk, label="call")
    fa.flash_attention.launches = n0
    return out


def _mesh_lse(hook: _Hook, what: str) -> dict:
    """The split kernel's output (one bf16 ulp) and log-sum-exp
    (``LSE_ATOL``) against ``attention_lse_ref`` at each key-block call
    ``hook`` kept, on that call's own q/k/v; uncounted."""
    out = {}
    n0 = fa.flash_attention.launches
    for i, ((q, k, v), kw, _, _) in sorted(hook.kept.items()):
        got, lse = fa.flash_attention(q, k, v, **kw)
        want, want_lse = attention_lse_ref(
            q, k, v, **{a: b for a, b in kw.items() if a != "lse"})
        torch.cuda.synchronize()
        excess, err = _bf16_err(got, want)
        lse_err = float((lse - want_lse).abs().max())
        out[f"call{i}"] = {"window": kw["window"], "q_offset": kw["q_offset"],
                           "q": list(q.shape), "k": list(k.shape),
                           "max_abs_err": err, "lse_max_abs_err": lse_err}
        if excess > 0 or not torch.isfinite(got).all() \
                or not lse_err <= LSE_ATOL:
            raise AssertionError(f"lm_mesh {what} call {i}: the split "
                                 f"kernel differs from the plain version: "
                                 f"{out[f'call{i}']}")
    fa.flash_attention.launches = n0
    return out


def _decode_launches(b, mesh, cfg, cache_len: int) -> int:
    """flash_attention's launches in one sharded decode call: an entry a
    layer where the cache is split over heads; where it is split over the
    sequence, an entry a layer whose key block holds a key the layer's
    window lets the new token see (the others launch nothing)."""
    spec = b.out_shardings[1].spec
    if spec[3] == "model":
        return len(mesh.devices) * cfg.n_layers
    ctx = lm_sharded.Ctx(mesh, cfg)
    axes = _spec_axes(spec[2])
    n = 0
    for w in (int(x) for x in cfg.windows[:cfg.n_layers]):
        lo = max(0, cache_len - w + 1) if w > 0 else 0
        for e in range(len(mesh.devices)):
            blk = ctx.entry_slice(axes, LM_MESH_KEYS, e)
            n += max(lo, blk.start) < min(cache_len + 1, blk.stop)
    return n


def _mesh_call(fn, *args):
    """One sharded call: its result, its ms (synchronised), its
    flash_attention launches (the count set to 0 just before) and the wire
    bytes each entry sent, by op."""
    collectives.reset_wire_bytes()
    fa.flash_attention.launches = 0
    out, ms = _sync_ms(lambda: fn(*args))
    wire = {op: [v.get(e, 0.0) for e in range(4)]
            for op, v in collectives.wire_bytes().items()}
    return out, {"ms": ms, "flash_attention": fa.flash_attention.launches,
                 "wire_bytes": wire}


def _forward_key(cfg, n_entries: int, micro: int):
    """A ``_Hook`` key that keeps a sharded train step's forward calls of a
    function called once an entry a layer (``layers.attention``,
    ``moe.route``): each microbatch's forward, then its backward's
    recompute (layers in reverse), each ``n_layers · n_entries`` calls."""
    per = cfg.n_layers * n_entries
    return lambda i: i if i < 2 * micro * per and (i // per) % 2 == 0 \
        else None


def _mesh_train(arch, mesh, cfg, params, dev,
                scheme: str = "baseline") -> dict:
    """A sharded train step (step one checked against the one-card step's,
    step two timed: step one carries the process's first backward) beside
    the one-card step (its first, run after the sharded ones, the sharded
    step one's ``mu`` kept on the host: a moonshot opt step and its
    one-card reference at batch 8 do not fit the card together); for an
    MoE model also the one-card step fed the sharded step's expert
    choices. Under ``opt`` the batch is LM_MESH_OPT_BATCH, the one-card
    step ``train_step(micro=2)`` on the bundle's config (dispatch groups
    n_dp · tp), and every forward attention call runs with the entry's
    ``q_offset``."""
    opt = scheme == "opt"
    shape = dataclasses.replace(
        LM_SHAPES["train_4k"], seq_len=LM_MESH_SEQ,
        global_batch=LM_MESH_OPT_BATCH if opt else LM_MESH_BATCH)
    b = train_steps.build_lm(arch, shape, mesh, scheme)
    micro = lm_seqpar.MICRO if opt else 1
    if opt:
        cfg = train_steps._lm_opt_cfg(arch, shape, mesh)
    batch = trainer.batch_tensors(dp.lm_batch(
        cfg.vocab, shape.global_batch, LM_MESH_SEQ, seed=0, step=0), dev)
    torch.cuda.reset_peak_memory_stats(dev)
    p_sh = place_tree(params, b.in_shardings[0])
    o_sh = tree_map(_zeros_placed, b.specs[1], b.in_shardings[1])
    b_sh = place_tree(batch, b.in_shardings[2])
    out = {"bundle": b.name, "scheme": scheme, "batch": shape.global_batch,
           "micro": micro, "meta": b.meta,
           "param_entry_bytes": _entry_bytes(p_sh),
           "opt_entry_bytes": _entry_bytes(o_sh)}
    n_entries = len(mesh.devices)
    forward = micro * n_entries * cfg.n_layers
    key = _forward_key(cfg, n_entries, micro)
    with _Hook(moe, "route", key, clone=False) as routes, \
            _Hook(layers, "attention", key, clone=False) as rec:
        (p_sh, o_sh, metrics), call = _mesh_call(b.fn, p_sh, o_sh, b_sh)
    out["sharded_max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    sharded = {k: float(gather(v)) for k, v in metrics.items()}
    out["sharded"] = {**sharded, **call}
    out["attention"] = _mesh_attention(rec, f"{b.name} {scheme} forward",
                                       cfg.attn_chunk)
    offsets = sorted({r["q_offset"] for r in out["attention"].values()})
    choices = _mesh_choices(routes, cfg, mesh, micro)
    attention_calls = rec.calls
    del routes, rec
    mu_sh = {path: gather(x, HOST) for path, x in tree_paths(o_sh["mu"])}
    out["sharded"]["step2"] = _mesh_call(b.fn, p_sh, o_sh, b_sh)[1]
    del p_sh, o_sh, b_sh, metrics
    gc.collect()
    torch.cuda.empty_cache()
    step = train_steps.train_step(T.loss_fn, cfg, train_steps.make_opt(),
                                  micro)
    runs = [("one_card", None)]
    if choices is not None:
        runs.append(("one_card_same_routes", choices))
    for name, forced in runs:
        state = train_steps.make_opt().init(params)
        fa.flash_attention.launches = 0
        hook = _ForcedRoutes(forced) if forced is not None else _route_hook()
        with hook:
            (new, state, m), ms = _sync_ms(lambda: step(params, state, batch))
        if choices is not None and forced is None:
            out["routing"] = _routing_diff(choices, _choices(hook))
        del hook
        rel = {"/".join(path): _rel_l2(mu_sh[path].to(dev), want)
               for path, want in tree_paths(state["mu"])}
        out[name] = {**{k: float(v) for k, v in m.items()}, "ms": ms,
                     "flash_attention": fa.flash_attention.launches,
                     "mu_rel_l2": rel}
        del new, state, m
        torch.cuda.empty_cache()
    ref = out["one_card"]
    out["loss_rel"] = abs(sharded["loss"] - ref["loss"]) / abs(ref["loss"])
    same = out.get("one_card_same_routes", ref)
    out["mu_rel_l2_max"] = max(ref["mu_rel_l2"].values())
    out["mu_rel_l2_same_routes_max"] = max(same["mu_rel_l2"].values())
    out["limits"] = {"loss_rel": LM_MESH_LOSS_REL,
                     "mu_rel_l2": LM_MESH_GRAD_REL,
                     "mu_rel_l2_same_routes": LM_MESH_SAME_ROUTES_REL}
    what = f"lm_mesh {arch.arch_id} ({scheme})"
    if not np.isfinite(list(sharded.values())).all() \
            or out["loss_rel"] > LM_MESH_LOSS_REL:
        raise AssertionError(f"{what}: the sharded step's loss differs from "
                             f"the one-card step's: {out}")
    if not out["mu_rel_l2_max"] <= LM_MESH_GRAD_REL \
            or not out["mu_rel_l2_same_routes_max"] <= \
            LM_MESH_SAME_ROUTES_REL:
        raise AssertionError(f"{what}: the sharded step's gradients differ "
                             f"from the one-card step's: {out}")
    # forward and recompute; every forward call checked against the plain
    # attention, and under opt the model rank 1 entries' at q_offset S / 2
    if call["flash_attention"] != 2 * forward \
            or attention_calls != 2 * forward \
            or len(out["attention"]) != forward \
            or (opt and offsets != [0, LM_MESH_SEQ // 2]):
        raise AssertionError(f"{what}: the sharded train step launched "
                             f"flash_attention {call['flash_attention']} "
                             f"times in {attention_calls} attention calls, "
                             f"{len(out['attention'])} checked at q_offset "
                             f"{offsets}, not {2 * forward} / {forward}")
    return out


def _mesh_routes(cfg, n_entries: int) -> _Hook:
    """Keeps a sharded call's ``moe.route`` calls (one an entry a layer)."""
    return _Hook(moe, "route", _forward_key(cfg, n_entries, 1), clone=False)


def _mesh_choices(hook: _Hook, cfg, mesh, micro: int = 1) -> list | None:
    """Each (microbatch, layer)'s global expert choices, in the one-card
    step's token order, from a sharded call's ``moe.route`` calls that
    ``hook`` kept (one an entry a layer, the forward's only); None for a
    dense model. Under the baseline scheme the model entries of a data
    rank route the same tokens: its model-rank-0 entries' choices in data
    order; under ``opt`` (``micro`` 2) entry e routes JAX's dispatch group
    e of the microbatch: every entry's, in entry order."""
    if cfg.moe is None:
        return None
    n = len(mesh.devices)
    tp = mesh.shape["model"]
    got = dict(zip(sorted(hook.kept), _choices(hook)))
    if micro == 1:
        return [torch.cat([got[n * i + e] for e in range(0, n, tp)])
                for i in range(cfg.n_layers)]
    per = cfg.n_layers * n
    return [torch.cat([got[2 * per * j + n * i + e] for e in range(n)])
            for j in range(micro) for i in range(cfg.n_layers)]


def _logit_dist(got, want) -> dict:
    top = torch.topk(want, 2, dim=-1).values
    err = float((got - want).abs().max())
    return {"shape": list(got.shape), "finite": bool(torch.isfinite(got)
                                                     .all()),
            "max_abs_err": err, "rel_l2": _rel_l2(got, want),
            "same_token": bool(torch.equal(got.argmax(-1), want.argmax(-1))),
            "top1_margin": float((top[..., 0] - top[..., 1]).min())}


def _held_to_one_card(run, compare, choices, what: str) -> dict:
    """The one-card call ``run`` LM_MESH_REPS times on its own expert
    choices (timed; the first compared), then, for an MoE model, once fed
    the sharded call's ``choices``. ``compare(result)`` gives the logits'
    distance and the cache's relative L2s; the limits (LOGIT_REL, phase
    lm's) hold on the dense model's own run and on the MoE model's
    same-routes run — on its own routes a near-tie that bf16 roundings
    flip at one of a few tokens moves that token's logits by O(1)."""
    times = []
    for i in range(LM_MESH_REPS):
        with _route_hook() as hook:
            res, ms = _sync_ms(run)
        times.append(ms)
        if i == 0:
            out = {"own_routes": compare(res)}
            own = _choices(hook)
        del res, hook
    out["one_card_ms"] = times
    held = out["own_routes"]
    if choices is not None:
        out["routing"] = _routing_diff(choices, own)
        with _ForcedRoutes(choices):
            res, _ = _sync_ms(run)
        held = out["same_routes"] = compare(res)
        del res
    lg = held["logits"]
    if not lg["finite"] or lg["rel_l2"] > LOGIT_REL \
            or (lg["top1_margin"] > 2 * lg["max_abs_err"]
                and not lg["same_token"]) \
            or max(held["cache_rel_l2"]) > LOGIT_REL:
        raise AssertionError(f"lm_mesh {what}: the sharded call differs from "
                             f"the one-card call: {out}")
    return out


def _mesh_prefill(arch, mesh, cfg, params, dev) -> dict:
    b = train_steps.build_lm(arch, dataclasses.replace(
        LM_SHAPES["prefill_32k"], seq_len=LM_MESH_SEQ,
        global_batch=LM_MESH_BATCH), mesh)
    tokens = trainer.batch_tensors(dp.lm_batch(
        cfg.vocab, LM_MESH_BATCH, LM_MESH_SEQ, seed=1, step=0), dev)["tokens"]
    p_sh = place_tree(params, b.in_shardings[0])
    t_sh = place_tree(tokens, b.in_shardings[1])
    calls, n = [], len(mesh.devices) * cfg.n_layers
    with _mesh_routes(cfg, len(mesh.devices)) as routes, \
            _mesh_hook(layers, "attention", n) as rec:
        for _ in range(LM_MESH_REPS):
            (lg, ck, cv), call = _mesh_call(b.fn, p_sh, t_sh)
            calls.append(call)
    attention = _mesh_attention(rec, b.name, cfg.attn_chunk)
    choices = _mesh_choices(routes, cfg, mesh)
    del routes, p_sh, rec
    lg, ck, cv = gather(lg), gather(ck), gather(cv)

    def compare(res):
        want, wk, wv = res
        return {"logits": _logit_dist(lg, want),
                "cache_rel_l2": [_rel_l2(ck, wk), _rel_l2(cv, wv)]}

    out = {"bundle": b.name, "cache_spec": list(b.out_shardings[1].spec),
           "sharded": calls[0], "sharded_ms": [c["ms"] for c in calls],
           "attention": attention,
           **_held_to_one_card(lambda: T.prefill_step(params, tokens, cfg),
                               compare, choices, b.name)}
    if calls[0]["flash_attention"] != n:
        raise AssertionError(f"lm_mesh {b.name}: flash_attention launched "
                             f"{calls[0]['flash_attention']} times, not {n}")
    return out


def _mesh_decode(arch, mesh, cfg, params, dev, slots: int) -> dict:
    b = train_steps.build_lm(arch, dataclasses.replace(
        LM_SHAPES["decode_32k"], seq_len=LM_MESH_KEYS, global_batch=slots),
        mesh)
    g = torch.Generator(device=dev).manual_seed(2)
    shape = (cfg.n_layers, slots, LM_MESH_KEYS, cfg.n_kv_heads, cfg.head_dim)
    ck = torch.randn(shape, generator=g, device=dev).to(cfg.torch_dtype)
    cv = torch.randn(shape, generator=g, device=dev).to(cfg.torch_dtype)
    n = LM_MESH_KEYS - 1
    token = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (slots, 1)).astype(np.int32)).to(dev)
    args = place_tree((params, token, ck, cv,
                       torch.tensor(n, dtype=torch.int32)), b.in_shardings)
    calls, launches = [], _decode_launches(b, mesh, cfg, n)
    with _mesh_routes(cfg, len(mesh.devices)) as routes, \
            _mesh_hook(layers, "attention", launches) as rec, \
            _mesh_hook(lm_sharded, "flash_attention", launches) as blocks:
        for _ in range(LM_MESH_REPS):
            (lg, k2, v2), call = _mesh_call(b.fn, *args)
            calls.append(call)
    attention = {**_mesh_attention(rec, b.name, cfg.attn_chunk),
                 **_mesh_lse(blocks, b.name)}
    choices = _mesh_choices(routes, cfg, mesh) if slots > 1 else None
    del routes, rec, blocks
    donated = k2 is args[2] and v2 is args[3]
    lg, gk, gv = gather(lg), gather(k2), gather(v2)
    keep = torch.ones(LM_MESH_KEYS, dtype=torch.bool, device=dev)
    keep[n] = False
    unchanged = bool(torch.equal(gk[:, :, keep], ck[:, :, keep])
                     and torch.equal(gv[:, :, keep], cv[:, :, keep]))
    del args, k2, v2
    rk, rv = ck.clone(), cv.clone()
    del ck, cv

    def compare(res):
        want, _, _ = res
        return {"logits": _logit_dist(lg, want),
                "cache_rel_l2": [_rel_l2(gk[:, :, n], rk[:, :, n]),
                                 _rel_l2(gv[:, :, n], rv[:, :, n])]}

    out = {"bundle": b.name, "slots": slots, "keys": LM_MESH_KEYS,
           "cache_len": n, "cache_spec": list(b.out_shardings[1].spec),
           "donated_in_place": donated, "others_unchanged": unchanged,
           "sharded": calls[0], "sharded_ms": [c["ms"] for c in calls],
           "attention": attention,
           **_held_to_one_card(lambda: T.decode_step_inplace(
               params, token, rk, rv, n, cfg), compare, choices, b.name)}
    if not donated or not unchanged:
        raise AssertionError(f"lm_mesh {b.name}: the cache write is wrong: "
                             f"{out}")
    if calls[0]["flash_attention"] != launches \
            or len(attention) != launches:
        raise AssertionError(f"lm_mesh {b.name}: flash_attention launched "
                             f"{calls[0]['flash_attention']} times and "
                             f"{len(attention)} calls were checked, not "
                             f"{launches}")
    return out


def _check_lse(dev) -> dict:
    """flash_attention's log-sum-exp output (the split kernel's partials)
    and attention at the B = 1 sequence-sharded decode's block shape
    (gemma2: 16 heads over 8 KV heads of 256, a 2,048-key block, softcap
    50) against ``attention_lse_ref``; uncounted."""
    g = torch.Generator(device=dev).manual_seed(4)
    q = torch.randn((1, 16, 1, 256), generator=g, device=dev).bfloat16()
    k = torch.randn((1, 8, 2048, 256), generator=g, device=dev).bfloat16()
    v = torch.randn((1, 8, 2048, 256), generator=g, device=dev).bfloat16()
    n0 = fa.flash_attention.launches
    cases = []
    for window, q_offset in ((0, 2047), (0, 700), (4096, 2047), (1024, 1900)):
        kw = dict(causal=True, window=window, softcap=50.0,
                  q_offset=q_offset)
        out, lse = fa.flash_attention(q, k, v, lse=True, **kw)
        want, want_lse = attention_lse_ref(q, k, v, **kw)
        err = float((lse - want_lse).abs().max())
        torch.testing.assert_close(out, want, rtol=BF16_RTOL, atol=BF16_ATOL)
        if not err <= LSE_ATOL:
            raise AssertionError(f"lm_mesh: flash_attention's log-sum-exp is "
                                 f"{err} from the plain version's at {kw}")
        cases.append({**kw, "lse_max_abs_err": err,
                      "max_abs_err": float((out.float() - want.float())
                                           .abs().max())})
    fa.flash_attention.launches = n0
    return {"shape": [1, 16, 8, 1, 2048, 256], "cases": cases,
            "lse_atol": LSE_ATOL}


def _scheme_summary(res: dict) -> dict:
    """A model's baseline and opt train steps side by side: each entry's
    param and optimizer bytes, entry 0's wire bytes by op, the sharded
    (step two) and one-card ms, the peak while the sharded step ran."""
    out = {}
    for key in ("train", "train_opt"):
        r = res[key]
        out[r["scheme"]] = {
            "batch": r["batch"], "micro": r["micro"],
            "param_entry_bytes": r["param_entry_bytes"],
            "opt_entry_bytes": r["opt_entry_bytes"],
            "wire_bytes_entry0": {op: v[0] for op, v in
                                  r["sharded"]["wire_bytes"].items()},
            "sharded_ms": r["sharded"]["step2"]["ms"],
            "one_card_ms": r["one_card"]["ms"],
            "sharded_max_memory_allocated": r["sharded_max_memory_allocated"]}
    return out


def phase_lm_mesh(dev, card: str) -> dict:
    """The LM step bundles on a (data 2, model 2) mesh of four cuda:0
    entries (see LM_MESH_ARCHS' note): for each model a train step under
    the baseline and the ``opt`` scheme, a prefill and a decode, each held
    to the port's one-card step on the same params and inputs, with each
    entry's bytes, the card's peak, the sharded and one-card times, the
    wire bytes each entry sent by op (the collectives' counters) and
    flash_attention's launches in each call."""
    gc.collect()
    torch.cuda.empty_cache()
    mesh = make_mesh(LM_MESH_DIMS, ("data", "model"), devices=[dev] * 4)
    out = {"phase": "lm_mesh", "card": card, "mesh": mesh.shape,
           "entries": [str(d) for d in mesh.devices],
           "lse": _check_lse(dev), "models": {}}
    for arch_id in LM_MESH_ARCHS:
        arch = _mesh_arch(arch_id)
        cfg = train_steps._lm_cfg_for_mesh(arch, mesh)
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        t = time.perf_counter()
        params = T.init_params(cfg, generator=torch.Generator(device=dev)
                               .manual_seed(0), device=dev)
        res = {"config": {k: v for k, v in vars(cfg).items() if k != "moe"},
               "reduced": {"n_layers": [get_arch(arch_id).config.n_layers,
                                        cfg.n_layers],
                           "xent_chunk": [get_arch(arch_id).config.xent_chunk,
                                          cfg.xent_chunk],
                           "train_batch": [LM_SHAPES["train_4k"].global_batch,
                                           LM_MESH_BATCH],
                           "opt_train_batch": [
                               LM_SHAPES["train_4k"].global_batch,
                               LM_MESH_OPT_BATCH]},
               "param_count": cfg.param_count(),
               "params_grads_moments_bytes": trainer.lm_state_bytes(cfg),
               "memory_allocated_before": before}
        res["train"] = _mesh_train(arch, mesh, cfg, params, dev)
        gc.collect()
        torch.cuda.empty_cache()
        res["train_opt"] = _mesh_train(arch, mesh, cfg, params, dev, "opt")
        res["schemes"] = _scheme_summary(res)
        gc.collect()
        torch.cuda.empty_cache()
        res["prefill"] = _mesh_prefill(arch, mesh, cfg, params, dev)
        res["decode"] = _mesh_decode(arch, mesh, cfg, params, dev,
                                     LM_MESH_SLOTS)
        if arch_id == LM_ARCH:
            res["decode_b1"] = _mesh_decode(arch, mesh, cfg, params, dev, 1)
        res["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
        res["s"] = time.perf_counter() - t
        del params
        gc.collect()
        torch.cuda.empty_cache()
        out["models"][arch_id] = res
    calls = [m[k] for m in out["models"].values()
             for k in ("prefill", "decode", "decode_b1") if k in m]
    out["launches"] = {"flash_attention": sum(
        [m[k]["sharded"]["flash_attention"] for m in out["models"].values()
         for k in ("train", "train_opt")]
        + [c["sharded"]["flash_attention"] for c in calls])}
    checked = [r for m in out["models"].values()
               for c in [m["train"], m["train_opt"],
                         *[m[k] for k in ("prefill", "decode", "decode_b1")
                           if k in m]]
               for r in c["attention"].values()]
    out["attention"] = {"calls": len(checked), "max_abs_err": max(
        r["max_abs_err"] for r in checked)}
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phase model_mesh: the recsys and GNN step bundles on a mesh of one card
# ---------------------------------------------------------------------------

MM_DIMS, MM_HALO_DIMS = (2, 2), (4, 2)
# the two-tower cut: 2,097,152 rows a table (CONFIG's widths, f32). Under
# baseline the four entries hold 2 x 4.29 GB of table blocks (each block
# twice, over data) with their gradients and two moments, ~34.4 GB, beside
# the one-card step's 17.2 GB; phase train's 4,194,304 rows would need
# ~69 GB sharded alone
MM_ROWS = 2_097_152
MM_BATCH = 16_384           # phase train's batch: train_batch's 65,536
# would give (B, B) logits of 17.2 GB
MM_SCHEMES = ("baseline", "opt")
# sharded against one-card (f32, TF32 off): the bags are summed per row
# block and then across blocks in rank order, the losses over the data
# ranks, and the towers' GEMMs run on other row counts, so they differ by
# f32 rounding: losses, metrics and scores within 2e-6 (rtol or relative
# L2), params and moments within 2e-5 relative L2 a leaf on the same ReLU
# masks (the one-card step fed the sharded step's: a rounding apart flips
# a few near-zero pre-activations, and one flipped unit of one sample
# moved the first layers' gradients by 1.7e-3, run D1); one entry's block
# bags and block table gradient bit-equal to embedding_bag_ref /
# embedding_bag_backward_ref
MM_REL, MM_STATE_REL = 2e-6, 2e-5
MM_CHECK_ENTRY = 1          # (data 0, model 1): its ids shifted by a block


def _mm_rel(got, want) -> float:
    return _rel_l2(got.float(), want.float())


def _mm_wire(n: int) -> dict:
    return {op: [v.get(e, 0.0) for e in range(n)]
            for op, v in collectives.wire_bytes().items()}


def _mm_call(fn, *args, n: int = 4):
    """One bundle call: its result, ms (synchronised), the embedding_bag
    and embedding_bag_backward launches in it (counts set to 0 just
    before) and each entry's wire bytes by op."""
    collectives.reset_wire_bytes()
    eb.embedding_bag.launches = 0
    eb.embedding_bag_backward.launches = 0
    out, ms = _sync_ms(lambda: fn(*args))
    return out, {"ms": ms,
                 "launches": {"embedding_bag": eb.embedding_bag.launches,
                              "embedding_bag_backward":
                                  eb.embedding_bag_backward.launches},
                 "wire_bytes": _mm_wire(n)}


def _mm_expect_launches(call: dict, want: dict, what: str) -> None:
    if call["launches"] != want:
        raise AssertionError(f"model_mesh: {what} launched "
                             f"{call['launches']}, expected {want}")


def _mm_recsys_cfg():
    a = get_arch("two-tower-retrieval")
    cfg = dataclasses.replace(a.config, user_vocab=MM_ROWS,
                              item_vocab=MM_ROWS)
    return cfg, ArchDef(a.arch_id, "recsys", cfg, a.smoke_config, a.source)


def _mm_block_checks(fwd: _Hook, bwd: _Hook, rows: int) -> dict:
    """Entry MM_CHECK_ENTRY's first block bag (the user table's) against
    embedding_bag_ref on the card, and its block table gradient against
    the plain backward on the host, bit for bit."""
    (table, ids, _mode), _, bags, _ = fwd.kept[0]
    want = embedding_bag_ref(table, ids, mode="sum")
    if not _same_bits(bags, want):
        raise AssertionError(f"model_mesh: entry {MM_CHECK_ENTRY}'s block "
                             f"bags differ from embedding_bag_ref by "
                             f"{float((bags - want).abs().max())}")
    del want
    hits = [v for v in bwd.kept.values() if v[0][1].shape == ids.shape
            and torch.equal(v[0][1], ids)]
    if len(hits) != 1:
        raise AssertionError(f"model_mesh: {len(hits)} backward launches "
                             f"on entry {MM_CHECK_ENTRY}'s block ids")
    (g, idx, num_rows), kw, got, _ = hits[0]
    back = _check_backward(g, idx, num_rows, kw.get("mode", "sum"), got,
                           f"model_mesh entry {MM_CHECK_ENTRY}'s block")
    return {"entry": MM_CHECK_ENTRY, "bags": list(bags.shape),
            "bags_bit_equal": True,
            "ids_in_block": int((ids >= 0).sum()),
            "ids": int(ids.numel()), "backward": back}


class _ReluMasks:
    """Within it, ``torch.relu`` (the towers' activation) keeps each call's
    mask ``x > 0`` in ``masks``; with ``forced``, call i applies
    ``forced[i]`` instead (``where(mask, x, 0)``: a step fed another
    step's ReLU choices, as ``_ForcedRoutes`` feeds routes)."""

    def __init__(self, forced: list | None = None):
        self.forced, self.masks = forced, []

    def __enter__(self):
        self._fn = fn = torch.relu

        def relu(x):
            if self.forced is None:
                self.masks.append((x > 0).detach())
                return fn(x)
            m = self.forced[len(self.masks)]
            self.masks.append(m)
            return torch.where(m, x, 0.0)

        torch.relu = relu
        return self

    def __exit__(self, *exc):
        torch.relu = self._fn


def _one_card_masks(masks: list, cfg, mesh) -> list:
    """The sharded loss's ReLU masks (each entry's two towers, entry by
    entry) in the one-card loss's order: each layer's rows of the entries
    with model coordinate 0, concatenated in data-rank order."""
    n, acts = len(mesh.devices), len(cfg.tower_mlp) - 1
    lead = [e for e in range(n)
            if np.unravel_index(e, mesh.dims)[mesh.axis_names.index(
                "model")] == 0]
    out = []
    for t in range(2):                         # user, then item
        for layer in range(acts):
            out.append(torch.cat([masks[t * n * acts + e * acts + layer]
                                  for e in lead]))
    return out


def _state_dist(tree, want: dict) -> dict:
    out = {}
    for name in ("params", "mu", "nu"):
        got = tree[0] if name == "params" else tree[1][name]
        for (path, x), (_, y) in zip(tree_paths(got), tree_paths(want[name])):
            out[f"{name}/{'/'.join(path)}"] = _mm_rel(gather(x), y)
    return out


def _mm_train_scheme(arch, cfg, mesh, scheme, params, batch,
                     own: dict) -> dict:
    """One scheme's sharded train step: step one held to the one-card step
    fed its ReLU masks (params, moments, metrics) and its metrics to the
    one-card step's own (``own``), one entry's block bags and block
    gradient checked bit for bit; step two timed."""
    shape = RECSYS_SHAPES["train_batch"]
    b = train_steps.build_recsys(arch, dataclasses.replace(
        shape, batch=MM_BATCH), mesh, scheme)
    p, bt = place_tree((params, batch), (b.in_shardings[0],
                                         b.in_shardings[2]))
    o = tree_map(_zeros_placed, b.specs[1], b.in_shardings[1])
    res = {"param_bytes_per_entry": _entry_bytes(p),
           "opt_bytes_per_entry": _entry_bytes({k: o[k] for k in ("mu",
                                                                  "nu")})}
    rows = MM_ROWS // (mesh.shape["model"] if scheme == "baseline"
                       else len(mesh.devices))
    # the block is cloned before the call: the step updates it in place
    with _Hook(RSS, "bag_lookup", lambda i: 0 if i == MM_CHECK_ENTRY
               else None) as fwd, \
            _Hook(bag_ops, "embedding_bag_backward", lambda i: i,
                  clone=False) as bwd, _ReluMasks() as relu:
        (p, o, m), call = _mm_call(b.fn, p, o, bt)
    n = len(mesh.devices)
    _mm_expect_launches(call, {"embedding_bag": 2 * n,
                               "embedding_bag_backward": 2 * n},
                        f"the {scheme} train step")
    res["block"] = _mm_block_checks(fwd, bwd, rows)
    del fwd, bwd
    res["metrics"] = {k: float(gather(v)) for k, v in m.items()}
    # the same ReLU masks: the one-card step fed the sharded step's
    forced = _one_card_masks(relu.masks, cfg, mesh)
    del relu
    opt = train_steps.make_opt()
    step = train_steps.train_step(RS.loss_fn, cfg, opt)
    with _ReluMasks(forced) as fed:
        p1, s1, m1 = step(params, opt.init(params), batch)
    ref = {"params": p1, "mu": s1["mu"], "nu": s1["nu"]}
    res["relu_mask_flips"] = sum(int((a != b_).sum()) for a, b_ in zip(
        forced, own["masks"]))
    res["relu_mask_entries"] = sum(int(a.numel()) for a in forced)
    res["same_masks"] = {
        "metric_rel": {k: abs(res["metrics"][k] - float(v))
                       / max(abs(float(v)), 1e-30) for k, v in m1.items()},
        "state_rel": _state_dist((p, o), ref)}
    del fed, forced, p1, s1, m1, ref
    same = res["same_masks"]
    worst = max(same["state_rel"].values())
    same["state_rel_max"] = worst
    own_rel = {k: abs(res["metrics"][k] - own["metrics"][k])
               / max(abs(own["metrics"][k]), 1e-30) for k in own["metrics"]}
    res["own_masks"] = {"metric_rel": own_rel}
    if (max(same["metric_rel"].values()) > MM_REL or worst > MM_STATE_REL
            or own_rel["loss"] > MM_REL or own_rel["xent"] > MM_REL):
        raise AssertionError(f"model_mesh: {scheme} train step vs one card: "
                             f"{res}")
    res["step1"] = call
    (p, o, m), res["step2"] = _mm_call(b.fn, p, o, bt)
    res["loss_after_step2"] = float(gather(m["loss"]))
    del p, o, m, bt
    return res


def _mm_recsys_train(dev, mesh) -> dict:
    cfg, arch = _mm_recsys_cfg()
    params = RS.init_params(cfg, generator=torch.Generator(device=dev)
                            .manual_seed(0), device=dev)
    batch = trainer.batch_tensors(RS.make_batch(cfg, MM_BATCH, seed=0), dev)
    opt = train_steps.make_opt()
    step = train_steps.train_step(RS.loss_fn, cfg, opt)
    with _ReluMasks() as relu:
        (p1, s1, m1), one_ms = _sync_ms(lambda: step(params, opt.init(params),
                                                     batch))
    own = {"metrics": {k: float(v) for k, v in m1.items()},
           "masks": relu.masks}
    del relu
    out = {"batch": MM_BATCH, "rows": MM_ROWS,
           "one_card": {"step1_ms": one_ms, "metrics": own["metrics"]}}
    for scheme in MM_SCHEMES:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        out[scheme] = _mm_train_scheme(arch, cfg, mesh, scheme, params,
                                       batch, own)
        out[scheme]["max_memory_allocated"] = \
            torch.cuda.max_memory_allocated(dev)
    del own
    _, out["one_card"]["step2_ms"] = _sync_ms(lambda: step(p1, s1, batch))
    del p1, s1, params
    return out


def _mm_recsys_serve(dev, mesh) -> dict:
    """serve_p99, serve_bulk and retrieval_cand at their full batch under
    both schemes, each held to the one-card call."""
    cfg, arch = _mm_recsys_cfg()
    params = RS.init_params(cfg, generator=torch.Generator(device=dev)
                            .manual_seed(1), device=dev)
    n = len(mesh.devices)
    out = {}
    for scheme in MM_SCHEMES:
        placed = None
        res = {}
        for name in ("serve_p99", "serve_bulk", "retrieval_cand"):
            shape = RECSYS_SHAPES[name]
            b = train_steps.build_recsys(arch, shape, mesh, scheme)
            raw = RS.make_batch(cfg, shape.batch, seed=2)
            if shape.kind == "retrieval":
                g = torch.Generator(device=dev).manual_seed(3)
                batch = {"user_ids": torch.from_numpy(raw["user_ids"])
                         .to(dev),
                         "cand_item_emb": torch.randn(
                             (shape.n_candidates, cfg.tower_mlp[-1]),
                             generator=g, device=dev)}
                one = functools.partial(RS.score_candidates, params, batch,
                                        cfg)
                launches = n
            else:
                batch = {k: torch.from_numpy(raw[k]).to(dev)
                         for k in ("user_ids", "item_ids")}
                one = functools.partial(RS.serve_score, params, batch, cfg)
                launches = 2 * n
            if placed is None:
                placed = place_tree(params, b.in_shardings[0])
            pb = place_tree(batch, b.in_shardings[1])
            got, call = _mm_call(b.fn, placed, pb)
            _mm_expect_launches(call, {"embedding_bag": launches,
                                       "embedding_bag_backward": 0},
                                f"{scheme} {name}")
            want, one_ms = _sync_ms(one)
            rel = _mm_rel(gather(got), want)
            if rel > MM_REL:
                raise AssertionError(f"model_mesh: {scheme} {name} scores "
                                     f"{rel} from the one-card call's")
            _, again = _mm_call(b.fn, placed, pb)
            _, one_again = _sync_ms(one)
            res[name] = {"batch": shape.batch, "out_spec": list(
                b.out_shardings.spec), "rel_l2": rel, "first": call,
                "ms": again["ms"], "one_card_ms": one_again}
            del got, want, pb, batch
        res["param_bytes_per_entry"] = _entry_bytes(placed)
        del placed
        out[scheme] = res
    del params
    return out


def _mm_mesh_grads(b, ctx, loss, params, batch) -> tuple:
    """A bundle's mesh program's loss and gradients: those of the first
    entry's leaves (``copy_to`` makes them every copy's sum)."""
    shards = {k: list(v.shards) for k, v in
              place_tree(batch, b.in_shardings[2]).items()}
    rest = train_steps._entry_trees(place_tree(params, b.in_shardings[0]),
                                    ctx.n)[1:]
    return _loss_and_grads(lambda t, _b, _c: (
        loss([t] + rest, shards)[0][0], {}), params, None, None)


class _MeshWinners:
    """Within it, ``runtime.gnn_mesh.Graph.max`` (and so ``min``) keeps each
    call's winners over every entry's edges, in the global edge order:
    the mask ``_Winners(forced=...)`` feeds the one-card step."""

    def __init__(self):
        self.winners = []

    def __enter__(self):
        self._fn = fn = GM.Graph.max
        rec = self.winners

        def hooked(graph, data, seg_ids, fill):
            out = fn(graph, data, seg_ids, fill)
            top = torch.cat([o.detach() for o in out])
            rec.append(torch.cat([
                (s >= 0)[:, None] & (x.detach() == top[s.clamp(min=0).long()])
                for x, s in zip(data, seg_ids)]).to(HOST))
            return out

        GM.Graph.max = hooked
        return self

    def __exit__(self, *exc):
        GM.Graph.max = self._fn


def _mm_placed(b, params, batch) -> tuple:
    """A train bundle's three arguments: ``params`` and ``batch`` placed
    by its ``in_shardings``, the moments zero."""
    return (place_tree(params, b.in_shardings[0]),
            tree_map(_zeros_placed, b.specs[1], b.in_shardings[1]),
            place_tree(batch, b.in_shardings[2]))


def _mm_hold_step(got: tuple, want: tuple, what: str) -> dict:
    """A GNN bundle's first step ``(params, opt_state, metrics)`` against
    the one-card (or stacked) ``train_step``'s on the same inputs: every
    metric (loss, mse, gnorm) within phase gnn's loss limit GNN_LOSS_REL,
    every param, ``mu`` and ``nu`` leaf within MM_STATE_REL relative L2
    (``mu`` is the clipped gradient x 0.1), and all of them finite."""
    (p, o, m), (p1, s1, m1) = got, want
    metrics = {k: float(gather(v)) for k, v in m.items()}
    metric_rel = {k: abs(metrics[k] - float(v)) / max(abs(float(v)), 1e-30)
                  for k, v in m1.items()}
    state = _state_dist((p, o), {"params": p1, "mu": s1["mu"],
                                 "nu": s1["nu"]})
    worst = max(state, key=state.get)
    res = {"metrics": metrics, "metric_rel": metric_rel,
           "state_rel_max": state[worst], "state_rel_max_leaf": worst}
    if not (all(np.isfinite(list(metrics.values())))
            and all(np.isfinite(list(state.values())))
            and max(metric_rel.values()) <= GNN_LOSS_REL
            and state[worst] <= MM_STATE_REL):
        raise AssertionError(f"{what}: {res} (limits: metrics "
                             f"{GNN_LOSS_REL}, state {MM_STATE_REL})")
    return res


def _mm_gnn_arch(dev, mesh, arch_id: str, shape, batch_np) -> dict:
    """One arch's baseline bundle on the mesh: its ``fn`` on the placed
    params, zero moments and padded batch, the first step held to the
    one-card ``train_step`` on the same inputs (PNA's on the mesh's max /
    min winners), then a second bundle step timed beside a one-card step.
    NequIP's gradients are non-finite (ROADMAP C), so its bundle's loss
    and gradients are held instead, the same entries non-finite."""
    arch = get_arch(arch_id)
    cfg, mod = arch.config, train_steps._GNN_MODELS[arch_id]
    b = train_steps.build_gnn(arch, shape, mesh)
    specs = b.specs[2]
    batch = trainer.batch_tensors(GC.fit_batch(batch_np, specs), dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = mod.init_params(cfg, specs["node_feat"].shape[1],
                             generator=gen, device=dev) \
        if "node_feat" in specs and arch_id in ("meshgraphnet", "pna") \
        else mod.init_params(cfg, generator=gen, device=dev)
    ctx = GM.Ctx(mesh)
    res = {"shape": shape.name, "n_nodes": b.meta["n_nodes"],
           "n_edges": b.meta["n_edges"],
           "edges_in_batch": int((batch_np["senders"] >= 0).sum())}
    if arch_id == "nequip":
        split = "graph_id" in specs and tuple(
            b.in_shardings[2]["targets"].spec) != ()

        def loss(trees, shards):
            return GM.loss(ctx, mod, cfg, trees, shards, b.meta["n_nodes"],
                           split)

        collectives.reset_wire_bytes()
        got = _mm_mesh_grads(b, ctx, loss, params, batch)
        res["loss_and_grad_wire_bytes"] = _mm_wire(ctx.n)
        want = _loss_and_grads(mod.loss_fn, params, batch, cfg)
        res["first_step"] = _hold(got, want, "model_mesh: nequip mesh vs "
                                  "one card", nonfinite_ok=True)
        del params, batch, got, want
        return res
    opt = train_steps.make_opt()
    placed = _mm_placed(b, params, batch)
    with _MeshWinners() as mw:
        (p, o, m), res["step1"] = _mm_call(b.fn, *placed, n=ctx.n)
    step = train_steps.train_step(mod.loss_fn, cfg, opt)
    with _Winners(forced=mw.winners if mw.winners else None):
        (p1, s1, m1), res["one_card_step1_ms"] = _sync_ms(
            lambda: step(params, opt.init(params), batch))
    res["winner_calls"] = len(mw.winners)
    del mw
    res["first_step"] = _mm_hold_step((p, o, m), (p1, s1, m1),
                                      f"model_mesh: {arch_id} bundle vs "
                                      "one card")
    _, res["step2"] = _mm_call(b.fn, p, o, placed[2], n=ctx.n)
    _, res["one_card_step2_ms"] = _sync_ms(lambda: step(p1, s1, batch))
    del p, o, m, p1, s1, m1, placed, params, batch
    return res


def _mm_twitter_shape(g) -> object:
    return dataclasses.replace(GNN_SHAPES["ogb_products"], name="twitter",
                               n_nodes=g.n, n_edges=g.num_edges)


def _mm_gnn(dev, mesh, g) -> dict:
    """Every arch at its CONFIG on the four entries: MeshGraphNet at
    twitter's full graph, PNA at minibatch_lg's shape sampled from
    twitter, SchNet and NequIP at molecule."""
    out = {}
    full = GC.graph_to_batch(g, GNN_FEAT, seed=0, with_positions=True)
    out["meshgraphnet"] = _mm_gnn_arch(dev, mesh, "meshgraphnet",
                                       _mm_twitter_shape(g), full)
    del full
    gc.collect()
    torch.cuda.empty_cache()
    mb = next(dp.graph_minibatches(g, GNN_MB.d_feat, GNN_MB.batch_nodes,
                                   GNN_MB.fanout, seed=0))
    out["pna"] = _mm_gnn_arch(dev, mesh, "pna", GNN_MB, mb)
    mol = GC.batch_molecules(GNN_MOL.mol_batch, GNN_MOL.n_nodes,
                             GNN_MOL.n_edges, seed=0)
    for arch_id in ("schnet", "nequip"):
        out[arch_id] = _mm_gnn_arch(dev, mesh, arch_id, GNN_MOL, mol)
    return out


def _mm_forward_wire(loss, trees, shards, n: int, layers: int) -> dict:
    """The wire bytes each entry sends in one forward (no autograd), by
    op, and per layer (all of it over the layers)."""
    collectives.reset_wire_bytes()
    with torch.no_grad():
        loss(trees, shards)
    torch.cuda.synchronize()
    wire = _mm_wire(n)
    return {"forward": wire, "per_layer_entry0": {
        op: v[0] / layers for op, v in wire.items()}}


def _mm_halo(dev, g, specs: dict) -> dict:
    """MeshGraphNet over the SDP and hash sessions' blocked layouts of
    twitter, one block a mesh entry of a (data 4, model 2) mesh of eight
    cuda:0 entries (``build_gnn_halo(layout=...)``: the layout's own block,
    publish, halo and edge sizes): the bundle's ``fn`` on the placed
    params, zero moments and the layout's batch, its first step held to
    the stacked one-device path's ``train_step`` on the same inputs, a
    second step timed beside a stacked step; each exchange's wire bytes a
    layer an entry beside the graph-parallel baseline's on the same
    entries."""
    arch = get_arch("meshgraphnet")
    cfg = arch.config
    mesh = make_mesh(MM_HALO_DIMS, ("data", "model"), devices=[dev] * 8)
    ctx = GM.Ctx(mesh)
    shape = _mm_twitter_shape(g)
    full = GC.graph_to_batch(g, GNN_FEAT, seed=0, with_positions=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = MGN.init_params(cfg, GNN_FEAT, generator=gen, device=dev)
    opt = train_steps.make_opt()
    out = {"mesh": mesh.shape, "entries": len(mesh.devices)}
    for policy in ("sdp", "hash"):
        spec = specs[policy]
        b = train_steps.build_gnn_halo(arch, shape, mesh, layout=spec)
        stacked_np = halo_batch(spec, full["node_feat"], full["targets"])
        batch = trainer.batch_tensors(
            GC.fit_batch(stacked_np, b.specs[2], axis=1), dev)
        nb = spec.block_size
        placed = _mm_placed(b, params, batch)
        (p, o, m), step1 = _mm_call(b.fn, *placed, n=ctx.n)
        stacked = trainer.batch_tensors(stacked_np, dev)
        step = train_steps.train_step(make_mgn_halo_loss(cfg, nb), cfg, opt)
        (p1, s1, m1), stacked1_ms = _sync_ms(
            lambda: step(params, opt.init(params), stacked))
        res = {"block_rows_Nb": nb, "B_max": spec.publish_size,
               "published_rows": int((spec.publish_idx >= 0).sum()),
               "bundle_b_max": b.meta["b_max"],
               "halo_frac": b.meta["halo_frac"],
               "first_step": _mm_hold_step(
                   (p, o, m), (p1, s1, m1),
                   f"model_mesh: halo {policy} bundle vs stacked"),
               "step1": step1, "stacked_step1_ms": stacked1_ms}

        def loss(trees, shards, nb=nb):
            return GH.mgn_halo_mesh_loss(ctx, cfg, trees, shards, nb)

        shards = {k: list(v.shards) for k, v in placed[2].items()}
        res["exchange"] = _mm_forward_wire(
            loss, train_steps._entry_trees(p, ctx.n), shards, ctx.n,
            cfg.n_layers)
        _, res["step2"] = _mm_call(b.fn, p, o, placed[2], n=ctx.n)
        _, res["stacked_step2_ms"] = _sync_ms(lambda: step(p1, s1, stacked))
        out[policy] = res
        del p, o, m, p1, s1, m1, placed, batch, stacked, shards
    b = train_steps.build_gnn(arch, shape, mesh)
    batch = trainer.batch_tensors(GC.fit_batch(full, b.specs[2]), dev)
    shards = {k: list(v.shards) for k, v in
              place_tree(batch, b.in_shardings[2]).items()}
    trees = train_steps._entry_trees(place_tree(params, b.in_shardings[0]),
                                     ctx.n)
    out["graph_parallel"] = _mm_forward_wire(
        lambda t, s: GM.loss(ctx, MGN, cfg, t, s, b.meta["n_nodes"]),
        trees, shards, ctx.n, cfg.n_layers)
    del batch, shards, trees, params
    return out


def phase_model_mesh(dev, g, specs: dict, card: str) -> dict:
    """The recsys and GNN step bundles on meshes of ``cuda:0`` entries: the
    two-tower train step (baseline and opt) and its serving cells on a
    (data 2, model 2) mesh, every GNN arch's baseline bundle on the same
    four entries, and MeshGraphNet's halo bundle over SDP's and hash's 8
    blocks of twitter, one an entry of a (data 4, model 2) mesh; each held
    to the port's one-card (or stacked) step, with embedding_bag's
    launches checked exactly and each entry's wire bytes by op."""
    gc.collect()
    torch.cuda.empty_cache()
    mesh = make_mesh(MM_DIMS, ("data", "model"), devices=[dev] * 4)
    out = {"phase": "model_mesh", "card": card, "mesh": mesh.shape,
           "entries": [str(d) for d in mesh.devices],
           "reduced": {"rows": [RS.TwoTowerConfig().user_vocab, MM_ROWS],
                       "train_batch": [RECSYS_SHAPES["train_batch"].batch,
                                       MM_BATCH],
                       "graph": ["ogb_products", "twitter (cap 192)"]},
           "part_s": {}}
    for name, part in (("recsys_train", lambda: _mm_recsys_train(dev, mesh)),
                       ("recsys_serve", lambda: _mm_recsys_serve(dev, mesh)),
                       ("gnn", lambda: _mm_gnn(dev, mesh, g)),
                       ("halo", lambda: _mm_halo(dev, g, specs))):
        t = time.perf_counter()
        out[name] = part()
        out["part_s"][name] = time.perf_counter() - t
        gc.collect()
        torch.cuda.empty_cache()
    tr, sv = out["recsys_train"], out["recsys_serve"]
    out["launches"] = {
        "embedding_bag": sum(tr[s][k]["launches"]["embedding_bag"]
                             for s in MM_SCHEMES for k in ("step1", "step2"))
        + sum(sv[s][c]["first"]["launches"]["embedding_bag"]
              for s in MM_SCHEMES for c in ("serve_p99", "serve_bulk",
                                            "retrieval_cand")),
        "embedding_bag_backward": sum(
            tr[s][k]["launches"]["embedding_bag_backward"]
            for s in MM_SCHEMES for k in ("step1", "step2"))}
    emit(out)
    return out


def _mm_bag_row(model_mesh: dict, name: str) -> dict:
    """A bag kernel's launches in phase model_mesh, by call, with the
    block checks of its train steps."""
    tr, sv = model_mesh["recsys_train"], model_mesh["recsys_serve"]
    by_call = {f"{s}:train_{k}": tr[s][k]["launches"][name]
               for s in MM_SCHEMES for k in ("step1", "step2")}
    if name == "embedding_bag":
        by_call.update({f"{s}:{c}": sv[s][c]["first"]["launches"][name]
                        for s in MM_SCHEMES
                        for c in ("serve_p99", "serve_bulk",
                                  "retrieval_cand")})
    return {"launches": model_mesh["launches"][name], "by_call": by_call,
            "block_bit_equal": {s: tr[s]["block"]["bags_bit_equal"]
                                if name == "embedding_bag" else
                                tr[s]["block"]["backward"]["bit_equal_to_host"]
                                for s in MM_SCHEMES}}


def _shard_launches(shard: dict, name: str) -> dict:
    """A kernel's launches in each sharded run of phase shard."""
    runs = {**shard["twitter"], "grqc": shard["grqc"]}
    return {k: r["launches"][name] for k, r in runs.items()
            if "launches" in r}


def _backward_row(train: dict) -> dict:
    """The backward kernel's row: launches on the training steps (each
    the order and the pass), timed as a whole function at the first
    step's user-table bags (the item table's beside them), with the
    order and the pass apart."""
    bk = train["kernel"]
    checks = train["cases"] + [train["first_step"][t] for t in ("user", "item")]
    return {"name": "embedding_bag_backward", "route": "cuda",
            "source": "src/repro_torch/csrc/embedding_bag.cu",
            "replaces": "src/repro/kernels/embedding_bag/ops.py:24",
            "form": "no Pallas counterpart: the XLA scatter of bag_lookup's "
                    "custom_vjp backward (_bwd)",
            "launches": train["launches"]["embedding_bag_backward"],
            "max_abs_err": max(c["max_abs_err"] for c in checks),
            "cases": len(checks),
            "mismatches": sum(c["max_abs_err"] != 0 for c in checks),
            **{k: bk["user"][k] for k in (
                "shape", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "library", "order_ms", "pass_ms",
                "pass_bound_ms", "fill_ms", "function_ms",
                "function_eager_ms", "function_bound_ms", "touched_rows",
                "gb_per_s")},
            "item": {k: bk["item"][k] for k in (
                "shape", "ms", "plain_ms", "bound_ms", "library_ms",
                "order_ms", "pass_ms", "pass_bound_ms", "fill_ms",
                "function_ms", "function_eager_ms", "function_bound_ms")}}


def kernel_line(kernels: dict, twitter: dict, recsys: dict, spmm: dict,
                lm: dict, rebalance: dict, serve: dict, sweep: dict,
                shard: dict, train: dict, moe_run: dict,
                lm_train: dict, lm_mesh: dict, model_mesh: dict) -> dict:
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
             "partition_affinity"], **rebalance["partition_affinity"]},
         "serve": {"launches": serve["launches"]["partition_affinity"]}},
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
         "serve": {"launches": serve["launches"]["fused_chooser"]},
         "shard": _shard_launches(shard, "fused_chooser"),
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
         "train": {"launches": train["launches"]["embedding_bag"]},
         # the two-tower bundles' row-block bags on four cuda:0 entries
         # (sum mode on each block, counted exactly a call)
         "model_mesh": _mm_bag_row(model_mesh, "embedding_bag"),
         "all_slot_bound_ms": eb_p99["all_slot_bound_ms"],
         "all_slot_gb_per_s": eb_p99["all_slot_gb_per_s"],
         "requests_in_turn": eb_p99["requests"],
         "serve_bulk": {"shape": [eb_bulk["bags"], eb_bulk["slots"],
                                  eb_bulk["dim"]],
                        **{k: eb_bulk[k] for k in timed + (
                            "all_slot_bound_ms", "all_slot_gb_per_s")}}},
    ]
    rows.append(_backward_row(train))
    rows[-1]["model_mesh"] = _mm_bag_row(model_mesh,
                                         "embedding_bag_backward")
    # the sweep form: its launches on the twitter lanes' sweep (the grqc
    # lanes' beside them); ms, plain ms and bound at one lane of twitter's
    # shape, and 1, 16 (the twitter sweep's launch) and 64 lanes on both
    # shapes
    sf = sweep["sweep_form"]
    sf_main = next(r for r in sf["twitter_shape"]["lanes"] if r["lanes"] == 1)
    rows.append(
        {"name": "fused_chooser_sweep", "route": "cuda",
         "source": "src/repro_torch/csrc/fused_chooser.cu",
         "replaces": "src/repro/kernels/fused_chooser/fused_chooser.py:245",
         "form": "traced policy, lanes on grid.x (policy=None)",
         "launches": sweep["twitter"]["launches"]["fused_chooser_sweep"],
         "launches_by_kernel": sweep["twitter"]["launches_by_kernel"],
         "grqc_launches": sweep["grqc"]["launches"]["fused_chooser_sweep"],
         "k200_launches_by_kernel": sweep["k200"]["launches_by_kernel"],
         "max_abs_err": max(
             [sf_main["max_abs_err"]]
             + [sweep[c]["plain"]["max_abs_err"]
                for c in ("grqc", "twitter", "k200")]),
         "plain_checks": {c: {k: sweep[c]["plain"][k] for k in (
             "window_step", "lanes", "lanes_checked")}
             for c in ("grqc", "twitter", "k200")},
         "shape": sf_main["shape"],
         "ms": sf_main["ms"], "plain_ms": sf_main["plain_ms"],
         "bound_ms": sf_main["bound_ms"], "bound_by": sf_main["bound_by"],
         "library_ms": None,
         **{label: {"single_sdp_ms": sf[label]["single_sdp_ms"],
                    **{f"L{r['lanes']}": {k: r[k] for k in (
                        "shape", "ms", "bound_ms", "max_abs_err_vs_single")}
                       for r in sf[label]["lanes"]}}
            for label in ("twitter_shape", "grqc_shape")}})
    timed_scan = timed + ("eager_ms", "plain_eager_ms", "bound_by", "kernel",
                          "large_ms")
    for name, source, replaces, main, others in (
            ("window_prep", "src/repro_torch/csrc/window_prep.cu",
             "src/repro/kernels/fused_chooser/ops.py:113",
             ("session", "stream"), (("grqc_wide", "stream"),
                                     ("odd", "stream"))),
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
             "serve": {"launches": serve["launches"][name]},
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
    # window_rng: launched once a twitter session (one draw for the feed's
    # windows), timed at that draw's shape; a table of one window and a
    # sweep step's 16 and 64 tables in one launch beside it (phase kernels)
    rng_cases = kernels["window_rng"]["cases"]
    rng_main = twitter["window_rng"]
    rng_one = next(c for c in rng_cases if "ms" in c)
    rows.insert(-1, {
        "name": "window_rng", "route": "cuda",
        "source": "src/repro_torch/csrc/window_rng.cu",
        "replaces": "src/repro/core/transition.py:374",
        "form": "no Pallas counterpart: rand_index_table and the fold_in "
                "of src/repro/core/windowed.py:140; (L, w, K) tables a "
                "launch",
        "launches": twitter["launches"]["window_rng"],
        "serve": {"launches": serve["launches"]["window_rng"],
                  "draws_held": serve["window_rng_draws"]},
        "shard": _shard_launches(shard, "window_rng"),
        "sweep": {c: {"launches": sweep[c]["launches"]["window_rng"],
                      "window_steps": sweep[c]["windows"],
                      "lanes": sweep[c]["lanes"]}
                  for c in ("grqc", "twitter")},
        "max_abs_err": max([c["max_abs_err"] for c in rng_cases]
                           + [r["max_abs_err"]
                              for r in kernels["window_rng"]["tables"]]),
        "cases": len(rng_cases) + len(kernels["window_rng"]["tables"]),
        "mismatches": sum(c["max_abs_err"] != 0 for c in rng_cases),
        "shape": rng_main["shape"], "ms": rng_main["ms"],
        "eager_ms": rng_main["eager_ms"], "plain_ms": rng_main["plain_ms"],
        "bound_ms": rng_main["bound_ms"], "bound_by": rng_main["bound_by"],
        "library_ms": None,
        "one_window": {k: rng_one[k] for k in (
            "shape", "ms", "eager_ms", "plain_ms", "plain_eager_ms",
            "bound_ms", "bound_by")},
        "tables": {f"L{r['tables']}": {k: r[k] for k in (
            "shape", "ms", "ms_per_table", "eager_ms", "bound_ms",
            "bound_by")} for r in kernels["window_rng"]["tables"]}})
    # the row-block form: launches on twitter's P = 4 run (the other runs'
    # beside them), timed at block 0 of four at twitter's shape
    rk = shard["rows_kernel"]
    runs = {**shard["twitter"], "grqc": shard["grqc"]}
    rows.append(
        {"name": "window_prep_rows", "route": "cuda",
         "source": "src/repro_torch/csrc/window_prep.cu",
         "replaces": "src/repro/runtime/shard_session.py:113",
         "form": "row-block form of window_prep (round 1 of the "
                 "vertex-sharded window)",
         "launches": shard["twitter"]["P4"]["launches"]["window_prep_rows"],
         "shard": _shard_launches(shard, "window_prep_rows"),
         "max_abs_err": max([rk["max_abs_err"]] + [
             r["plain_check"]["max_abs_err"] for r in runs.values()
             if "plain_check" in r]),
         "plain_checks": {k: r["plain_check"] for k, r in runs.items()
                          if "plain_check" in r},
         "shape": rk["shape"], "ms": rk["ms"], "eager_ms": rk["eager_ms"],
         "plain_ms": rk["plain_ms"], "bound_ms": rk["bound_ms"],
         "bound_by": rk["bound_by"], "library_ms": None})
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
         # moonshot (no softcap, every layer global): its launches on the
         # moe path and in the training steps, its prefill call at (1, 16,
         # 8192, 128) bf16 causal beside F.scaled_dot_product_attention
         "moe": {"launches": moe_run["launches"]["flash_attention"],
                 "launches_by_kernel": moe_run["launches_by_kernel"],
                 **{kind: {k: moe_run["kernel"][kind]["layer0"][k]
                           for k in timed + ("bound_by", "kernel", "n_split",
                                             "q", "kv", "flops",
                                             "tflop_per_s", "gb_per_s",
                                             "library")
                           if k in moe_run["kernel"][kind]["layer0"]}
                    for kind in ("prefill", "decode")}},
         "lm_train": {"launches": lm_train["launches"]["flash_attention"],
                      "per_step": lm_train["launches_per_step"][
                          "flash_attention"]},
         # the sharded bundles on the (data 2, model 2) mesh: each call's
         # launches (a train step's include its checkpointed layers'
         # recompute), and the kernel held to the plain version at the
         # q/k/v of every call of a train step's forward (baseline and
         # opt), a prefill and each decode
         "lm_mesh": {"launches": lm_mesh["launches"]["flash_attention"],
                     "checked_calls": lm_mesh["attention"]["calls"],
                     "max_abs_err": lm_mesh["attention"]["max_abs_err"],
                     "by_call": {
                         f"{arch}:{kind}": m[kind]["sharded"][
                             "flash_attention"]
                         for arch, m in lm_mesh["models"].items()
                         for kind in ("train", "train_opt", "prefill",
                                      "decode", "decode_b1") if kind in m}},
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


def _build_in_thread(failed: list) -> None:
    """``phase_build`` in a thread; its exception kept in ``failed``."""
    try:
        phase_build()
    except BaseException as e:   # re-raised by the main thread
        failed.append(e)


def main() -> int:
    if os.path.exists(LOG):
        os.remove(LOG)
    info = phase_device()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the nvcc processes run while the host makes the graphs and the window
    # kernels' setups (the plain window engines: no kernel is loaded)
    failed = []
    build = threading.Thread(target=_build_in_thread, args=(failed,))
    build.start()
    graphs = spmm_graphs(dev)
    t = time.perf_counter()
    cases = _window_cases(dev)
    emit({"phase": "window_setups", "s": time.perf_counter() - t})
    build.join()
    if failed:
        raise failed[0]
    # host references run in worker processes beside the card: phase
    # grqc's two engines (~100 s on the host) and phase kernels' window
    # choosers, all done before phase kernels times anything
    refs = _HostRefs()
    try:
        grqc_refs = grqc_host_refs(refs)
        kernels = phase_kernels(dev, graphs, cases, refs)
        spmm = phase_spmm(dev, graphs)
        del graphs
        _, grqc_s, grqc_cfg, grqc_host = phase_grqc(dev, grqc_refs)
    finally:
        refs.close(cancel=True)
    phase_fig12(dev)
    phase_mesh(dev)
    twitter, twitter_part, twitter_g, twitter_s = phase_twitter(dev)
    # phase shard holds its sessions to this final state, which the
    # rebalance changes
    twitter_host = to_host(twitter_part.state)
    rebalance = phase_rebalance(dev, twitter_part)
    del twitter_part
    phase_lifecycle(dev, twitter_g, twitter_s)
    serve = phase_serve(dev, twitter_s, info["nvidia_smi"])
    sweep = phase_sweep(dev, twitter_s, cases, info["nvidia_smi"])
    shard = phase_shard(dev, twitter_s, twitter_host, grqc_s, grqc_cfg,
                        grqc_host, info["nvidia_smi"])
    _, gnn_specs = phase_gnn(dev, twitter_g, info["nvidia_smi"])
    del twitter_s, cases, twitter_host, grqc_host
    model_mesh = phase_model_mesh(dev, twitter_g, gnn_specs,
                                  info["nvidia_smi"])
    del twitter_g, gnn_specs
    recsys = phase_recsys(dev)
    train = phase_train(dev, info["nvidia_smi"])
    lm = phase_lm(dev)
    moe_run = phase_moe(dev, info["nvidia_smi"])
    lm_train = phase_lm_train_process(info["nvidia_smi"])
    lm_mesh = phase_lm_mesh(dev, info["nvidia_smi"])
    emit(kernel_line(kernels, twitter, recsys, spmm, lm, rebalance, serve,
                     sweep, shard, train, moe_run, lm_train, lm_mesh,
                     model_mesh))
    print(info["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1:         # phase_lm_train_process's child
        p = argparse.ArgumentParser()
        p.add_argument("--phase", choices=("lm_train",), required=True)
        p.add_argument("--card", required=True)
        p.add_argument("--t0", type=float, required=True)
        child = p.parse_args()
        _T0 = child.t0            # the parent's start: one clock for t_s
        sys.exit(lm_train_main(child.card))
    sys.exit(main())
