"""Timing sweep of ``csrc/segment_spmm.cu``'s launch constants on the card.

    PYTHONPATH=src python -m repro_torch.kernels.segment_spmm.sweep

Builds the source as it stands and one variant per entry of ``VARIANTS``
(the source with those constants replaced), one ``nvcc`` each, all started
together; checks each variant bit-equal to the built kernel on twitter's
ELL (scale 1.0, degree cap 192, as the streaming session holds it); and
prints the card's name and power limit, then one JSON line: each build's
device time per call (f32 sum, CUDA-graph replay) at F = 128 and 1433, and
the built kernel's once more after the variants, the spread of the timing.
A development tool: nothing in the package runs it. Needs one CUDA card.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys

import numpy as np
import torch

from repro_torch.graph.csr import cap_degree
from repro_torch.graph.datasets import load_dataset
from repro_torch.kernels import common
from repro_torch.kernels.segment_spmm.segment_spmm import segment_spmm

WIDTHS = (128, 1433)
DEGREE_CAP = 192
VARIANTS = {"slab_1024B": {"kSlabBytes": 1024},
            "unroll_1": {"kUnroll": 1}, "unroll_4": {"kUnroll": 4},
            "warps_8": {"kWarps": 8}}


def twitter_ell(dev) -> torch.Tensor:
    """Twitter at scale 1.0, degree-capped, as an (n, cap) int32 ELL."""
    g = cap_degree(load_dataset("twitter", scale=1.0), DEGREE_CAP)
    deg = np.diff(g.indptr)
    ell = np.full((g.n, DEGREE_CAP), -1, np.int32)
    rows = np.repeat(np.arange(g.n), deg)
    ell[rows, np.arange(g.indptr[-1]) - np.repeat(g.indptr[:-1], deg)] = \
        g.indices
    return torch.from_numpy(ell).to(dev)


def build_variants() -> dict:
    """{name: launch function} of every VARIANTS build, compiled in
    parallel into ``build/repro_torch/sweep/``."""
    src = (common.CSRC / "segment_spmm.cu").read_text()
    out = common.BUILD_DIR / "sweep"
    out.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name, consts in VARIANTS.items():
        text = src
        for const, val in consts.items():
            text, n = re.subn(rf"constexpr int {const} = \d+;",
                              f"constexpr int {const} = {val};", text)
            if n != 1:
                raise ValueError(f"segment_spmm.cu has no {const}")
        cu = out / f"segment_spmm_{name}.cu"
        cu.write_text(text)
        lib = out / f"libsegment_spmm_{name}.so"
        jobs.append((name, lib, subprocess.Popen(
            [common._nvcc(), *common.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    common.build_kernels(["segment_spmm"])
    fns = {}
    for name, lib, proc in jobs:
        log = proc.communicate()[0].decode()
        if proc.returncode:
            raise RuntimeError(f"segment_spmm {name} failed:\n{log[-3000:]}")
        fn = ctypes.CDLL(str(lib)).segment_spmm_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        fns[name] = fn
    return fns


def graph_ms(fn, reps: int = 20, replays: int = 3) -> float:
    """Device time per call of ``fn``: ``reps`` calls captured in one CUDA
    graph, replayed ``replays`` times between two CUDA events."""
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
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (reps * replays)


def sweep(fns: dict, adj: torch.Tensor, f: int) -> dict:
    """{build: ms} at F = ``f``: the built kernel, each variant (after a
    bit-equality check against the built kernel), the built kernel again."""
    n, dmax = adj.shape
    dev = adj.device
    x = torch.randn((n, f), generator=torch.Generator(device=dev)
                    .manual_seed(f + 1), device=dev)
    want = segment_spmm(x, adj)
    packed = torch.empty((n, dmax), dtype=torch.int32, device=dev)
    count = torch.empty((n,), dtype=torch.int32, device=dev)
    out = torch.empty((n, f), dtype=torch.float32, device=dev)
    for _ in range(50):                # the card at its clocks, not idle
        segment_spmm(x, adj)
    times = {"built": graph_ms(lambda: segment_spmm(x, adj))}
    for name, fn in fns.items():
        def run(fn=fn, name=name):
            common.check_launch(fn(
                x.data_ptr(), adj.data_ptr(), packed.data_ptr(),
                count.data_ptr(), out.data_ptr(), n, f, dmax, 0, 0,
                common.stream_ptr(dev)), name)

        run()
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise AssertionError(f"segment_spmm {name} differs from the "
                                 "built kernel")
        times[name] = graph_ms(run)
    times["built_again"] = graph_ms(lambda: segment_spmm(x, adj))
    return times


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("the sweep needs a CUDA card")
    dev = torch.device("cuda", 0)
    fns = build_variants()
    adj = twitter_ell(dev)
    result = {"graph": "twitter", "shape": list(adj.shape),
              "valid_slots": int((adj >= 0).sum()), "variants": VARIANTS,
              "ms": {f"F{f}": sweep(fns, adj, f) for f in WIDTHS}}
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
