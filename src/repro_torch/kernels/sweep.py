"""What the launch-constant sweeps of the port's kernels share
(``python -m repro_torch.kernels.<kernel>.sweep``): building a source with
some of its ``constexpr int`` constants replaced, timing a call on the card
and naming the card. Development tools: nothing in the package runs them.
"""
from __future__ import annotations

import ctypes
import re
import subprocess

import torch

from repro_torch.kernels import common


def build_variants(name: str, variants: dict, argtypes: list,
                   entry: str | None = None) -> dict:
    """{variant: launch function} of ``csrc/<name>.cu`` built once per entry
    of ``variants`` ({variant: {constant: value}}), one ``nvcc`` each, all
    started together, into ``build/repro_torch/sweep/``; the source as it
    stands is built too (``common.build_kernels``). ``entry`` is the C
    function to bind (``<name>_launch`` by default)."""
    src = (common.CSRC / f"{name}.cu").read_text()
    out = common.BUILD_DIR / "sweep"
    out.mkdir(parents=True, exist_ok=True)
    jobs = []
    for variant, consts in variants.items():
        text = src
        for const, val in consts.items():
            text, n = re.subn(rf"constexpr int {const} = -?\d+;",
                              f"constexpr int {const} = {val};", text)
            if n != 1:
                raise ValueError(f"{name}.cu has no constant {const}")
        cu = out / f"{name}_{variant}.cu"
        cu.write_text(text)
        lib = out / f"lib{name}_{variant}.so"
        jobs.append((variant, lib, subprocess.Popen(
            [common._nvcc(), *common.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    common.build_kernels([name])
    fns = {}
    for variant, lib, proc in jobs:
        log = proc.communicate()[0].decode()
        if proc.returncode:
            raise RuntimeError(f"{name} {variant} failed:\n{log[-3000:]}")
        fn = getattr(ctypes.CDLL(str(lib)), entry or f"{name}_launch")
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[variant] = fn
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


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
