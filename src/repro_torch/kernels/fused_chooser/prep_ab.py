"""Alternating timing of the dense ``window_prep`` kernel built from other
sources against the source as it stands, on one card.

    PYTHONPATH=src python -m repro_torch.kernels.fused_chooser.prep_ab \\
        OTHER.cu [OTHER.cu ...] [--rounds 10]

Each ``OTHER.cu`` is a version of ``csrc/window_prep.cu`` — another
commit's (unpacked with ``git archive``) or an edited copy — whose
``window_prep_launch`` takes the same arguments. Each is built into
``build/repro_torch/sweep/``, one ``nvcc`` each, all started together. On
the windows of two setups of ``sweep.WINDOW_SETUPS`` — ``session``, the
twitter session's (256, 192), and ``grqc_wide``, grqc's 2,843-wide rows —
every build's outputs (scalar rows, both tables, label0, last_touch and
the adjacency after the window) are first held bit-equal to the current
build's. Then the builds are timed in rounds whose order alternates
(the current build first, then the others; the next round in reverse),
each a CUDA-graph replay of 20 calls on a fresh copy of the state. Prints
the card's name and power limit, then one JSON line: each build's times
per round and their median at each setup, and ptxas's register and spill
report for ``window_prep_kernel``. A development tool: nothing in the
package runs it. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import common
from repro_torch.kernels.fused_chooser import sweep as fsweep
from repro_torch.kernels.fused_chooser.fused_chooser import EV_COLS
from repro_torch.kernels.sweep import card, graph_ms

SETUPS = ("session", "grqc_wide")
ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_I32 = torch.int32


def _bind(path: Path):
    fn = ctypes.CDLL(str(path)).window_prep_launch
    fn.argtypes = ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def ptxas_report(log: str, kernel: str = "window_prep_kernel") -> list:
    """ptxas' lines (registers, stack frame, spills) for ``kernel`` from a
    ``-Xptxas -v`` log: those between its "Compiling entry function" line
    and the next entry's."""
    out, inside = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            inside = kernel in line
        elif inside:
            out.append(line.strip())
    return out


def build(paths) -> dict:
    """{label: (launch function, ptxas report)}: ``current`` (the source
    as it stands) and each of ``paths``, labelled by file name."""
    out = common.BUILD_DIR / "sweep"
    out.mkdir(parents=True, exist_ok=True)
    jobs = []
    for i, path in enumerate(paths):
        lib = out / f"libwindow_prep_ab{i}.so"
        jobs.append((Path(path).stem, lib, subprocess.Popen(
            [common._nvcc(), *common.NVCC_FLAGS, "-o", str(lib), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    lib = common.build_kernels(["window_prep"])["window_prep"]
    libs = {"current": (_bind(lib), ptxas_report(
        lib.with_suffix(".log").read_text()))}
    for label, lib, proc in jobs:
        log = proc.communicate()[0].decode()
        if proc.returncode:
            raise RuntimeError(f"window_prep {label} failed:\n{log[-3000:]}")
        if label in libs:
            raise ValueError(f"two sources are named {label}")
        libs[label] = (_bind(lib), ptxas_report(log))
    return libs


def call(fn, state, ets, vs, rows) -> tuple:
    """One launch of a build's dense kernel (the wrapper's, uncounted):
    (ev, src_lbl, touch, label0, last_touch); ``state.adj`` is updated in
    place."""
    w, d = rows.shape
    n = state.assignment.shape[0]
    dev = vs.device
    outs = (torch.empty((w, EV_COLS), dtype=_I32, device=dev),
            torch.empty((w, d), dtype=_I32, device=dev),
            torch.empty((w, d), dtype=_I32, device=dev),
            torch.empty((n,), dtype=_I32, device=dev),
            torch.empty((n,), dtype=_I32, device=dev))
    ev, src_lbl, touch, label0, last_touch = outs
    err = fn(ets.data_ptr(), vs.data_ptr(), rows.data_ptr(),
             state.assignment.data_ptr(), state.present.data_ptr(),
             state.adj.data_ptr(), label0.data_ptr(), last_touch.data_ptr(),
             ev.data_ptr(), src_lbl.data_ptr(), touch.data_ptr(), w, d, n,
             common.stream_ptr(dev))
    common.check_launch(err, "window_prep")
    return outs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sources", nargs="+", help="other window_prep.cu files")
    ap.add_argument("--rounds", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("the comparison needs a CUDA card")
    dev = torch.device("cuda", 0)
    libs = build(args.sources)
    labels = list(libs)
    result = {"ptxas": {k: v[1] for k, v in libs.items()}, "setups": {}}
    for setup in SETUPS:
        spec = fsweep.WINDOW_SETUPS[setup]
        state, _, (et, vx, nb) = fsweep.window_state(dev, *spec,
                                                     fsweep.CHURN)
        w, warm = spec[6:]
        sl = slice(warm, warm + w)
        ets, vs, rows = et[sl], vx[sl], nb[sl]
        want_state = fsweep.clone_state(state)
        want = call(libs["current"][0], want_state, ets, vs, rows)
        for label in labels[1:]:
            got_state = fsweep.clone_state(state)
            got = call(libs[label][0], got_state, ets, vs, rows)
            if not all(torch.equal(a, b) for a, b in
                       zip(got + (got_state.adj,), want + (want_state.adj,))):
                raise AssertionError(f"window_prep {label} differs from the "
                                     f"current build at {setup}")
        times = {label: [] for label in labels}
        for r in range(args.rounds):
            for label in (labels if r % 2 == 0 else labels[::-1]):
                c = fsweep.clone_state(state)
                fn = libs[label][0]
                times[label].append(graph_ms(
                    lambda: call(fn, c, ets, vs, rows), 20))
        result["setups"][setup] = {
            "shape": list(rows.shape), "n": state.assignment.shape[0],
            "ms": times,
            "median_ms": {k: statistics.median(v) for k, v in times.items()}}
    print(card())
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
