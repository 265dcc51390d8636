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
import sys

import numpy as np
import torch

from repro_torch.graph.csr import cap_degree
from repro_torch.graph.datasets import load_dataset
from repro_torch.kernels import common
from repro_torch.kernels.segment_spmm.segment_spmm import segment_spmm
from repro_torch.kernels.sweep import build_variants, card, graph_ms

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
    fns = build_variants("segment_spmm", VARIANTS,
                         [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                         + [ctypes.c_void_p])
    adj = twitter_ell(dev)
    result = {"graph": "twitter", "shape": list(adj.shape),
              "valid_slots": int((adj >= 0).sum()), "variants": VARIANTS,
              "ms": {f"F{f}": sweep(fns, adj, f) for f in WIDTHS}}
    print(card())
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
