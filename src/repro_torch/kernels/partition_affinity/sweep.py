"""Timing sweep of ``csrc/partition_affinity.cu``'s constants on the card.

    PYTHONPATH=src python -m repro_torch.kernels.partition_affinity.sweep

Builds the source as it stands and one variant per entry of ``VARIANTS``
(the source with those constants replaced: ``kRegK = 0`` counts K = 16 in
the shared-memory histogram with atomics instead of registers), one
``nvcc`` each, all started together; checks each variant bit-equal to the
built kernel at the streaming session's (W, D, K) = (256, 192, 16) and at
K = 200; and prints the card's name and power limit, then one JSON line:
each build's device time per call (CUDA-graph replay), the built kernel's
once more after the variants, and the launch floor — a one-element
``zero_`` timed the same way. A development tool: nothing in the package
runs it. Needs one CUDA card.
"""
from __future__ import annotations

import ctypes
import json
import sys

import torch

from repro_torch.kernels import common
from repro_torch.kernels.partition_affinity.partition_affinity import (
    partition_affinity,
)
from repro_torch.kernels.sweep import build_variants, card, graph_ms

VARIANTS = {"shared_atomics": {"kRegK": 0}, "loads_1": {"kLoads": 1},
            "loads_2": {"kLoads": 2}, "warps_4": {"kWarps": 4},
            "warps_2": {"kWarps": 2}}
SHAPES = ((256, 192, 16), (256, 192, 200))
ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def sweep(fns: dict, w: int, d: int, k: int) -> dict:
    """{build: ms} at (w, d, k): the built kernel, each variant (after a
    bit-equality check against the built kernel), the built kernel again."""
    dev = torch.device("cuda", 0)
    labels = torch.randint(-1, k, (w, d), device=dev, dtype=torch.int32,
                           generator=torch.Generator(device=dev)
                           .manual_seed(k))
    want = partition_affinity(labels, k_max=k)
    scores = torch.empty_like(want[0])
    deg = torch.empty_like(want[1])
    times = {"built": graph_ms(lambda: partition_affinity(labels, k_max=k),
                               100)}
    for name, fn in fns.items():
        def run(fn=fn, name=name):
            common.check_launch(fn(labels.data_ptr(), scores.data_ptr(),
                                   deg.data_ptr(), w, d, k,
                                   common.stream_ptr(dev)), name)

        run()
        torch.cuda.synchronize()
        if not (torch.equal(scores, want[0]) and torch.equal(deg, want[1])):
            raise AssertionError(f"partition_affinity {name} differs from "
                                 "the built kernel")
        times[name] = graph_ms(run, 100)
    times["built_again"] = graph_ms(
        lambda: partition_affinity(labels, k_max=k), 100)
    return times


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("the sweep needs a CUDA card")
    fns = build_variants("partition_affinity", VARIANTS, ARGTYPES)
    one = torch.zeros(1, device="cuda")
    result = {"variants": VARIANTS,
              "ms": {"x".join(map(str, s)): sweep(fns, *s) for s in SHAPES},
              "launch_floor_ms": graph_ms(one.zero_, 100)}
    print(card())
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
