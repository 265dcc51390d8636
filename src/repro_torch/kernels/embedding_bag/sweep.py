"""Timing sweep of ``csrc/embedding_bag.cu``'s launch constants on the card.

    PYTHONPATH=src python -m repro_torch.kernels.embedding_bag.sweep

Builds the source as it stands and one variant per entry of ``VARIANTS``
(the source with those constants replaced), one ``nvcc`` each, all started
together; fills the two-tower config's full-vocabulary user table (bf16,
50,331,648 x 256, 25.8 GB) from a seed and takes the bags of the serving
phase's requests (``make_batch``: serve_p99's 512 pairs and serve_bulk's
262,144, user and item fields, 8 slots each); checks each variant
bit-equal to the built kernel; and prints the card's name and power limit,
then one JSON line: each build's device time per call (mean bags,
CUDA-graph replay) at both shapes (at serve_p99 over several requests in
turn, whose rows add up to 4x the L2, so that each is read from HBM as a
new request's would be: one request's 25 MB of rows fit the 50 MB L2),
the built kernel's once more after the variants (the spread of the
timing), and the rate over every slot's row, the ids and the output. A
development tool: nothing in the package runs it. Needs one CUDA card.
"""
from __future__ import annotations

import ctypes
import itertools
import json
import sys

import torch

from repro_torch.configs import get_arch
from repro_torch.kernels import common
from repro_torch.kernels.embedding_bag.embedding_bag import (
    embedding_bag, load_width,
)
from repro_torch.kernels.sweep import build_variants, card, graph_ms
from repro_torch.models import recsys as RS

VARIANTS = {"chunk_8": {"kChunk": 8}, "chunk_2": {"kChunk": 2},
            "warps_8": {"kWarps": 8}}
# (pairs, seed) of each serving shape's first request
SHAPES = {"serve_p99": (512, 1), "serve_bulk": (262_144, 10_000)}
L2_BYTES = 50 * 2 ** 20        # H100 SXM L2 (NVIDIA data sheet)
ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p])


def full_table(dev, v: int, d: int, chunk: int = 1 << 22) -> torch.Tensor:
    """A (v, d) bf16 table of standard normals from seed 0, filled in
    chunks (no f32 copy of the whole table)."""
    g = torch.Generator(device=dev).manual_seed(0)
    table = torch.empty((v, d), dtype=torch.bfloat16, device=dev)
    for r0 in range(0, v, chunk):
        rows = min(chunk, v - r0)
        table[r0:r0 + rows] = torch.randn((rows, d), generator=g, device=dev)
    return table


def bags(cfg, pairs: int, seed: int, dev) -> torch.Tensor:
    """A request's user and item bags as one (pairs * fields, slots) list."""
    ids = RS.make_batch(cfg, pairs, seed=seed)
    s = cfg.field_slots
    return torch.cat([torch.from_numpy(ids["user_ids"]).reshape(-1, s),
                      torch.from_numpy(ids["item_ids"]).reshape(-1, s)]).to(dev)


def sweep(fns: dict, table: torch.Tensor, idxs: list) -> dict:
    """{build: ms} of mean bags, each call on the next request of ``idxs``
    in turn: the built kernel, each variant (after a bit-equality check
    against the built kernel), the built kernel again; and GB/s over every
    slot's row, the ids and the output."""
    b, l = idxs[0].shape
    d = table.shape[1]
    width = load_width(d, table.element_size(), table.data_ptr())
    wants = [embedding_bag(table, idx, mode="mean") for idx in idxs]
    out = torch.empty_like(wants[0])
    for _ in range(3):                 # the card at its clocks, not idle
        embedding_bag(table, idxs[0], mode="mean")
    reps = len(idxs) * max((20 if b < 100_000 else 3) // len(idxs), 1)
    turn = itertools.cycle(idxs)

    def built():
        embedding_bag(table, next(turn), mode="mean")

    times = {"built": graph_ms(built, reps)}
    for name, fn in fns.items():
        def run(fn=fn, name=name, idx=None):
            idx = next(turn) if idx is None else idx
            common.check_launch(fn(
                table.data_ptr(), idx.data_ptr(), out.data_ptr(), b, l, d, 1,
                1, width, common.stream_ptr(table.device)), name)

        for idx, want in zip(idxs, wants):
            run(idx=idx)
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise AssertionError(f"embedding_bag {name} differs from "
                                     "the built kernel")
        times[name] = graph_ms(run, reps)
    times["built_again"] = graph_ms(built, reps)
    nbytes = sum(int((idx >= 0).sum()) * d * table.element_size()
                 + idx.numel() * 4 + b * d * 4 for idx in idxs) / len(idxs)
    return {"bags": b, "slots": l, "requests": len(idxs),
            "load_width": width, "all_slot_bytes": nbytes, "ms": times,
            "all_slot_gb_per_s": {k: nbytes / (ms * 1e-3) / 1e9
                                  for k, ms in times.items()}}


def requests(cfg, pairs: int, seed: int, dev, row_bytes: int) -> list:
    """Bags of requests seed, seed + 1, ... until their rows add up to 4x
    the L2 (one request where its own rows do)."""
    reqs = [bags(cfg, pairs, seed, dev)]
    while len(reqs) * reqs[0].numel() * row_bytes < 4 * L2_BYTES:
        reqs.append(bags(cfg, pairs, seed + len(reqs), dev))
    return reqs


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("the sweep needs a CUDA card")
    dev = torch.device("cuda", 0)
    cfg = get_arch("two-tower-retrieval").config
    fns = build_variants("embedding_bag", VARIANTS, ARGTYPES)
    table = full_table(dev, cfg.user_vocab, cfg.embed_dim)
    row_bytes = table.shape[1] * table.element_size()
    result = {"table": list(table.shape), "dtype": "bfloat16",
              "variants": VARIANTS,
              "shapes": {name: sweep(fns, table, requests(
                  cfg, pairs, seed, dev, row_bytes))
                  for name, (pairs, seed) in SHAPES.items()}}
    print(card())
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
