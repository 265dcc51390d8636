"""Serving entry point of the port: recsys request scoring (the counterpart of
``repro.launch.serve``'s recsys path).

    python -m repro_torch.launch.serve --arch two-tower-retrieval --full
    python -m repro_torch.launch.serve --arch two-tower-retrieval --device cpu

Each request is ``--slots`` (user, item) pairs whose ids come from
``make_batch`` on the host; they are copied to the device and scored with
``serve_score``. The port's registry holds recsys archs only: LM serving
comes with the LM slice (ROADMAP A18.4), and ``get_arch`` raises
``NotImplementedError`` for an LM arch.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import get_arch
from repro_torch.core.state import resolve_device
from repro_torch.models import recsys as RS

FULL_HELP = ("serve the full config with bf16 tables: CONFIG's f32 tables "
             "(2 x 50,331,648 x 256 x 4 B = 103.08 GB) do not fit one 80 GB "
             "card, in bf16 they take 51.54 GB; the bag kernel widens rows to "
             "f32 and the towers stay f32")


def serving_config(arch, full: bool):
    """The config ``--full`` serves (``arch.config`` with bf16 tables, the
    one change from the JAX package's config), else the smoke config."""
    return dataclasses.replace(arch.config, dtype="bfloat16") if full \
        else arch.smoke_config


def request_tensors(batch: dict, device) -> dict:
    """A ``make_batch`` request's id arrays as int32 tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()
            if k.endswith("_ids")}


def serve_recsys(args) -> int:
    arch = get_arch(args.arch)
    cfg = serving_config(arch, args.full)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = RS.init_params(cfg, generator=gen, device=dev)
    t0 = time.time()
    n = 0
    for i in range(args.requests):
        batch = request_tensors(
            RS.make_batch(cfg, args.slots, seed=args.seed + i), dev)
        s = RS.serve_score(params, batch, cfg)
        n += s.shape[0]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    print(f"scored {n} (user,item) pairs in {dt:.2f}s ({n/dt:.0f}/s)")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", required=True)
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=32,
                   help="LM serving only (not ported yet)")
    p.add_argument("--gen", type=int, default=16,
                   help="LM serving only (not ported yet)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--full", action="store_true", help=FULL_HELP)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs the "
                        "plain versions)")
    return serve_recsys(p.parse_args(argv))


if __name__ == "__main__":
    raise SystemExit(main())
