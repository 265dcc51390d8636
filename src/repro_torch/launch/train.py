"""Training entry point of the port (the counterpart of
``repro.launch.train``):
fault-tolerant training of the two-tower recsys model.

    python -m repro_torch.launch.train --arch two-tower-retrieval
    python -m repro_torch.launch.train --arch two-tower-retrieval --full
    python -m repro_torch.launch.train --arch two-tower-retrieval --device cpu

config → params → eager autograd step (AdamW, linear warmup then cosine)
→ data pipeline → ``FaultTolerantLoop`` with background checkpoints in the
JAX package's format; a run resumes from the latest checkpoint in
``--ckpt-dir``, as the JAX package's does (and, as there, restarts its
batches from batch 0: ROADMAP C). On the card the bags run the
``embedding_bag`` kernel forward and ``embedding_bag_backward`` backward.
LM and GNN training come with ROADMAP A18.4 and A18.5.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.core.state import resolve_device
from repro_torch.data import pipeline as dp
from repro_torch.launch.steps import train_step
from repro_torch.models import recsys as RS
from repro_torch.optim.optimizers import (
    adamw, linear_warmup_cosine, tree_leaves,
)
from repro_torch.runtime.fault import FaultTolerantLoop

# rows of each table that --full trains on one card: 2^22, a multiple of
# 512 as the config's 50,331,648 is. At that vocabulary the f32 params,
# dense table gradients and AdamW's f32 mu and nu take 34.4 GB of the
# card's 80; at the config's, the tables alone take 103 GB.
FULL_TRAIN_VOCAB = 4_194_304
FULL_HELP = ("train the arch's full config: two-tower-retrieval's CONFIG "
             f"with user_vocab = item_vocab = {FULL_TRAIN_VOCAB:,} (f32 tables "
             "of 2 x 50,331,648 x 256 x 4 B = 103 GB, and AdamW's f32 moments "
             "beside them, do not fit one 80 GB card; training the full "
             "vocabulary needs the tables across cards)")


def training_config(arch, full: bool):
    """The recsys config ``--full`` trains (``arch.config`` with
    ``user_vocab = item_vocab = FULL_TRAIN_VOCAB``, the one change from
    the JAX package's config), else the smoke config."""
    if not full:
        return arch.smoke_config
    return dataclasses.replace(arch.config, user_vocab=FULL_TRAIN_VOCAB,
                               item_vocab=FULL_TRAIN_VOCAB)


def build_lm(arch, args, device):
    raise NotImplementedError(
        f"training {arch.arch_id} is not ported yet: ROADMAP A18.4 (LM and "
        "MoE training: flash_attention's backward, the training mesh)")


def build_gnn(arch, args, device):
    raise NotImplementedError(
        f"training {arch.arch_id} is not ported yet: ROADMAP A18.5 (the GNN "
        "slice over SDP partitions)")


def build_recsys(arch, args, device):
    cfg = training_config(arch, args.full)
    params = RS.init_params(
        cfg, generator=torch.Generator(device=device).manual_seed(args.seed),
        device=device)
    batches = dp.recsys_batches(cfg, args.batch, seed=args.seed)
    return cfg, RS.loss_fn, params, batches


def batch_tensors(batch: dict, device) -> dict:
    """A numpy batch as tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", required=True)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--full", action="store_true", help=FULL_HELP)
    p.add_argument("--ckpt-dir", type=str,
                   default=os.path.join(tempfile.gettempdir(),
                                        "repro_torch_ckpt"))
    p.add_argument("--ckpt-interval", type=int, default=20)
    p.add_argument("--log-every", type=int, default=5)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs the "
                        "plain versions)")
    args = p.parse_args(argv)

    arch = get_arch(args.arch)
    device = resolve_device(args.device)
    build = {"lm": build_lm, "gnn": build_gnn, "recsys": build_recsys}
    cfg, loss_fn, params, batches = build[arch.family](arch, args, device)

    opt = adamw(linear_warmup_cosine(args.lr, args.steps // 10 + 1,
                                     args.steps))
    opt_state = opt.init(params)
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"arch={args.arch} family={arch.family} params={n_params:,}")
    step = train_step(loss_fn, cfg, opt)

    def step_fn(state, batch):
        params, opt_state = state
        params, opt_state, metrics = step(params, opt_state,
                                          batch_tensors(batch, device))
        return (params, opt_state), metrics

    ckpt = CheckpointManager(args.ckpt_dir, interval=args.ckpt_interval)
    loop = FaultTolerantLoop(ckpt)

    losses = []
    state = (params, opt_state)
    restored, rstep = ckpt.restore(state)
    start = 0
    if restored is not None:
        state, start = restored, rstep
        print(f"resumed from checkpoint step {start}")

    def counted(it, n):
        for _ in range(n):
            yield next(it)

    t0 = time.time()
    step_no = start

    def stepper(state, batch):
        nonlocal step_no
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        if step_no % args.log_every == 0:
            print(f"step {step_no:5d} loss {loss:.4f} "
                  f"({time.time() - t0:.1f}s)", flush=True)
        step_no += 1
        return state, metrics

    # as in the JAX package, the batches start again from batch 0 on resume
    state, final = loop.run(state, counted(batches, args.steps - start),
                            stepper, start_step=start)
    ckpt.maybe_save(final, state, blocking=True)
    if not losses:
        print(f"done: {final} steps, nothing left to train")
        return 0
    print(f"done: {final} steps, loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
          f"{(time.time()-t0):.1f}s")
    assert np.isfinite(losses[-1]), "training diverged"
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
