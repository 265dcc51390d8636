"""Training entry point of the port (the counterpart of
``repro.launch.train``):
fault-tolerant training of the two-tower recsys model, the LMs and the
GNNs.

    python -m repro_torch.launch.train --arch two-tower-retrieval
    python -m repro_torch.launch.train --arch two-tower-retrieval --full
    python -m repro_torch.launch.train --arch two-tower-retrieval --device cpu
    python -m repro_torch.launch.train --arch moonshot-v1-16b-a3b --device cpu
    python -m repro_torch.launch.train --arch moonshot-v1-16b-a3b --full \
        --batch 2 --seq 4096
    python -m repro_torch.launch.train --arch meshgraphnet --device cpu

config → params → eager autograd step (AdamW, linear warmup then cosine)
→ data pipeline → ``FaultTolerantLoop`` with background checkpoints in the
JAX package's format; a run resumes from the latest checkpoint in
``--ckpt-dir``, as the JAX package's does (and, as there, restarts its
batches from batch 0: ROADMAP C). On the card the bags run the
``embedding_bag`` kernel forward and ``embedding_bag_backward`` backward,
and an LM's attention the ``flash_attention`` kernel forward (its backward
recomputes through the plain version, as the JAX package's does). A GNN
trains on the JAX package's fixed batch: a 256-node mesh graph with 16
features (MeshGraphNet, PNA), or ``--batch`` molecules of 12 atoms and 24
edges (SchNet, NequIP; NequIP's gradients are non-finite on it, as the JAX
package's are: ROADMAP C). This trainer runs the one-card step; the LM
cells' data- and model-sharded steps are ``launch.steps.build_step``'s
bundles (``runtime.lm_sharded``), which run on a mesh of several entries.
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
from repro_torch.graph.generators import make_graph
from repro_torch.launch.steps import _GNN_MODELS, train_step
from repro_torch.models import recsys as RS
from repro_torch.models import transformer as T
from repro_torch.models.gnn import common as C
from repro_torch.optim.optimizers import (
    adamw, linear_warmup_cosine, tree_leaves,
)
from repro_torch.runtime.fault import FaultTolerantLoop

# rows of each table that --full trains on one card: 2^22, a multiple of
# 512 as the config's 50,331,648 is. At that vocabulary the f32 params,
# dense table gradients and AdamW's f32 mu and nu take 34.4 GB of the
# card's 80; at the config's, the tables alone take 103 GB.
FULL_TRAIN_VOCAB = 4_194_304
# layers of an LM's CONFIG that --full trains on one card. A param costs 12
# B (bf16 param and gradient, AdamW's f32 mu and nu): a moonshot-v1-16b-a3b
# layer 6.85 GB, its embedding and head 8.05 GB, so 4 layers hold 35.4 GB
# and 6 would hold 49.1 GB. That state may take at most FULL_TRAIN_STATE
# bytes, half the 80 GB card: the other half holds the activations of a 2 x
# 4,096-token batch, the loss's 8,192 x 163,840 f32 logits (5.4 GB, and its
# gradient beside them), the plain attention that the backward recomputes
# (2.1 GB of scores a layer) and the optimizer's f32 temporaries.
FULL_TRAIN_LAYERS = 4
FULL_TRAIN_STATE = 40e9
FULL_HELP = ("train the arch's full config. two-tower-retrieval: CONFIG "
             f"with user_vocab = item_vocab = {FULL_TRAIN_VOCAB:,} (f32 tables "
             "of 2 x 50,331,648 x 256 x 4 B = 103 GB, and AdamW's f32 moments "
             "beside them, do not fit one 80 GB card; training the full "
             "vocabulary needs the tables across cards). An LM: CONFIG at "
             f"every width with n_layers cut to {FULL_TRAIN_LAYERS}: at 12 B a "
             "param (bf16 param and gradient, AdamW's f32 moments) a "
             "moonshot-v1-16b-a3b layer takes 6.85 GB and its embedding and "
             "head 8.05 GB, so 4 layers hold 35.4 GB and 6 would hold 49.1 "
             "GB, past the 40 GB (half the card) left beside the "
             "activations, the loss's logits and the optimizer's "
             "temporaries; an LM whose cut state passes 40 GB "
             "(llama4-scout-17b-a16e: 124.5 GB) is refused. At that size "
             "the step's transients fragment the allocator's fixed "
             "segments, so an LM's --full run has the CUDA allocator grow "
             "its segments in place (expandable_segments)")


def grow_segments() -> None:
    """Have the CUDA caching allocator grow its segments in place
    (``expandable_segments:True``), as an LM's ``--full`` run needs: its
    step's transients (the loss's 5 GiB of f32 logits, 2 GiB of attention
    scores a layer in the backward) fragment fixed segments until a step
    fails with 14 GiB reserved but free (H100 80GB HBM3, 700.00 W). The
    allocator reads ``PYTORCH_ALLOC_CONF`` when the process first uses
    CUDA, so this must run before that; a setting the caller made there,
    or in the older ``PYTORCH_CUDA_ALLOC_CONF``, is kept."""
    for var in ("PYTORCH_ALLOC_CONF", "PYTORCH_CUDA_ALLOC_CONF"):
        conf = os.environ.get(var)
        if conf is not None:
            if "expandable_segments" not in conf:
                os.environ[var] = f"{conf},expandable_segments:True"
            return
    os.environ["PYTORCH_ALLOC_CONF"] = "expandable_segments:True"


def lm_state_bytes(cfg) -> int:
    """Bytes of an LM's params, gradients and AdamW moments: the param and
    its gradient in ``cfg.dtype``, mu and nu f32."""
    return cfg.param_count() * (2 * cfg.torch_dtype.itemsize + 8)


def training_config(arch, full: bool):
    """The config ``--full`` trains, else the smoke config. Recsys:
    ``arch.config`` with ``user_vocab = item_vocab = FULL_TRAIN_VOCAB``.
    LM: ``arch.config`` with ``n_layers = FULL_TRAIN_LAYERS``, refused
    (ValueError) if its training state passes ``FULL_TRAIN_STATE``. Each
    is the one change from the JAX package's config."""
    if not full:
        return arch.smoke_config
    if arch.family == "lm":
        cfg = dataclasses.replace(arch.config, n_layers=FULL_TRAIN_LAYERS)
        need = lm_state_bytes(cfg)
        if need > FULL_TRAIN_STATE:
            raise ValueError(
                f"{arch.arch_id} at {FULL_TRAIN_LAYERS} layers holds "
                f"{need / 1e9:.1f} GB of params, gradients and AdamW moments, "
                f"more than the {FULL_TRAIN_STATE / 1e9:.0f} GB that leaves "
                "one 80 GB card room for the step; the sharded step bundles "
                "(launch.steps.build_step) split it over a mesh, and what "
                "is missing is a machine with several cards")
        return cfg
    return dataclasses.replace(arch.config, user_vocab=FULL_TRAIN_VOCAB,
                               item_vocab=FULL_TRAIN_VOCAB)


def build_lm(arch, args, device):
    cfg = training_config(arch, args.full)
    params = T.init_params(
        cfg, generator=torch.Generator(device=device).manual_seed(args.seed),
        device=device)
    batches = dp.token_batches(cfg.vocab, args.batch, args.seq,
                               seed=args.seed)
    return cfg, T.loss_fn, params, batches


def build_gnn(arch, args, device):
    cfg = training_config(arch, args.full)
    mod = _GNN_MODELS[arch.arch_id]
    gen = torch.Generator(device=device).manual_seed(args.seed)
    if arch.arch_id in ("schnet", "nequip"):
        batch = C.batch_molecules(args.batch, 12, 24, seed=args.seed)
        params = mod.init_params(cfg, generator=gen, device=device)
    else:
        g = make_graph("mesh", 256, 700, seed=args.seed)
        batch = C.graph_to_batch(g, 16, with_positions=True, seed=args.seed)
        params = mod.init_params(cfg, 16, generator=gen, device=device)

    def batches():
        while True:
            yield batch

    return cfg, mod.loss_fn, params, batches()


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
    if arch.family == "lm" and args.full:
        grow_segments()
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
