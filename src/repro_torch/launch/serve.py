"""Serving entry point of the port (the counterpart of
``repro.launch.serve``): batched LM prefill + decode with slot-based
continuous batching, and recsys request scoring.

    python -m repro_torch.launch.serve --arch gemma2-9b --full
    python -m repro_torch.launch.serve --arch moonshot-v1-16b-a3b --full \
        --prompt-len 8192 --gen 32
    python -m repro_torch.launch.serve --arch gemma2-9b --device cpu
    python -m repro_torch.launch.serve --arch two-tower-retrieval --full

LM serving keeps a fixed pool of ``--slots`` decode slots with a
preallocated (S_max-slot) KV cache; a finished sequence frees its slot and
the next queued request is prefilled into it. Every attention call of
prefill and decode runs the ``flash_attention`` CUDA kernel on the card;
the MoE archs go through the same server (their FFN is ``models/moe.py``).
A recsys request is ``--slots`` (user, item) pairs whose ids come from
``make_batch`` on the host; they are copied to the device and scored with
``serve_score``.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.core.state import resolve_device
from repro_torch.models import recsys as RS
from repro_torch.models import transformer as T

FULL_HELP = ("serve the arch's full config: for an LM the config as it is "
             "(gemma2-9b: bf16, 18.48 GB of params; moonshot-v1-16b-a3b: "
             "bf16, 56.12 GB of params plus, with 4 slots at max_len 8,225, "
             "a 12.94 GB KV cache; llama4-scout-17b-a16e's 203.5 GB in bf16 "
             "do not fit one 80 GB card and are refused); for "
             "two-tower-retrieval "
             "CONFIG with bf16 tables (its f32 tables, 2 x 50,331,648 x 256 x "
             "4 B = 103.08 GB, do not fit one 80 GB card; in bf16 they take "
             "51.54 GB; the bag kernel widens rows to f32 and the towers stay "
             "f32)")


class LMServer:
    """Slot-based continuous batching over ``decode_step_inplace``, as the
    JAX package's ``LMServer``. The cache is written in place: a prefill
    copies its K/V into its slot, a decode step writes one position."""

    def __init__(self, params, cfg, *, slots: int, max_len: int):
        self.params, self.cfg = params, cfg
        self.slots, self.max_len = slots, max_len
        self.device = params["embed"].device
        shape = (cfg.n_layers, slots, max_len, cfg.n_kv_heads, cfg.head_dim)
        self.cache_k = torch.zeros(shape, dtype=cfg.torch_dtype,
                                   device=self.device)
        self.cache_v = torch.zeros(shape, dtype=cfg.torch_dtype,
                                   device=self.device)
        self.lengths = np.zeros(slots, np.int64)       # valid prefix length
        self.active = np.zeros(slots, bool)
        self.tokens = np.zeros(slots, np.int32)        # last emitted token
        self.outputs: dict[int, list[int]] = {}
        self.slot_req = -np.ones(slots, np.int64)

    def add_request(self, req_id: int, prompt: np.ndarray) -> bool:
        free = np.where(~self.active)[0]
        if free.size == 0:
            return False
        s = int(free[0])
        toks = torch.from_numpy(np.asarray(prompt, np.int32)[None]).to(
            self.device)
        logits, ck, cv = T.prefill_step(self.params, toks, self.cfg)
        plen = prompt.shape[0]
        self.cache_k[:, s, :plen] = ck[:, 0].to(self.cache_k.dtype)
        self.cache_v[:, s, :plen] = cv[:, 0].to(self.cache_v.dtype)
        tok = int(torch.argmax(logits[0]))
        self.lengths[s] = plen
        self.tokens[s] = tok
        self.active[s] = True
        self.slot_req[s] = req_id
        self.outputs[req_id] = [tok]
        return True

    def decode_round(self):
        """One decode step for every active slot: one
        ``decode_step_inplace`` per unique active length, every slot's K/V
        written at that length, as in the JAX package. A slot whose length
        differs is overwritten at that position too (ROADMAP C records
        this fault of the reference); ``serve_requests`` never lets the
        active lengths differ."""
        for ln in np.unique(self.lengths[self.active]):
            toks = torch.from_numpy(self.tokens[:, None].copy()).to(
                self.device)
            logits, _, _ = T.decode_step_inplace(
                self.params, toks, self.cache_k, self.cache_v, int(ln),
                self.cfg)
            sel = self.active & (self.lengths == ln)
            nxt = torch.argmax(logits, -1).cpu().numpy()
            for s in np.where(sel)[0]:
                tok = int(nxt[s])
                self.tokens[s] = tok
                self.outputs[int(self.slot_req[s])].append(tok)
                self.lengths[s] = ln + 1

    def finish(self, req_id: int):
        s = np.where(self.slot_req == req_id)[0]
        if s.size:
            self.active[s[0]] = False
            self.slot_req[s[0]] = -1


def serve_requests(server, *, requests: int, prompt_len: int, gen: int,
                   rng: np.random.Generator) -> dict[int, list[int]]:
    """The JAX package's ``serve_lm`` schedule: fill free slots with
    prompts of ``prompt_len`` tokens drawn from ``rng`` (one draw per
    attempt, as there), decode a round, free the slots whose requests have
    ``gen`` tokens. Works on any server with ``LMServer``'s methods.
    Returns the generated tokens by request id."""
    pending = list(range(requests))
    done = 0
    while done < requests:
        while pending and server.add_request(
                pending[0],
                rng.integers(0, server.cfg.vocab, prompt_len).astype(np.int32)):
            pending.pop(0)
        server.decode_round()
        for req_id, out in list(server.outputs.items()):
            if len(out) >= gen and req_id in server.slot_req:
                server.finish(req_id)
                done += 1
    return server.outputs


def device_bytes(device: torch.device) -> int:
    """The memory of ``device``: a card's from its properties, the host's
    physical memory for the CPU."""
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory
    return os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


def check_fits(cfg, capacity: int) -> None:
    """Refuse an LM config whose params alone pass ``capacity`` bytes."""
    need = cfg.param_count() * cfg.torch_dtype.itemsize
    if need > capacity:
        raise ValueError(
            f"{cfg.name}: {need / 1e9:.1f} GB of params in {cfg.dtype} do not "
            f"fit the device's {capacity / 1e9:.1f} GB; the sharded step "
            "bundles (launch.steps.build_step) split it over a mesh, and "
            "what is missing is a machine with several cards")


def serve_lm(args) -> int:
    arch = get_arch(args.arch)
    cfg = arch.config if args.full else arch.smoke_config
    dev = resolve_device(args.device)
    check_fits(cfg, device_bytes(dev))
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = T.init_params(cfg, generator=gen, device=dev)
    server = LMServer(params, cfg, slots=args.slots,
                      max_len=args.prompt_len + args.gen + 1)
    t0 = time.time()
    with torch.inference_mode():
        outputs = serve_requests(server, requests=args.requests,
                                 prompt_len=args.prompt_len, gen=args.gen,
                                 rng=np.random.default_rng(args.seed))
    dt = time.time() - t0
    total_tokens = sum(len(v) for v in outputs.values())
    print(f"served {args.requests} requests, {total_tokens} tokens "
          f"in {dt:.1f}s ({total_tokens/dt:.1f} tok/s)")
    return 0


def serving_config(arch, full: bool):
    """The recsys config ``--full`` serves (``arch.config`` with bf16
    tables, the one change from the JAX package's config), else the smoke
    config."""
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
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--gen", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--full", action="store_true", help=FULL_HELP)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs the "
                        "plain versions)")
    args = p.parse_args(argv)
    arch = get_arch(args.arch)
    if arch.family == "lm":
        return serve_lm(args)
    if arch.family == "recsys":
        return serve_recsys(args)
    raise SystemExit("serving supports lm and recsys archs")


if __name__ == "__main__":
    raise SystemExit(main())
