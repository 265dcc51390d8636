"""The two-tower training step under two source trees, in turns on one
card: this checkout's ``src`` and another's (a parent unpacked by ``git
archive`` into a directory ``.gitignore`` lists, say).

    python scripts/train_step_ab.py build/parent/src [PAIRS]   # on a card

Each turn is a process of its own (``--one``): ``launch.train --full``'s
two-tower config (4,194,304 rows a table, f32) with AdamW, three warm-up
steps on batches of 16,384, then ten steps each timed by CUDA events,
then two steps under torch.profiler. The turns run in PAIRS pairs
(default 10), alternating which tree goes first: other, this; this,
other; ... Each turn prints one JSON line: the step times, their median,
the device time a step and the device ms a step of each kernel the bag
lookup and its backward launch (the bags, the order and pass, an int64
sort, fills). The last line is the summary: each pair's difference of
medians (this − other) and their median, least and greatest.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

KEYS = ("bwd", "embedding_bag", "radix", "sort", "fill", "memset")


def one(tree: str) -> dict:
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch import steps as train_steps
    from repro_torch.launch import train as trainer
    from repro_torch.models import recsys as RS
    from repro_torch.optim.optimizers import adamw, linear_warmup_cosine

    dev = torch.device("cuda", 0)
    cfg = trainer.training_config(get_arch("two-tower-retrieval"), full=True)
    params = RS.init_params(
        cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    opt = adamw(linear_warmup_cosine(3e-4, 2, 10))
    state = opt.init(params)
    step = train_steps.train_step(RS.loss_fn, cfg, opt)
    batches = [trainer.batch_tensors(RS.make_batch(cfg, 16_384, seed=i), dev)
               for i in range(3)]
    for i in range(3):
        params, state, _ = step(params, state, batches[i])
    torch.cuda.synchronize()
    ms = []
    for i in range(10):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        params, state, _ = step(params, state, batches[i % 3])
        b.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(2):
            params, state, _ = step(params, state, batches[i])
        torch.cuda.synchronize()
    total, kernels = 0.0, {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        us = e.self_cuda_time_total if us is None else us
        total += us
        if any(k in e.key.lower() for k in KEYS):
            kernels[e.key[:80]] = {"calls_per_step": e.count / 2,
                                   "ms_per_step": us / 1e3 / 2}
    return {"tree": tree, "step_ms": ms, "p50_ms": sorted(ms)[len(ms) // 2],
            "device_ms_per_step": total / 1e3 / 2, "kernels": kernels}


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print(json.dumps(one(sys.argv[2])), flush=True)
        return 0
    if len(sys.argv) not in (2, 3):
        raise SystemExit(__doc__)
    pairs = int(sys.argv[2]) if len(sys.argv) == 3 else 10
    here = str(Path(__file__).resolve().parents[1] / "src")
    other = str(Path(sys.argv[1]).resolve())
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    diffs = []
    for i in range(pairs):
        p50 = {}
        for tree in ((other, here) if i % 2 == 0 else (here, other)):
            env = {**os.environ, "PYTHONPATH": tree}
            line = subprocess.run(
                [sys.executable, __file__, "--one", tree], env=env,
                check=True, stdout=subprocess.PIPE, text=True).stdout.strip()
            print(line, flush=True)
            p50[tree] = json.loads(line)["p50_ms"]
        diffs.append(p50[here] - p50[other])
    ranked = sorted(diffs)
    print(json.dumps({"pairs": pairs, "this_minus_other_ms": diffs,
                      "median_ms": (ranked[(pairs - 1) // 2]
                                    + ranked[pairs // 2]) / 2,
                      "min_ms": ranked[0], "max_ms": ranked[-1]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
