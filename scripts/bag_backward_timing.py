"""The bag backward (``embedding_bag_backward``) at the two-tower training
config's bags on the card, timed by ``chip_smoke.py``'s own helper.

    PYTHONPATH=src python scripts/bag_backward_timing.py        # on a card

At ``launch.train --full``'s config (4,194,304 rows a table, D = 256,
f32) and a batch of 16,384 (``chip_smoke.py`` phase ``train``'s), one
training step's loss is differentiated with the backward's inputs kept:
the user bags (131,072 × 8) and the item bags (65,536 × 8), mean mode.
For each table it runs ``chip_smoke._time_backward`` four times, in the
order: the step's own cotangent, a ``randn`` one of the same shape, the
step's again, ``randn`` again — so a difference between the two
cotangents shows apart from a difference between a first and a later
timing (each also times the pass again last and reads the SM clock,
temperature and power before each pass timing). Then the pass built with other ``kPassWarps`` (4, 16;
``kernels/sweep.build_variants``) on the step's cotangent. Prints one
JSON object. Needs one CUDA card; builds ``embedding_bag``.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as c  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels import sweep as ks  # noqa: E402
from repro_torch.launch import train as trainer  # noqa: E402
from repro_torch.models import recsys as RS  # noqa: E402
from repro_torch.optim.optimizers import tree_leaves, tree_map  # noqa: E402

BATCH = 16_384
PASS_WARPS = (4, 16)


def _step_inputs(cfg, dev) -> dict:
    """{table: (g, idx, V, mode)}: the bag backward's inputs in one
    training step's loss gradient (random params from seed 0, batch 0)."""
    params = RS.init_params(
        cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    tree = tree_map(lambda x: x.detach().requires_grad_(True), params)
    batch = trainer.batch_tensors(RS.make_batch(cfg, BATCH, seed=0), dev)
    with c._Hook(c.bag_ops, "embedding_bag_backward",
                 lambda i: i, clone=False) as hook:
        loss, _ = RS.loss_fn(tree, batch, cfg)
        grads = torch.autograd.grad(loss, tree_leaves(tree))
    del grads, tree, params, loss
    out = {}
    for (g, idx, v), kw, _, _ in hook.kept.values():
        table = "user" if idx.shape[0] == BATCH * cfg.user_fields else "item"
        out[table] = (g.detach(), idx, v, kw["mode"])
    hook.kept.clear()
    torch.cuda.empty_cache()
    return out


def _variants(g, idx, v: int, mean: bool, fns: dict) -> dict:
    b, l = idx.shape
    d = g.shape[1]
    order = c.eb.backward_order(idx, v)
    out = torch.empty((v, d), device=g.device)
    res = {}
    for name, fn in fns.items():
        def run(fn=fn):
            err = fn(g.data_ptr(), idx.data_ptr(), order.offsets.data_ptr(),
                     order.perm.data_ptr(), order.counts.data_ptr(),
                     out.data_ptr(), b, v, l, d, int(mean), 4,
                     common.stream_ptr(g.device))
            common.check_launch(err, name)
        res[f"pass_{name}_ms"] = c.graph_ms(run, 10)
    del out, order
    torch.cuda.empty_cache()
    return res


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda", 0)
    cfg = trainer.training_config(get_arch("two-tower-retrieval"), full=True)
    argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fns = ks.build_variants(
        "embedding_bag", {f"warps{w}": {"kPassWarps": w} for w in PASS_WARPS},
        argtypes, entry="embedding_bag_backward_pass")
    out = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()}
    for table, (g, idx, v, mode) in _step_inputs(cfg, dev).items():
        gen = torch.Generator(device=dev).manual_seed(1)
        noise = torch.randn(g.shape, device=dev, generator=gen)
        runs = []
        for name, grad in (("step", g), ("randn", noise), ("step", g),
                           ("randn", noise)):
            t = c._time_backward(grad, idx, v, mode)
            runs.append({"cotangent": name, **{k: t[k] for k in (
                "function_ms", "order_ms", "pass_ms", "pass_again_ms",
                "clock_temp_power", "fill_ms", "library_ms")}})
        out[table] = {"shape": t["shape"], "mode": mode,
                      "g_abs_max": float(g.abs().max()),
                      "g_zero_share": float((g == 0).float().mean()),
                      "runs": runs,
                      **_variants(g, idx, v, mode == "mean", fns)}
        del g, noise
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
