"""How far the GNNs' first-step gradients on the card sit from exact
arithmetic, at ``chip_smoke.py`` phase ``gnn``'s shapes.

    PYTHONPATH=src python scripts/gnn_precision.py              # on a card
    PYTHONPATH=src python scripts/gnn_precision.py --f32-sums
    PYTHONPATH=src python scripts/gnn_precision.py --arch pna schnet nequip

``--arch meshgraphnet`` (the default) builds ``chip_smoke.py`` phase ``gnn``'s layouts of twitter (degree cap
192; card sessions of its insert stream at k = 8, SDP and hash, no
autoscale), then takes MeshGraphNet ``CONFIG``'s first step (d_feat 100,
the same params and batch as the phase) in f32 four ways — the dense
model twice, the SDP and hash layouts — and once in f64 (the dense model,
params and inputs cast), and prints for each f32 step the loss's and the
worst gradient leaf's relative distance (L2 over the leaf) to the f64
step and to the other f32 steps, and each step's seconds.

``--f32-sums`` replaces the port's scatter-adds (f64 accumulation, one
rounding) by plain f32 ``index_add`` ones, whose result depends on the
order in which the card's atomic adds land. Needs one CUDA card; builds
the session kernels.

``--arch pna schnet nequip`` takes each arch's ``CONFIG`` first step at
the phase's batch (PNA: ``minibatch_lg`` sampled from twitter; SchNet and
NequIP: ``molecule``), from params drawn on the host, four ways: f32 and
f64 on the card and on the host; it prints each one's distance to the
host's f64 step (over the entries finite in both) and each leaf's count
of non-finite entries.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from repro_torch.api import Partitioner
from repro_torch.configs import GNN_SHAPES, get_arch
from repro_torch.core.config import EngineConfig
from repro_torch.graph.csr import cap_degree
from repro_torch.graph.datasets import load_dataset
from repro_torch.graph.halo import build_halo_spec
from repro_torch.graph.stream import build_stream
from repro_torch.launch import steps
from repro_torch.launch.train import batch_tensors
from repro_torch.models import layers
from repro_torch.models.gnn import common as C
from repro_torch.data import pipeline as dp
from repro_torch.models.gnn import meshgraphnet as MGN
from repro_torch.models.gnn import nequip as NQ
from repro_torch.models.gnn import pna as PNA
from repro_torch.models.gnn import schnet as SCH
from repro_torch.models.gnn.common import batch_molecules, graph_to_batch
from repro_torch.optim.optimizers import tree_map
from repro_torch.runtime.gnn_halo_train import halo_batch, make_mgn_halo_loss

SHARDS, D_FEAT, WINDOW = 8, 100, 256


def _f32_sums():
    """Scatter-adds in the data's own dtype (the order of atomics shows)."""
    def segment_sum_pad(data, seg_ids, n):
        safe = torch.where(seg_ids >= 0, seg_ids, n).long()
        out = data.new_zeros((n + 1,) + tuple(data.shape[1:]))
        return out.index_add(0, safe, data)[:n]

    class Gather(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, idx):
            ctx.save_for_backward(idx)
            ctx.rows = x.shape[0]
            return torch.index_select(x, 0, idx)

        @staticmethod
        def backward(ctx, g):
            (idx,) = ctx.saved_tensors
            out = g.new_zeros((ctx.rows,) + tuple(g.shape[1:]))
            return out.index_add_(0, idx, g), None

    C.segment_sum_pad = segment_sum_pad
    C._GatherRows = Gather


def _rel(a, b) -> float:
    fin = torch.isfinite(a) & torch.isfinite(b)
    a, b = a.double()[fin], b.double()[fin]
    d = torch.linalg.vector_norm(a - b)
    n = torch.linalg.vector_norm(b)
    return float(d / n) if float(n) > 0 else float(d)


def _step(loss_fn, params, batch, cfg) -> tuple:
    torch.cuda.synchronize()
    t = time.perf_counter()
    loss, _, grads = steps.value_and_grad(loss_fn, params, batch, cfg)
    torch.cuda.synchronize()
    return (float(loss), {k: v.double().cpu()
                          for k, v in layers.leaves(grads)},
            time.perf_counter() - t)


def _worst(a: tuple, b: tuple) -> dict:
    rel = {k: _rel(a[1][k], b[1][k]) for k in b[1]}
    k = max(rel, key=rel.get)
    return {"loss_rel": abs(a[0] - b[0]) / abs(b[0]),
            "grad_rel_l2_max": rel[k], "leaf": k}


def _f64(tree: dict) -> dict:
    return {k: _f64(v) if isinstance(v, dict) else
            v.double() if v.dtype == torch.float32 else v
            for k, v in tree.items()}


def meshgraphnet(dev, g) -> dict:
    s = build_stream(g, seed=0)
    cfg = get_arch("meshgraphnet").config
    batch_np = graph_to_batch(g, D_FEAT, seed=0)
    params = MGN.init_params(cfg, D_FEAT, generator=torch.Generator(
        device=dev).manual_seed(0), device=dev)
    runs = {}
    dense = batch_tensors(batch_np, dev)
    for name in ("dense", "dense_again"):
        runs[name] = _step(MGN.loss_fn, params, dense, cfg)
    for policy in ("sdp", "hash"):
        part = Partitioner.from_stream(
            s, EngineConfig(k_max=SHARDS, k_init=SHARDS, autoscale=False),
            policy=policy, seed=0, use_kernel=True, window=WINDOW,
            device=dev).feed(s)
        assign = part.state.assignment.cpu().numpy().copy()
        del part
        assign[assign < 0] = 0
        spec = build_halo_spec(g, assign, SHARDS)
        hb = batch_tensors(halo_batch(spec, batch_np["node_feat"],
                                      batch_np["targets"]), dev)
        runs[policy] = _step(make_mgn_halo_loss(cfg, spec.block_size),
                             params, hb, cfg)
        del hb
    f64 = _step(MGN.loss_fn, _f64(params), _f64(dense), cfg)
    return {"seconds": {k: v[2] for k, v in runs.items()},
            "vs_f64": {k: _worst(v, f64) for k, v in runs.items()},
            "pairs": {f"{a}_vs_{b}": _worst(runs[a], runs[b])
                      for a, b in (("dense_again", "dense"),
                                   ("sdp", "dense"), ("hash", "dense"),
                                   ("sdp", "hash"))}}


def small(dev, g, arch_id: str) -> dict:
    cfg = get_arch(arch_id).config
    gen = torch.Generator().manual_seed(0)
    if arch_id == "pna":
        shape = GNN_SHAPES["minibatch_lg"]
        batch_np = next(dp.graph_minibatches(g, shape.d_feat,
                                             shape.batch_nodes, shape.fanout,
                                             seed=0))
        mod, params = PNA, PNA.init_params(cfg, shape.d_feat, generator=gen,
                                           device="cpu")
    else:
        shape = GNN_SHAPES["molecule"]
        batch_np = batch_molecules(shape.mol_batch, shape.n_nodes,
                                   shape.n_edges, seed=0)
        mod = SCH if arch_id == "schnet" else NQ
        params = mod.init_params(cfg, generator=gen, device="cpu")
    host = batch_tensors(batch_np, "cpu")
    card = batch_tensors(batch_np, dev)
    on_card = tree_map(lambda x: x.to(dev), params)
    runs = {"card_f32": _step(mod.loss_fn, on_card, card, cfg),
            "host_f32": _step(mod.loss_fn, params, host, cfg),
            "card_f64": _step(mod.loss_fn, _f64(on_card), _f64(card), cfg)}
    ref = _step(mod.loss_fn, _f64(params), _f64(host), cfg)
    nonfinite = {k: {leaf: int((~torch.isfinite(x)).sum())
                     for leaf, x in v[1].items()}
                 for k, v in {**runs, "host_f64": ref}.items()}
    same_masks = all(torch.equal(torch.isfinite(runs["card_f32"][1][leaf]),
                                 torch.isfinite(runs["host_f32"][1][leaf]))
                     for leaf in ref[1])
    return {"seconds": {k: v[2] for k, v in runs.items()},
            "vs_host_f64": {k: _worst(v, ref) for k, v in runs.items()},
            "card_f32_vs_host_f32": _worst(runs["card_f32"],
                                           runs["host_f32"]),
            "nonfinite": nonfinite, "card_host_same_masks": same_masks}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--f32-sums", action="store_true")
    p.add_argument("--arch", nargs="+", default=["meshgraphnet"],
                   choices=["meshgraphnet", "pna", "schnet", "nequip"])
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("gnn_precision: needs a CUDA card")
    if args.f32_sums:
        _f32_sums()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    g = cap_degree(load_dataset("twitter", scale=1.0), 192)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    for arch_id in args.arch:
        out = meshgraphnet(dev, g) if arch_id == "meshgraphnet" \
            else small(dev, g, arch_id)
        print(json.dumps({"arch": arch_id, "sums": "f32" if args.f32_sums
                          else "f64-accumulated", **out, "card": card}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
