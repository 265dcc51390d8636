"""SchNet [arXiv:1706.08566] (the port's copy of
``repro.models.gnn.schnet``): continuous-filter convolutions over
interatomic distances. Assigned config: 3 interactions, hidden 64, 300
gaussian RBFs, cutoff 10 Å.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.state import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.gnn import common as C


@dataclasses.dataclass(frozen=True)
class SchNetConfig:
    name: str = "schnet"
    n_interactions: int = 3
    d_hidden: int = 64
    n_rbf: int = 300
    cutoff: float = 10.0
    n_species: int = 100
    out_dim: int = 1


def shifted_softplus(x):
    """``softplus(x) - log 2`` as ``jax.nn.softplus`` computes it
    (``logaddexp(x, 0)``), without ``F.softplus``'s switch to ``x`` past
    ``threshold=20``."""
    return torch.logaddexp(x, torch.zeros_like(x)) - math.log(2.0)


def init_params(cfg: SchNetConfig, *, generator: torch.Generator,
                device=None) -> dict:
    """Random f32 params on ``device`` (None: the CUDA card) from
    ``generator``, which must live on that device."""
    dev = resolve_device(device)
    h = cfg.d_hidden

    def inter_init(_):
        return {"filter": L.mlp_init(generator, [cfg.n_rbf, h, h], device=dev),
                "in": L.dense_init(generator, h, h, device=dev),
                "out1": L.dense_init(generator, h, h, device=dev),
                "out2": L.dense_init(generator, h, h, device=dev)}

    return {
        "embed": torch.randn((cfg.n_species, h), generator=generator,
                             device=dev) * 0.1,
        "inter": L.stack_layer_params(inter_init, cfg.n_interactions),
        "head": L.mlp_init(generator, [h, h // 2, cfg.out_dim], device=dev),
    }


def param_specs(cfg: SchNetConfig) -> dict:
    return C.leaf_specs(init_params(cfg, generator=torch.Generator(),
                                    device="cpu"))


def params_from_jax(np_params: dict, cfg: SchNetConfig, *, device) -> dict:
    return L.params_from_numpy(np_params, param_specs(cfg), cfg.name,
                               resolve_device(device))


def _interaction(lp, x, agg):
    v = shifted_softplus(L.dense(lp["out1"], agg))
    return x + L.dense(lp["out2"], v)


def apply(params, batch, cfg: SchNetConfig, graph=None):
    """→ per-node outputs (N, out_dim); caller may graph-readout."""
    g = graph or C.Local(batch["species"].shape[0])
    snd, rcv = batch["senders"], batch["receivers"]
    _, dist, _ = C.edge_vectors(batch["positions"], snd, rcv, g)
    rbf = g.map(lambda d: C.gaussian_rbf(d, cfg.n_rbf, cfg.cutoff),
                dist)                                        # (E, R)
    emask = g.map(lambda s: (s >= 0)[:, None], snd)

    x = g.map(lambda p, s: p["embed"][s.long()], params,
              batch["species"])                              # (N, h)
    for i in range(cfg.n_interactions):
        lp = g.map(lambda p: L.layer_slice(p["inter"], i), params)
        w = g.map(lambda p, r: L.mlp_apply(p["filter"], r,
                                           act=shifted_softplus,
                                           final_act=True), lp, rbf)
        (xj,) = g.gather(g.map(lambda p, v: L.dense(p["in"], v), lp, x), snd)
        msg = g.map(lambda a, b, m: torch.where(m, a * b, 0.0), xj, w, emask)
        x = g.map(_interaction, lp, x, g.sum(msg, rcv))
    return g.map(lambda p, v: L.mlp_apply(p["head"], v,
                                          act=shifted_softplus), params, x)


def loss_fn(params, batch, cfg: SchNetConfig, graph=None):
    g = graph or C.Local(batch["species"].shape[0])
    return g.loss(apply(params, batch, cfg, g), batch)
