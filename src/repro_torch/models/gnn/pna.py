"""PNA [arXiv:2004.05718] (the port's copy of ``repro.models.gnn.pna``):
Principal Neighbourhood Aggregation.

Assigned config: 4 layers, hidden 75, aggregators mean/max/min/std,
scalers identity/amplification/attenuation (log-degree).

The std aggregator's ``sqrt(max(var, 0) + 1e-8)`` multiplies an error in a
near-zero variance (a node with one message, or with the same message
twice) by up to 1/(2·sqrt(1e-8)) = 5,000. On such a graph two f32
implementations differ in the loss's fourth digit: XLA's CPU backend
rounds ``sq - mean**2`` once (a fused multiply-add) and its matmuls round
otherwise than torch's, so the CPU tests hold this model to the JAX
package in f64 on the molecule batch.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.state import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.gnn import common as C


@dataclasses.dataclass(frozen=True)
class PNAConfig:
    name: str = "pna"
    n_layers: int = 4
    d_hidden: int = 75
    aggregators: tuple = ("mean", "max", "min", "std")
    scalers: tuple = ("identity", "amplification", "attenuation")
    out_dim: int = 1
    delta: float = 2.5   # E[log(d+1)] over training graphs (paper's δ)


def init_params(cfg: PNAConfig, d_node: int, *, generator: torch.Generator,
                device=None) -> dict:
    """Random f32 params on ``device`` (None: the CUDA card) from
    ``generator``, which must live on that device."""
    dev = resolve_device(device)
    h = cfg.d_hidden
    n_agg = len(cfg.aggregators) * len(cfg.scalers)

    def layer_init(_):
        return {"pre": L.mlp_init(generator, [2 * h, h], device=dev),
                "post": L.mlp_init(generator, [(n_agg + 1) * h, h],
                                   device=dev)}

    return {
        "enc": L.mlp_init(generator, [d_node, h], device=dev),
        "layers": L.stack_layer_params(layer_init, cfg.n_layers),
        "dec": L.mlp_init(generator, [h, h, cfg.out_dim], device=dev),
    }


def param_specs(cfg: PNAConfig, d_node: int) -> dict:
    return C.leaf_specs(init_params(cfg, d_node, generator=torch.Generator(),
                                    device="cpu"))


def params_from_jax(np_params: dict, cfg: PNAConfig, d_node: int, *,
                    device) -> dict:
    return L.params_from_numpy(np_params, param_specs(cfg, d_node), cfg.name,
                               resolve_device(device))


def _scalers(deg, cfg: PNAConfig) -> dict:
    logd = torch.log(deg + 1.0)
    return {
        "identity": torch.ones_like(logd),
        "amplification": logd / cfg.delta,
        "attenuation": cfg.delta / torch.clamp(logd, min=1e-3),
    }


def apply(params, batch, cfg: PNAConfig, graph=None):
    g = graph or C.Local(batch["node_feat"].shape[0])
    snd, rcv = batch["senders"], batch["receivers"]
    emask = g.map(lambda s: (s >= 0)[:, None], snd)
    h = g.map(lambda p, x: L.mlp_apply(p["enc"], x), params,
              batch["node_feat"])
    scal = g.map(lambda d: _scalers(d, cfg), g.degree(rcv))

    def message(lp, hs, hr, m):
        msg = L.mlp_apply(lp["pre"], torch.cat([hs, hr], -1))
        return torch.where(m, msg, 0.0)

    def update(lp, h, sc, *aggs):
        z = torch.cat([h] + [a * sc[s][:, None] for a in aggs
                             for s in cfg.scalers], dim=-1)
        return h + L.mlp_apply(lp["post"], z)

    for i in range(cfg.n_layers):
        lp = g.map(lambda p: L.layer_slice(p["layers"], i), params)
        hs, hr = g.gather(h, snd, rcv)
        msg = g.map(message, lp, hs, hr, emask)
        mean = g.mean(msg, rcv)
        aggs = []
        for a in cfg.aggregators:
            if a == "mean":
                agg = mean
            elif a == "max":
                agg = g.max(g.map(lambda x, m: torch.where(m, x, -torch.inf),
                                  msg, emask), rcv, 0.0)
            elif a == "min":
                agg = g.min(g.map(lambda x, m: torch.where(m, x, torch.inf),
                                  msg, emask), rcv, 0.0)
            elif a == "std":
                sq = g.mean(g.map(lambda x: x**2, msg), rcv)
                agg = g.map(lambda s, m: torch.sqrt(
                    torch.clamp(s - m**2, min=0.0) + 1e-8), sq, mean)
            else:
                raise ValueError(a)
            aggs.append(agg)
        h = g.map(update, lp, h, scal, *aggs)
    return g.map(lambda p, x: L.mlp_apply(p["dec"], x), params, h)


def loss_fn(params, batch, cfg: PNAConfig, graph=None):
    g = graph or C.Local(batch["node_feat"].shape[0])
    return g.loss(apply(params, batch, cfg, g), batch)
