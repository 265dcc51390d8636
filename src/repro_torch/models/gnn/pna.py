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


def apply(params, batch, cfg: PNAConfig):
    snd, rcv = batch["senders"], batch["receivers"]
    n = batch["node_feat"].shape[0]
    emask = (snd >= 0)[:, None]
    h = L.mlp_apply(params["enc"], batch["node_feat"])

    deg = C.in_degree(rcv, n)                               # (N,)
    logd = torch.log(deg + 1.0)
    scal = {
        "identity": torch.ones_like(logd),
        "amplification": logd / cfg.delta,
        "attenuation": cfg.delta / torch.clamp(logd, min=1e-3),
    }

    for i in range(cfg.n_layers):
        lp = L.layer_slice(params["layers"], i)
        hs, hr = C.gather_src(h, snd), C.gather_src(h, rcv)
        msg = L.mlp_apply(lp["pre"], torch.cat([hs, hr], -1))
        msg = torch.where(emask, msg, 0.0)
        aggs = []
        mean = C.segment_mean_pad(msg, rcv, n)
        for a in cfg.aggregators:
            if a == "mean":
                agg = mean
            elif a == "max":
                agg = C.segment_max_pad(
                    torch.where(emask, msg, -torch.inf), rcv, n, fill=0.0)
            elif a == "min":
                agg = C.segment_min_pad(
                    torch.where(emask, msg, torch.inf), rcv, n, fill=0.0)
            elif a == "std":
                sq = C.segment_mean_pad(msg**2, rcv, n)
                agg = torch.sqrt(torch.clamp(sq - mean**2, min=0.0) + 1e-8)
            else:
                raise ValueError(a)
            for s in cfg.scalers:
                aggs.append(agg * scal[s][:, None])
        z = torch.cat([h] + aggs, dim=-1)
        h = h + L.mlp_apply(lp["post"], z)
    return L.mlp_apply(params["dec"], h)


def loss_fn(params, batch, cfg: PNAConfig):
    return C.readout_loss(apply(params, batch, cfg), batch)
