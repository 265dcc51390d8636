"""MeshGraphNet [arXiv:2010.03409] (the port's copy of
``repro.models.gnn.meshgraphnet``): encode–process–decode with edge+node
MLPs and residual updates. Assigned config: 15 layers, hidden 128, sum
aggregation, 2-hidden-layer MLPs (+LayerNorm, as in the paper).

The processor's params keep JAX's stacked ``(L, ...)`` leaves; ``remat``
runs each processor layer under ``torch.utils.checkpoint``, so a layer's
activations are recomputed in the backward pass and only its ``(h, e)``
carry stays live, as ``jax.checkpoint`` around the scan body does.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.state import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.gnn import common as C


@dataclasses.dataclass(frozen=True)
class MGNConfig:
    name: str = "meshgraphnet"
    n_layers: int = 15
    d_hidden: int = 128
    mlp_layers: int = 2
    aggregator: str = "sum"
    out_dim: int = 1
    remat: bool = True


def _mlp_dims(cfg: MGNConfig, d_in: int, d_out: int):
    return [d_in] + [cfg.d_hidden] * cfg.mlp_layers + [d_out]


def _block_init(generator, cfg: MGNConfig, d_in: int, d_out: int, dev):
    return {"mlp": L.mlp_init(generator, _mlp_dims(cfg, d_in, d_out),
                              device=dev),
            "ln": L.layernorm_init(d_out, device=dev)}


def _block(p, x):
    return L.layernorm(p["ln"], L.mlp_apply(p["mlp"], x))


def init_params(cfg: MGNConfig, d_node: int, d_edge: int = 4, *,
                generator: torch.Generator, device=None) -> dict:
    """Random f32 params on ``device`` (None: the CUDA card) from
    ``generator``, which must live on that device."""
    dev = resolve_device(device)
    h = cfg.d_hidden

    def proc_init(_):
        return {"edge": _block_init(generator, cfg, 3 * h, h, dev),
                "node": _block_init(generator, cfg, 2 * h, h, dev)}

    return {
        "enc_node": _block_init(generator, cfg, d_node, h, dev),
        "enc_edge": _block_init(generator, cfg, d_edge, h, dev),
        "proc": L.stack_layer_params(proc_init, cfg.n_layers),
        "dec": {"mlp": L.mlp_init(generator, _mlp_dims(cfg, h, cfg.out_dim),
                                  device=dev)},
    }


def param_specs(cfg: MGNConfig, d_node: int, d_edge: int = 4) -> dict:
    """{leaf path: (shape, dtype)} of the params ``init_params`` makes."""
    return C.leaf_specs(init_params(cfg, d_node, d_edge,
                                    generator=torch.Generator(),
                                    device="cpu"))


def params_from_jax(np_params: dict, cfg: MGNConfig, d_node: int,
                    d_edge: int = 4, *, device) -> dict:
    """The port's params from a JAX ``init_params`` pytree with numpy
    leaves (the same layout: nothing is transposed)."""
    return L.params_from_numpy(np_params, param_specs(cfg, d_node, d_edge),
                               cfg.name, resolve_device(device))


def edge_features(batch: dict, like):
    """The mesh edge features: relative position and length where the
    batch has positions, else ones."""
    if "edge_feat" in batch:
        return batch["edge_feat"]
    snd = batch["senders"]
    if "positions" in batch:
        vec, dist, _ = C.edge_vectors(batch["positions"], snd,
                                      batch["receivers"])
        return torch.cat([vec, dist[:, None]], dim=-1)
    return torch.ones(tuple(snd.shape) + (4,), dtype=like.dtype,
                      device=like.device)


def run_layers(step, params, cfg: MGNConfig, h, e):
    """The processor: ``step(lp, h, e) -> (h, e)`` over the stacked layers,
    each under ``checkpoint`` when ``cfg.remat`` and autograd records."""
    for i in range(cfg.n_layers):
        lp = L.layer_slice(params["proc"], i)
        if cfg.remat and torch.is_grad_enabled():
            h, e = checkpoint(step, lp, h, e, use_reentrant=False)
        else:
            h, e = step(lp, h, e)
    return h


def apply(params, batch, cfg: MGNConfig):
    """→ node outputs (N, out_dim)."""
    snd, rcv = batch["senders"], batch["receivers"]
    n = batch["node_feat"].shape[0]
    emask = (snd >= 0)[:, None]

    h = _block(params["enc_node"], batch["node_feat"])
    e = _block(params["enc_edge"], edge_features(batch, h))

    def step(lp, h, e):
        hs, hr = C.gather_src(h, snd), C.gather_src(h, rcv)
        e_new = _block(lp["edge"], torch.cat([e, hs, hr], -1))
        e = e + torch.where(emask, e_new, 0.0)
        agg = C.segment_sum_pad(e, rcv, n)
        h_new = _block(lp["node"], torch.cat([h, agg], -1))
        return h + h_new, e

    h = run_layers(step, params, cfg, h, e)
    return L.mlp_apply(params["dec"]["mlp"], h)


def loss_fn(params, batch, cfg: MGNConfig):
    return C.readout_loss(apply(params, batch, cfg), batch)
