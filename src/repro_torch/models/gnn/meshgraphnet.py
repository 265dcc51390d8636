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


def edge_features(batch: dict, like, g):
    """The mesh edge features on graph ``g``: relative position and length
    where the batch has positions, else ones."""
    if "edge_feat" in batch:
        return batch["edge_feat"]
    snd = batch["senders"]
    if "positions" in batch:
        vec, dist, _ = C.edge_vectors(batch["positions"], snd,
                                      batch["receivers"], g)
        return g.map(lambda v, d: torch.cat([v, d[:, None]], dim=-1), vec,
                     dist)
    return g.map(lambda s, x: torch.ones(tuple(s.shape) + (4,),
                                         dtype=x.dtype, device=x.device),
                 snd, like)


def run_layers(step, params, cfg: MGNConfig, h, e, g):
    """The processor on graph ``g``: ``step(lp, h, e) -> (h, e)`` over the
    stacked layers, each under ``checkpoint`` when ``cfg.remat`` and
    autograd records."""
    for i in range(cfg.n_layers):
        lp = g.map(lambda p: L.layer_slice(p["proc"], i), params)
        if cfg.remat and torch.is_grad_enabled():
            h, e = checkpoint(step, lp, h, e, use_reentrant=False)
        else:
            h, e = step(lp, h, e)
    return h


def _edge_update(lp, e, hs, hr, emask):
    e_new = _block(lp["edge"], torch.cat([e, hs, hr], -1))
    return e + torch.where(emask, e_new, 0.0)


def _node_update(lp, h, agg):
    return h + _block(lp["node"], torch.cat([h, agg], -1))


def apply(params, batch, cfg: MGNConfig, graph=None):
    """→ node outputs (N, out_dim). ``graph``: ``common.Local`` of the
    batch's nodes by default, or the mesh program's."""
    g = graph or C.Local(batch["node_feat"].shape[0])
    snd, rcv = batch["senders"], batch["receivers"]
    emask = g.map(lambda s: (s >= 0)[:, None], snd)

    h = g.map(lambda p, x: _block(p["enc_node"], x), params,
              batch["node_feat"])
    e = g.map(lambda p, x: _block(p["enc_edge"], x), params,
              edge_features(batch, h, g))

    def step(lp, h, e):
        hs, hr = g.gather(h, snd, rcv)
        e = g.map(_edge_update, lp, e, hs, hr, emask)
        agg = g.sum(e, rcv)
        return g.map(_node_update, lp, h, agg), e

    h = run_layers(step, params, cfg, h, e, g)
    return g.map(lambda p, x: L.mlp_apply(p["dec"]["mlp"], x), params, h)


def loss_fn(params, batch, cfg: MGNConfig, graph=None):
    g = graph or C.Local(batch["node_feat"].shape[0])
    return g.loss(apply(params, batch, cfg, g), batch)
