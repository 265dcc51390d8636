"""Error-feedback int8 gradient compression for the data-parallel
all-reduce (the port's copy of ``repro.optim.compression``).

int8 with a per-tensor scale cuts the all-reduce's bytes 4× against f32
(2× against bf16); error feedback keeps the quantisation bias out of the
long-run trajectory (Karimireddy et al., arXiv:1901.09847).

JAX runs ``compressed_allreduce_grads`` inside ``shard_map`` with a
``psum`` over ``axis_name``. The port drives a mesh from one process
(``launch.mesh``), so here it takes one gradient tree per entry of the
mesh axis, each on its entry's device, and returns one ``(mean_grads,
new_err)`` pair per rank. The int8 payloads cross to the axis' first
entry, are upcast to int32 and summed in rank order, as are the scales;
each rank gets the mean back on its own device. The arithmetic is JAX's
op for op: ``jnp.round`` and ``torch.round`` both round half to even, and
every division is by a tensor (CUDA folds a Python-scalar divisor into a
reciprocal multiply, which rounds differently). The residual ``gf - q *
scale`` rounds the product first, as eager JAX does; a jitted JAX step
contracts it into one fused multiply-add, so there the residual differs
by at most half an f32 ulp of ``q * scale`` (the means and ``q`` do not).
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.launch.mesh import Mesh, tree_map


def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), value, dtype=torch.float32, device=like.device)


def int8_compress(x: torch.Tensor):
    scale = torch.clamp(x.abs().amax(), min=1e-12) / _const(127.0, x)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def init_error_feedback(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _allreduce_leaf(gs: Sequence[torch.Tensor], es: Sequence[torch.Tensor]):
    """One leaf over the ranks: each rank's (mean, new_err), the mean on
    the rank's device."""
    lead = gs[0].device
    qs, scales, new_es = [], [], []
    for g, e in zip(gs, es):
        gf = g.to(torch.float32) + e
        q, scale = int8_compress(gf)
        new_es.append(gf - int8_decompress(q, scale))
        qs.append(q)
        scales.append(scale)
    tot = qs[0].to(torch.int32)
    tot_scale = scales[0]
    for q, scale in zip(qs[1:], scales[1:]):
        tot = tot + q.to(lead).to(torch.int32)
        tot_scale = tot_scale + scale.to(lead)
    n = _const(float(len(gs)), tot_scale)
    # per-rank scales differ: decode with the mean scale (bias captured
    # by error feedback next step)
    mean = (tot.to(torch.float32) * (tot_scale / n) / n).to(gs[0].dtype)
    # a rank's mean is its own tensor, also where ranks share a device
    return [(mean if r == 0 else mean.to(g.device, copy=True), e)
            for r, (g, e) in enumerate(zip(gs, new_es))]


def compressed_allreduce_grads(grads: Sequence, err: Sequence, mesh: Mesh,
                               axis_name: str) -> list:
    """Quantise (grad + error) on each rank, all-reduce the
    int32-accumulated int8 payloads, keep each rank's residual.

    ``grads`` and ``err`` hold one tree a rank of ``mesh``'s axis
    ``axis_name``, rank ``i``'s leaves on ``mesh.axis_devices(axis_name)
    [i]`` (a leaf elsewhere raises). Returns one ``(mean_grads, new_err)``
    pair a rank, on the rank's device."""
    devices = mesh.axis_devices(axis_name)
    if not len(grads) == len(err) == len(devices):
        raise ValueError(
            f"compressed_allreduce_grads: {len(grads)} gradient trees and "
            f"{len(err)} error trees for the {len(devices)} ranks of mesh "
            f"axis {axis_name!r}")
    R = len(devices)

    def leaf(*xs):
        for i, x in enumerate(xs):
            dev = torch.device(devices[i % R])
            if x.device != dev:
                raise ValueError(
                    f"rank {i % R} of mesh axis {axis_name!r} lives on "
                    f"{dev}, but holds a leaf on {x.device}")
        return _allreduce_leaf(xs[:R], xs[R:])

    # leaves are matched by key, in every rank's tree and error tree
    out = tree_map(leaf, grads[0], *grads[1:], *err)
    return [tuple(tree_map(lambda _, o: o[r][j], grads[0], out)
                  for j in (0, 1)) for r in range(R)]
