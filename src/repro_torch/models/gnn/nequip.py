"""NequIP [arXiv:2101.03164] (the port's copy of
``repro.models.gnn.nequip``): E(3)-equivariant interatomic potential.

Assigned config: 5 layers, 32 channels, l_max=2, 8 bessel RBFs, cutoff 5.
Features are irrep channel stacks {l: (N, C, 2l+1)}; each convolution
couples features with spherical harmonics of edge unit vectors through
Clebsch–Gordan tensors (``so3``), modulated by a radial MLP per path,
aggregated with segment-sum, mixed channel-wise per l, and gated (scalar
silu / norm gate for l>0).

The norm gate's norm is ``sqrt(sum(x * x))``, whose gradient at a zero
vector is 0/0 = NaN, as ``jnp.linalg.norm``'s is in the JAX package
(``torch.linalg.vector_norm`` would give 0 there). An l > 0 channel of a
node that no message reaches is such a vector, so a batch with an
isolated node gives non-finite gradients in both packages (ROADMAP C).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.core.state import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.gnn import common as C
from repro_torch.models.gnn import so3


@dataclasses.dataclass(frozen=True)
class NequIPConfig:
    name: str = "nequip"
    n_layers: int = 5
    channels: int = 32
    l_max: int = 2
    n_rbf: int = 8
    cutoff: float = 5.0
    n_species: int = 100
    out_dim: int = 1


def init_params(cfg: NequIPConfig, *, generator: torch.Generator,
                device=None) -> dict:
    """Random f32 params on ``device`` (None: the CUDA card) from
    ``generator``, which must live on that device."""
    dev = resolve_device(device)
    paths = so3.paths(cfg.l_max)
    c = cfg.channels

    def layer_init(_):
        p = {"radial": L.mlp_init(generator, [cfg.n_rbf, 32, len(paths) * c],
                                  device=dev)}
        for l in range(cfg.l_max + 1):
            n_in = sum(1 for (_, _, l3) in paths if l3 == l)
            p[f"mix{l}"] = (torch.randn((n_in * c, c), generator=generator,
                                        device=dev) * (n_in * c) ** -0.5)
        return p

    return {
        "embed": torch.randn((cfg.n_species, c), generator=generator,
                             device=dev) * 0.5,
        "layers": L.stack_layer_params(layer_init, cfg.n_layers),
        "head": L.mlp_init(generator, [c, 32, cfg.out_dim], device=dev),
    }


def param_specs(cfg: NequIPConfig) -> dict:
    return C.leaf_specs(init_params(cfg, generator=torch.Generator(),
                                    device="cpu"))


def params_from_jax(np_params: dict, cfg: NequIPConfig, *, device) -> dict:
    return L.params_from_numpy(np_params, param_specs(cfg), cfg.name,
                               resolve_device(device))


def spherical_harmonics(unit, l_max: int) -> dict:
    """{l: (E, 2l+1)} real spherical harmonics of the edge unit vectors,
    ``so3.sh_np``'s polynomials."""
    x, y, z = unit[:, 0], unit[:, 1], unit[:, 2]
    s3 = math.sqrt(3.0)
    sh = {0: torch.ones((unit.shape[0], 1), dtype=unit.dtype,
                        device=unit.device)}
    if l_max >= 1:
        sh[1] = torch.stack([y, z, x], dim=-1)
    if l_max >= 2:
        sh[2] = torch.stack([
            s3 * x * y, s3 * y * z, 0.5 * (3 * z**2 - 1.0),
            s3 * x * z, 0.5 * s3 * (x**2 - y**2)], dim=-1)
    return sh


def apply(params, batch, cfg: NequIPConfig):
    """→ per-node invariant outputs (N, out_dim)."""
    snd, rcv = batch["senders"], batch["receivers"]
    n = batch["species"].shape[0]
    c = cfg.channels
    paths = so3.paths(cfg.l_max)
    dev, dt = snd.device, params["embed"].dtype

    _, dist, unit = C.edge_vectors(batch["positions"], snd, rcv)
    rbf = C.bessel_rbf(dist, cfg.n_rbf, cfg.cutoff)          # (E, R)
    emask = (snd >= 0).to(dt)
    sh = spherical_harmonics(unit, cfg.l_max)
    cg = {p: torch.as_tensor(so3.clebsch_gordan(*p), dtype=dt, device=dev)
          for p in paths}

    feats = {0: params["embed"][batch["species"].long()][..., None]}
    for l in range(1, cfg.l_max + 1):
        feats[l] = torch.zeros((n, c, 2 * l + 1), dtype=dt, device=dev)

    for i in range(cfg.n_layers):
        lp = L.layer_slice(params["layers"], i)
        radial = L.mlp_apply(lp["radial"], rbf, act=F.silu)   # (E, P*c)
        radial = radial.reshape(radial.shape[0], len(paths), c)
        msgs = {l: [] for l in range(cfg.l_max + 1)}
        for pi, (l1, l2, l3) in enumerate(paths):
            xj = C.gather_src(feats[l1], snd)                  # (E,c,2l1+1)
            m = torch.einsum("eci,ej,ijn->ecn", xj, sh[l2], cg[(l1, l2, l3)])
            m = m * radial[:, pi, :, None] * emask[:, None, None]
            msgs[l3].append(C.segment_sum_pad(m, rcv, n))      # (N,c,2l3+1)
        new = {}
        for l in range(cfg.l_max + 1):
            stack = torch.cat(msgs[l], dim=1)                  # (N,P_l*c,d)
            mixed = torch.einsum("npd,pc->ncd", stack, lp[f"mix{l}"])
            if l == 0:
                new[l] = feats[0] + F.silu(mixed)
            else:  # norm gate keeps equivariance
                norm = torch.sqrt(torch.sum(mixed * mixed, dim=-1,
                                            keepdim=True))
                gate = torch.sigmoid(norm - 1.0)
                new[l] = feats[l] + mixed * gate
        feats = new
    return L.mlp_apply(params["head"], feats[0][..., 0], act=F.silu)


def loss_fn(params, batch, cfg: NequIPConfig):
    return C.readout_loss(apply(params, batch, cfg), batch)
