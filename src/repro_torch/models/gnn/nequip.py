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


def _gate(l: int, feat, mixed):
    if l == 0:
        return feat + F.silu(mixed)
    # norm gate keeps equivariance
    norm = torch.sqrt(torch.sum(mixed * mixed, dim=-1, keepdim=True))
    gate = torch.sigmoid(norm - 1.0)
    return feat + mixed * gate


def apply(params, batch, cfg: NequIPConfig, graph=None):
    """→ per-node invariant outputs (N, out_dim)."""
    g = graph or C.Local(batch["species"].shape[0])
    snd, rcv = batch["senders"], batch["receivers"]
    c = cfg.channels
    paths = so3.paths(cfg.l_max)

    _, dist, unit = C.edge_vectors(batch["positions"], snd, rcv, g)
    rbf = g.map(lambda d: C.bessel_rbf(d, cfg.n_rbf, cfg.cutoff),
                dist)                                        # (E, R)
    emask = g.map(lambda s, p: (s >= 0).to(p["embed"].dtype), snd, params)
    sh = g.map(lambda u: spherical_harmonics(u, cfg.l_max), unit)
    cg = g.map(lambda p: {pa: torch.as_tensor(
        so3.clebsch_gordan(*pa), dtype=p["embed"].dtype,
        device=p["embed"].device) for pa in paths}, params)

    feats = {0: g.map(lambda p, s: p["embed"][s.long()][..., None], params,
                      batch["species"])}
    for l in range(1, cfg.l_max + 1):
        feats[l] = g.map(lambda p, s: torch.zeros(
            (s.shape[0], c, 2 * l + 1), dtype=p["embed"].dtype,
            device=s.device), params, batch["species"])

    for i in range(cfg.n_layers):
        lp = g.map(lambda p: L.layer_slice(p["layers"], i), params)
        radial = g.map(lambda p, r: L.mlp_apply(p["radial"], r, act=F.silu)
                       .reshape(r.shape[0], len(paths), c),
                       lp, rbf)                              # (E, P, c)
        # each l1's features read at the senders once, for all its paths
        xj = {l1: g.gather(feats[l1], snd)[0]
              for l1 in sorted({p[0] for p in paths})}       # (E,c,2l1+1)
        msgs = {l: [] for l in range(cfg.l_max + 1)}
        for pi, (l1, l2, l3) in enumerate(paths):
            m = g.map(lambda x, s, cgs, r, em: torch.einsum(
                "eci,ej,ijn->ecn", x, s[l2], cgs[(l1, l2, l3)])
                * r[:, pi, :, None] * em[:, None, None],
                xj[l1], sh, cg, radial, emask)
            msgs[l3].append(g.sum(m, rcv))                   # (N,c,2l3+1)
        feats = {l: g.map(lambda p, f, *ms: _gate(l, f, torch.einsum(
            "npd,pc->ncd", torch.cat(ms, dim=1), p[f"mix{l}"])),
            lp, feats[l], *msgs[l]) for l in range(cfg.l_max + 1)}
    return g.map(lambda p, f: L.mlp_apply(p["head"], f[..., 0], act=F.silu),
                 params, feats[0])


def loss_fn(params, batch, cfg: NequIPConfig, graph=None):
    g = graph or C.Local(batch["species"].shape[0])
    return g.loss(apply(params, batch, cfg, g), batch)
