"""Mixture-of-Experts FFN of the port (the counterpart of
``repro.models.moe``): top-k routing and capacity-based dispatch (GShard
style, scatter formulation — no (T, E, C) one-hot dispatch tensor), in
plain PyTorch ops. The JAX package's program is XLA ops with no Pallas
kernel, so none is written here; the three expert products are batched
matmuls over the experts.

The semantics are the reference's to the index:

* the top k of the router's probs in descending order, the lower expert
  first among equal probs (``jax.lax.top_k``'s order; ``torch.topk``
  promises none, so a stable descending sort takes its place);
* the capacity ``int(capacity_factor * Tg * k / E) + 1`` depends on the
  token count, so a decode step of a few tokens drops the tokens that
  collide on an expert, stale tokens of idle serving slots included;
* a dropped (token, choice) goes to the spill row ``E`` of the dispatch
  buffer, and the combine gathers at ``min(expert, E - 1)`` and multiplies
  by the kept mask and the gate rather than masking, as JAX does (so a
  non-finite expert output turns a dropped row's 0 into a NaN there too).

SDP tie-in: the optional ``balance_bias`` is the paper's balance guard as
an aux-loss-free router bias — experts over the mean load get their logits
pushed down before the top k.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    balance_bias: float = 0.0   # >0 ⇒ SDP-style load-bias routing
    aux_loss_coef: float = 0.01
    dispatch_groups: int = 1    # >1 ⇒ group-local dispatch: per-group
    #   capacity, the running count and the scatter inside each group
    buf_pspec: tuple = ()       # the JAX package's sharding hint for the
    #   dispatch buffer; one device has nothing to shard, so it is kept
    #   for the config's sake and not read


def moe_init(generator: torch.Generator, d_model: int, cfg: MoEConfig,
             dtype=torch.float32, *, device) -> dict:
    """The router f32, the experts in ``dtype``; N(0, 1/d) and, for
    ``wo``, N(0, 1/f), drawn in f32 one leaf at a time."""
    e, f = cfg.n_experts, cfg.d_ff_expert
    s = d_model ** -0.5

    def normal(shape, scale, dt):
        return (torch.randn(shape, generator=generator, device=device)
                * scale).to(dt)

    return {
        "router": normal((d_model, e), s, torch.float32),
        "wi": normal((e, d_model, f), s, dtype),
        "wg": normal((e, d_model, f), s, dtype),
        "wo": normal((e, f, d_model), f ** -0.5, dtype),
    }


def route(p, xf, cfg: MoEConfig, expert_load=None):
    """The router: xf (T, d) → (probs (T, E) f32, gate (T, k) normalised,
    expert (T, k) int64, the top k in ``jax.lax.top_k``'s order)."""
    logits = xf.float() @ p["router"]
    if cfg.balance_bias > 0.0 and expert_load is not None:
        mean = torch.mean(expert_load) + 1e-6
        logits = logits - cfg.balance_bias * (expert_load - mean) / mean
    probs = torch.softmax(logits, dim=-1)
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate = srt.values[:, :cfg.top_k]
    expert = srt.indices[:, :cfg.top_k]
    return probs, gate / torch.sum(gate, dim=-1, keepdim=True), expert


def aux_loss(probs, expert, cfg: MoEConfig):
    """Switch-style load-balancing loss (before capacity): the first
    choice's density times the mean router prob."""
    e = cfg.n_experts
    density = torch.mean(F.one_hot(expert[:, 0], e).float(), dim=0)
    router_mean = torch.mean(probs, dim=0)
    return cfg.aux_loss_coef * e * torch.sum(density * router_mean)


class Plan(NamedTuple):
    """Where each (token, choice) goes, each (G, Tg*k) token-major within
    its group: its running count ``pos`` at its expert, ``keep`` (pos <
    cap), the buffer row ``idx_e`` (the spill row E when dropped) and
    column ``idx_c`` (0 when dropped)."""
    groups: int
    cap: int
    pos: torch.Tensor
    keep: torch.Tensor
    idx_e: torch.Tensor
    idx_c: torch.Tensor


def dispatch_plan(expert, t: int, cfg: MoEConfig) -> Plan:
    """The capacity and positions for expert (T, k)."""
    e, k = cfg.n_experts, cfg.top_k
    # group-local dispatch degrades gracefully for tiny token counts
    # (single-token decode): the largest group count dividing T
    g = max(1, math.gcd(t, max(1, cfg.dispatch_groups)))
    tg = t // g
    cap = int(cfg.capacity_factor * tg * k / e) + 1
    fe = expert.reshape(g, tg * k)
    oh = F.one_hot(fe, e).to(torch.int32)                  # (G, Tg*k, E)
    # the running count: a cumsum over the one-hot along the choices, taken
    # as one flat scan of its expert-major copy, each (group, expert) row
    # then less the total of the rows before it. A scan along the outer
    # dim walks each of the E columns with one thread on the card: 8.8 ms a
    # layer at moonshot's 49,152 choices, where route and dispatch take
    # 1.5 ms with the flat scan (H100 80GB HBM3, 700.00 W)
    oh_t = oh.transpose(1, 2).contiguous()                 # (G, E, Tg*k)
    run = torch.cumsum(oh_t.reshape(-1), 0, dtype=torch.int32) \
        .reshape(oh_t.shape)
    run = run - (run[..., :1] - oh_t[..., :1])
    pos = torch.gather(run, 1, fe[:, None, :])[:, 0] - 1
    keep = pos < cap
    idx_e = torch.where(keep, fe, e)                       # drop row → e
    idx_c = torch.where(keep, pos, 0).long()
    return Plan(g, cap, pos, keep, idx_e, idx_c)


def _group_index(plan: Plan, device):
    g, tgk = plan.idx_e.shape
    return torch.arange(g, device=device)[:, None].expand(g, tgk)


def dispatch(xf, plan: Plan, cfg: MoEConfig):
    """The (G, E, C, d) expert buffer of xf (T, d): each kept (token,
    choice) at its (expert, position). Kept slots are unique, so a write
    into zeros gives the bits of JAX's ``.at[].add``; the spill row E takes
    every dropped row and is cut off."""
    g, tgk = plan.idx_e.shape
    d = xf.shape[1]
    xr = torch.repeat_interleave(xf, cfg.top_k, dim=0).reshape(g, tgk, d)
    buf = torch.zeros((g, cfg.n_experts + 1, plan.cap, d), dtype=xf.dtype,
                      device=xf.device)
    buf = buf.index_put((_group_index(plan, xf.device), plan.idx_e,
                         plan.idx_c), xr)
    return buf[:, :cfg.n_experts]


def experts(p, h):
    """The experts' SwiGLU on their buffer rows: three batched products over
    the experts, (G, E, C, d) → (G, E, C, d)."""
    act = F.silu(torch.einsum("gecd,edf->gecf", h, p["wg"]))
    h = act * torch.einsum("gecd,edf->gecf", h, p["wi"])
    return torch.einsum("gecf,efd->gecd", h, p["wo"])


def combine(out, plan: Plan, gate, cfg: MoEConfig):
    """Each token's gated sum of its choices' expert outputs, (T, d) f32:
    gathered at ``min(idx_e, E - 1)`` and multiplied by ``keep`` and the
    gate rather than masked, as the JAX package does."""
    g, tgk = plan.idx_e.shape
    e, d = cfg.n_experts, out.shape[-1]
    y = out[_group_index(plan, out.device),
            torch.clamp(plan.idx_e, max=e - 1), plan.idx_c]  # (G, Tg*k, d)
    y = y * plan.keep[..., None] * gate.reshape(g, tgk)[..., None]
    return y.reshape(-1, cfg.top_k, d).sum(dim=1)


def kept_load(plan: Plan, cfg: MoEConfig):
    """The kept count per expert, (E,) f32: each choice counted at its
    buffer row, the dropped ones at the spill row E, which is cut off (a
    scatter, so the host never waits for the card's count of them)."""
    rows = plan.idx_e.reshape(-1)
    count = torch.zeros(cfg.n_experts + 1, dtype=torch.int32,
                        device=rows.device)
    count.scatter_add_(0, rows, torch.ones_like(rows, dtype=torch.int32))
    return count[:cfg.n_experts].float()


def moe_apply(p, x, cfg: MoEConfig, *, expert_load=None):
    """x: (B, S, d) → (y (B, S, d), aux_loss, new_expert_load (E,) f32).

    With ``cfg.dispatch_groups`` > 1 the tokens split into G contiguous
    groups, each with its own capacity, running count and scatter."""
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    probs, gate, expert = route(p, xf, cfg, expert_load)
    aux = aux_loss(probs, expert, cfg)
    plan = dispatch_plan(expert, b * s, cfg)
    out = experts(p, dispatch(xf, plan, cfg))
    y = combine(out, plan, gate, cfg).reshape(b, s, d).to(x.dtype)
    return y, aux, kept_load(plan, cfg)
