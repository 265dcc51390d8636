"""The port's MoE slice against the JAX package on the same inputs, on the
CPU: ``moe_apply`` alone (output, aux and load at f32 rtol 1e-5; the
expert choices, kept masks and loads exactly) in the dispatch cases that
change its arithmetic — 1 and 4 groups, a T that 4 does not divide, a
capacity tight enough to drop tokens, ``balance_bias`` with an
``expert_load``, the tied probs of a zero router — its gradients against
``jax.grad``, and the two MoE archs end to end (``forward``,
``prefill_step``, ``decode_step_inplace`` and ``LMServer``'s tokens) at
their smoke configs with the JAX params carried across, at
tests/test_models_lm.py's tolerance."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.launch import serve as JSERVE
from repro.models import moe as JM
from repro.models import transformer as JT
from repro_torch.configs import ARCHS, get_arch
from repro_torch.launch import serve
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import transformer as T

MOE = ["moonshot-v1-16b-a3b", "llama4-scout-17b-a16e"]
RTOL = 1e-5                # f32, one framework's sums against the other's
TOL = 2e-4                 # tests/test_models_lm.py's decode tolerance
PROMPT, S_MAX = 12, 16     # longer than llama4-smoke's window of 8
D, F = 16, 32

# (name, MoEConfig overrides, T as (B, S)): groups 1 and 4, a T = 30 that 4
# does not divide (g = gcd(30, 4) = 2), a capacity that drops tokens, the
# load-bias router, and a top-1 config
CASES = [
    ("global", {}, (2, 16)),
    ("groups4", {"dispatch_groups": 4}, (2, 16)),
    ("groups4_t30", {"dispatch_groups": 4}, (3, 10)),
    ("tight", {"capacity_factor": 0.3}, (2, 16)),
    ("tight_groups4", {"capacity_factor": 0.5, "dispatch_groups": 4}, (2, 16)),
    ("balance_bias", {"balance_bias": 0.5}, (2, 16)),
    ("top1", {"top_k": 1, "n_experts": 4}, (1, 9)),
]


def _cfgs(over: dict):
    kw = dict(n_experts=8, top_k=2, d_ff_expert=F)
    kw.update(over)
    return JM.MoEConfig(**kw), M.MoEConfig(**kw)


def _inputs(cfg, bs, seed, *, zero_router=False):
    rng = np.random.default_rng(seed)
    e = cfg.n_experts
    p = {"router": rng.standard_normal((D, e)).astype(np.float32) * 0.5,
         "wi": rng.standard_normal((e, D, F)).astype(np.float32) * D ** -0.5,
         "wg": rng.standard_normal((e, D, F)).astype(np.float32) * D ** -0.5,
         "wo": rng.standard_normal((e, F, D)).astype(np.float32) * F ** -0.5}
    if zero_router:
        p["router"][:] = 0
    x = rng.standard_normal((*bs, D)).astype(np.float32)
    load = rng.integers(0, 12, e).astype(np.float32)
    load[0] = 40.0                                   # one hot expert
    return p, x, load


def _jax_choices(monkeypatch, fn):
    """Run ``fn`` with ``jax.lax.top_k`` recorded: the reference's own
    (gate, expert) choices."""
    seen = []
    top_k = jax.lax.top_k

    def rec(x, k):
        out = top_k(x, k)
        seen.append(out)
        return out

    monkeypatch.setattr(jax.lax, "top_k", rec)
    out = fn()
    monkeypatch.setattr(jax.lax, "top_k", top_k)
    assert len(seen) == 1
    return out, np.asarray(seen[0][1])


def _keep_np(expert: np.ndarray, t: int, cfg) -> np.ndarray:
    """The kept mask from the definition: a (token, choice) is kept if
    fewer than ``cap`` earlier choices of its group (token-major) took its
    expert."""
    import math
    g = max(1, math.gcd(t, max(1, cfg.dispatch_groups)))
    tg = t // g
    cap = int(cfg.capacity_factor * tg * cfg.top_k / cfg.n_experts) + 1
    fe = expert.reshape(g, tg * cfg.top_k)
    keep = np.zeros(fe.shape, bool)
    for gi in range(g):
        seen = np.zeros(cfg.n_experts, np.int64)
        for j, ex in enumerate(fe[gi]):
            keep[gi, j] = seen[ex] < cap
            seen[ex] += 1
    return keep


def _apply_both(monkeypatch, jcfg, cfg, p, x, load, use_load):
    jload = jnp.asarray(load) if use_load else None
    (jy, jaux, jl), jexpert = _jax_choices(monkeypatch, lambda: JM.moe_apply(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), jcfg,
        expert_load=jload))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    tl = torch.from_numpy(load) if use_load else None
    y, aux, got_load = M.moe_apply(tp, torch.from_numpy(x), cfg,
                                   expert_load=tl)
    return (jy, jaux, jl, jexpert), (y, aux, got_load, tp, tl)


@pytest.mark.parametrize("name,over,bs", CASES, ids=[c[0] for c in CASES])
def test_moe_apply_matches_jax(monkeypatch, name, over, bs):
    jcfg, cfg = _cfgs(over)
    p, x, load = _inputs(cfg, bs, seed=len(name))
    use_load = name == "balance_bias"
    (jy, jaux, jl, jexpert), (y, aux, got_load, tp, tl) = _apply_both(
        monkeypatch, jcfg, cfg, p, x, load, use_load)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=RTOL,
                               atol=RTOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=RTOL)
    assert got_load.dtype == torch.float32
    np.testing.assert_array_equal(got_load.numpy(), np.asarray(jl))
    t = bs[0] * bs[1]
    _, _, expert = M.route(tp, torch.from_numpy(x).reshape(t, D), cfg, tl)
    np.testing.assert_array_equal(expert.numpy(), jexpert)
    keep = M.dispatch_plan(expert, t, cfg).keep
    want_keep = _keep_np(jexpert, t, cfg)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    assert got_load.sum() == want_keep.sum()
    if name.startswith("tight"):
        assert not want_keep.all()                   # tokens were dropped
    if use_load:   # the bias moved the choices away from the hot expert
        _, _, plain = M.route(tp, torch.from_numpy(x).reshape(t, D), cfg)
        assert (expert == 0).sum() < (plain == 0).sum()


def test_moe_zero_router_ties_take_the_lower_expert(monkeypatch):
    """A zero router gives every expert the same prob: jax.lax.top_k
    takes the lowest indices in order, and so must the port, down to the
    capacity drops that follow (every token picks experts 0 and 1)."""
    jcfg, cfg = _cfgs({})
    p, x, load = _inputs(cfg, (2, 16), seed=7, zero_router=True)
    (jy, jaux, jl, jexpert), (y, aux, got_load, tp, _) = _apply_both(
        monkeypatch, jcfg, cfg, p, x, load, False)
    assert (jexpert == np.arange(2)).all()
    _, gate, expert = M.route(tp, torch.from_numpy(x).reshape(32, D), cfg)
    np.testing.assert_array_equal(expert.numpy(), jexpert)
    assert torch.equal(gate, torch.full((32, 2), 0.5))
    np.testing.assert_array_equal(got_load.numpy(), np.asarray(jl))
    assert float(got_load[0]) == int(1.25 * 32 * 2 / 8) + 1   # the capacity
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=RTOL,
                               atol=RTOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=RTOL)


@pytest.mark.parametrize("name,over,bs", [CASES[0], CASES[2], CASES[3]],
                         ids=["global", "groups4_t30", "tight"])
def test_moe_grads_match_jax(name, over, bs):
    """d(Σ y·r + aux) for the four leaves and x against jax.grad."""
    jcfg, cfg = _cfgs(over)
    p, x, _ = _inputs(cfg, bs, seed=11 + len(name))
    r = np.random.default_rng(5).standard_normal((*bs, D)).astype(np.float32)

    def jloss(p, x):
        y, aux, _ = JM.moe_apply(p, x, jcfg)
        return jnp.sum(y * r) + aux

    jg = jax.grad(jloss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    y, aux, _ = M.moe_apply(tp, tx, cfg)
    (torch.sum(y * torch.from_numpy(r)) + aux).backward()
    for k in p:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jg[0][k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
        assert float(tp[k].grad.abs().sum()) > 0, k
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg[1]), rtol=1e-4,
                               atol=1e-5)


def test_moe_init_layout_and_scales():
    _, cfg = _cfgs({})
    p = M.moe_init(torch.Generator().manual_seed(0), 64, cfg, torch.bfloat16,
                   device="cpu")
    jp = JM.moe_init(jax.random.PRNGKey(0), 64, _cfgs({})[0], jnp.bfloat16)
    for k in jp:
        assert tuple(p[k].shape) == jp[k].shape, k
        assert str(p[k].dtype).split(".")[1] == str(jp[k].dtype), k
    assert abs(float(p["wi"].float().std()) * 8 - 1) < 0.05
    assert abs(float(p["wo"].float().std()) * F ** 0.5 - 1) < 0.05


# ---------------------------------------------------------------------------
# the MoE archs end to end
# ---------------------------------------------------------------------------

def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)) \
        .astype(np.int32)


@pytest.fixture(scope="module", params=MOE)
def carried(request):
    """(arch id, JAX config, JAX params, port config, port params)."""
    jcfg = JARCHS[request.param].smoke_config
    cfg = ARCHS[request.param].smoke_config
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    params = T.params_from_jax(_np(jparams), cfg, device="cpu")
    return request.param, jcfg, jparams, cfg, params


@pytest.mark.parametrize("arch_id", MOE)
def test_moe_configs_match_jax(arch_id):
    jarch, arch = JARCHS[arch_id], get_arch(arch_id)
    assert (arch.arch_id, arch.family, arch.source, arch.skip_shapes) == \
        (jarch.arch_id, jarch.family, jarch.source, jarch.skip_shapes)
    for a, b in ((arch.config, jarch.config),
                 (arch.smoke_config, jarch.smoke_config)):
        assert set(vars(b)) - set(vars(a)) == {
            "remat", "act_pspec", "kv_pspec", "kv_chunk"}
        assert vars(a.moe) == vars(b.moe)
        assert {k: v for k, v in vars(a).items() if k != "moe"} == \
            {k: v for k, v in vars(b).items() if k in vars(a) and k != "moe"}
        np.testing.assert_array_equal(a.windows, b.windows)
        assert a.param_count() == b.param_count()
        assert a.active_param_count() == b.active_param_count()
    if arch_id == "moonshot-v1-16b-a3b":
        assert arch.config.param_count() == 28_057_995_264
        assert arch.config.torch_dtype == torch.bfloat16


def test_moe_params_carry_across(carried):
    _, _, jparams, cfg, params = carried
    got = {k: (tuple(t.shape), t.dtype) for k, t in L.leaves(params)}
    assert got == T.param_specs(cfg)
    assert "layers/moe/router" in got and "layers/mlp/wi" not in got
    own = T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    assert {k: (tuple(t.shape), t.dtype) for k, t in L.leaves(own)} == got
    bf16 = T.init_params(dataclasses.replace(cfg, dtype="bfloat16"),
                         generator=torch.Generator().manual_seed(0),
                         device="cpu")
    assert bf16["layers"]["moe"]["router"].dtype == torch.float32
    assert bf16["layers"]["moe"]["wi"].dtype == torch.bfloat16


def test_moe_forward_matches_jax(carried):
    _, jcfg, jparams, cfg, params = carried
    toks = _tokens(cfg, 2, PROMPT, seed=1)
    want, jaux = JT.forward(jparams, toks, jcfg)
    got, aux = T.forward(params, torch.from_numpy(toks), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    assert float(aux) > 0


def test_moe_prefill_and_inplace_decode_match_jax(carried):
    _, jcfg, jparams, cfg, params = carried
    toks = _tokens(cfg, 2, PROMPT, seed=2)
    jlogits, jck, jcv = JT.prefill_step(jparams, toks, jcfg)
    logits, ck, cv = T.prefill_step(params, torch.from_numpy(toks), cfg)
    for got, want in ((logits, jlogits), (ck, jck), (cv, jcv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL)
    pad = ((0, 0), (0, 0), (0, S_MAX - PROMPT), (0, 0), (0, 0))
    jck, jcv = jnp.pad(jck, pad), jnp.pad(jcv, pad)
    ck = torch.from_numpy(np.array(jck))
    cv = torch.from_numpy(np.array(jcv))
    nxt = _tokens(cfg, 2, 3, seed=3)
    for step in range(3):
        jlogits, jck, jcv = JT.decode_step_inplace(
            jparams, nxt[:, step:step + 1], jck, jcv,
            jnp.int32(PROMPT + step), jcfg)
        logits, ck2, cv2 = T.decode_step_inplace(
            params, torch.from_numpy(nxt[:, step:step + 1]), ck, cv,
            PROMPT + step, cfg)
        assert ck2 is ck and cv2 is cv
        for got, want in ((logits, jlogits), (ck, jck), (cv, jcv)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=TOL, atol=TOL)


def test_moe_lm_server_matches_jax(carried):
    """serve_lm's schedule — 8 requests, 4 slots — through both servers:
    the same tokens (every decode step runs all 4 slots, idle ones
    included, at a capacity of int(1.25 * 4 * k / E) + 1 a slot's worth of
    choices: 2 at moonshot-smoke's, 2 at llama4-smoke's)."""
    _, jcfg, jparams, cfg, params = carried
    kw = dict(requests=8, prompt_len=PROMPT, gen=6)
    max_len = PROMPT + kw["gen"] + 1
    want = serve.serve_requests(
        JSERVE.LMServer(jparams, jcfg, slots=4, max_len=max_len),
        rng=np.random.default_rng(0), **kw)
    server = serve.LMServer(params, cfg, slots=4, max_len=max_len)
    got = serve.serve_requests(server, rng=np.random.default_rng(0), **kw)
    assert sorted(got) == list(range(8))
    assert all(len(v) == kw["gen"] for v in got.values())
    assert got == want


def test_moe_decode_capacity_counts_idle_slots():
    """A 4-slot decode step at moonshot's full routing (64 experts, top 6)
    has capacity int(1.25 * 4 * 6 / 64) + 1 = 1: the second choice of an
    expert in the step is dropped, whether its token is a live slot's or
    an idle slot's stale one, and goes to the spill row 64."""
    cfg = ARCHS["moonshot-v1-16b-a3b"].config.moe
    expert = torch.tensor([[0, 1, 2, 3, 4, 5], [0, 6, 7, 8, 9, 10],
                           [6, 11, 12, 13, 14, 15], [16, 17, 18, 19, 20, 1]])
    plan = M.dispatch_plan(expert, 4, cfg)
    _, cap, pos, keep, idx_e, idx_c = plan
    load = M.kept_load(plan, cfg)
    assert cap == 1 and load.sum() == 21 and int(load.max()) == 1
    dropped = {6, 12, 23}                     # (token, choice) 1,0  2,0  3,5
    assert [j for j in range(24) if not keep[0, j]] == sorted(dropped)
    assert [int(idx_e[0, j]) for j in sorted(dropped)] == [64] * 3
    assert int(idx_c.max()) == 0
    assert int(pos[0, 23]) == 1 and int((load > 0).sum()) == 21
