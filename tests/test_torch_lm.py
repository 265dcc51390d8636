"""The port's LM serving slice against the JAX package on the same inputs:
the configs, the layers, ``forward`` / ``prefill_step`` /
``decode_step_inplace`` for the three dense smoke configs with the JAX
params carried across (at tests/test_models_lm.py's tolerance), and
``LMServer`` on ``serve_lm``'s schedule emitting the same tokens as JAX's.
Every check runs on the CPU, where the attention wrapper runs its plain
version; the kernel path on the card is in tests/test_torch_gpu.py and
``chip_smoke.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.launch import serve as JSERVE
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs import ARCHS, get_arch
from repro_torch.launch import serve
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

DENSE = ["gemma2-9b", "phi3-mini-3.8b", "deepseek-coder-33b"]
TOL = 2e-4                 # tests/test_models_lm.py's decode tolerance
PROMPT, S_MAX = 12, 16     # longer than gemma2-smoke's window of 8


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=DENSE)
def carried(request):
    """(arch id, JAX config, JAX params, port config, port params)."""
    jcfg = JARCHS[request.param].smoke_config
    cfg = ARCHS[request.param].smoke_config
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    params = T.params_from_jax(_np(jparams), cfg, device="cpu")
    return request.param, jcfg, jparams, cfg, params


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)) \
        .astype(np.int32)


@pytest.mark.parametrize("arch_id", DENSE)
def test_configs_match_jax(arch_id):
    jarch, arch = JARCHS[arch_id], get_arch(arch_id)
    assert (arch.arch_id, arch.family, arch.source, arch.skip_shapes) == \
        (jarch.arch_id, jarch.family, jarch.source, jarch.skip_shapes)
    for a, b in ((arch.config, jarch.config),
                 (arch.smoke_config, jarch.smoke_config)):
        # every field but the four that steer XLA
        assert set(vars(b)) - set(vars(a)) == {
            "remat", "act_pspec", "kv_pspec", "kv_chunk"}
        assert vars(a) == {k: v for k, v in vars(b).items() if k in vars(a)}
        np.testing.assert_array_equal(a.windows, b.windows)
        assert a.param_count() == b.param_count()
    if arch_id == "gemma2-9b":
        assert arch.config.param_count() == 9_241_404_928
        assert arch.config.torch_dtype == torch.bfloat16


def test_moe_and_gnn_archs_raise():
    """No arch raises any more: every one of the JAX package's archs, the
    MoE LMs and the GNNs (A18.5) included, is registered with the JAX
    package's configs; an MoE LM takes an MoE config and has a loss."""
    for arch_id, jarch in JARCHS.items():
        arch = get_arch(arch_id)
        assert arch.arch_id == arch_id and arch.family == jarch.family
        if jarch.family == "gnn":
            for a, b in ((arch.config, jarch.config),
                         (arch.smoke_config, jarch.smoke_config)):
                assert dataclasses.asdict(a) == dataclasses.asdict(b)
            assert arch.gnn_inputs == jarch.gnn_inputs
    moe = ARCHS["moonshot-v1-16b-a3b"].smoke_config.moe
    cfg = T.LMConfig(name="m", n_layers=1, d_model=8, n_heads=1, n_kv_heads=1,
                     head_dim=8, d_ff=8, vocab=8, moe=moe, dtype="float32")
    assert cfg.param_count() == 8 * 8 * 4 + 8 * 8 + 3 * 8 * 8 * 64 + 16 \
        + 2 * 8 * 8 + 8
    params = T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    toks = torch.zeros((1, 4), dtype=torch.int32)
    loss, metrics = T.loss_fn(params, {"tokens": toks, "labels": toks}, cfg)
    assert torch.isfinite(loss) and float(metrics["aux"]) > 0


def test_layers_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 6, 3, 16)).astype(np.float32)
    g = rng.standard_normal(16).astype(np.float32)
    pos = np.broadcast_to(np.arange(3, 9)[None], (2, 6)).astype(np.int32)
    np.testing.assert_allclose(
        L.rmsnorm({"g": torch.from_numpy(g)}, torch.from_numpy(x)).numpy(),
        np.asarray(JL.rmsnorm({"g": g}, x)), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        L.rope(torch.from_numpy(x), torch.from_numpy(pos), 500.0).numpy(),
        np.asarray(JL.rope(x, pos, 500.0)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(L.gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.gelu(x)), rtol=1e-6,
                               atol=1e-6)
    # bf16 in: f32 inside, bf16 out
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert L.rmsnorm({"g": torch.from_numpy(g)}, xb).dtype == torch.bfloat16
    assert L.rope(xb, torch.from_numpy(pos)).dtype == torch.bfloat16


def test_init_params_layout_matches_jax(carried):
    """The port's own random params have the JAX layout and dtypes (norm
    gains f32), and the JAX scales."""
    _, jcfg, jparams, cfg, _ = carried
    params = T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    got = {k: (tuple(t.shape), t.dtype) for k, t in L.leaves(params)}
    want = {k: (tuple(np.shape(a)), torch.float32)
            for k, a in L.leaves(_np(jparams))}
    assert got == want == T.param_specs(cfg)
    std = float(params["layers"]["attn"]["wq"].std())
    assert abs(std * cfg.d_model ** 0.5 - 1) < 0.1
    assert torch.equal(params["ln_f"]["g"], torch.ones(cfg.d_model))
    bf16 = T.init_params(dataclasses.replace(cfg, dtype="bfloat16"),
                         generator=torch.Generator().manual_seed(0),
                         device="cpu")
    assert bf16["embed"].dtype == torch.bfloat16
    assert bf16["layers"]["ln1"]["g"].dtype == torch.float32


def test_params_from_jax_rejects_another_config(carried):
    _, _, jparams, cfg, _ = carried
    other = dataclasses.replace(cfg, d_ff=cfg.d_ff + 8)
    with pytest.raises(ValueError, match="do not fit"):
        T.params_from_jax(_np(jparams), other, device="cpu")


def test_forward_matches_jax(carried):
    _, jcfg, jparams, cfg, params = carried
    toks = _tokens(cfg, 2, PROMPT, seed=1)
    want, _ = JT.forward(jparams, toks, jcfg)
    got, aux = T.forward(params, torch.from_numpy(toks), cfg)
    # no cache collected: the summed MoE aux loss, 0 for a dense model
    assert float(aux) == 0.0 and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_prefill_and_inplace_decode_match_jax(carried):
    _, jcfg, jparams, cfg, params = carried
    toks = _tokens(cfg, 2, PROMPT, seed=2)
    jlogits, jck, jcv = JT.prefill_step(jparams, toks, jcfg)
    logits, ck, cv = T.prefill_step(params, torch.from_numpy(toks), cfg)
    for got, want in ((logits, jlogits), (ck, jck), (cv, jcv)):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL)
    # decode two steps in place into a preallocated S_MAX-slot cache
    pad = ((0, 0), (0, 0), (0, S_MAX - PROMPT), (0, 0), (0, 0))
    jck, jcv = jnp.pad(jck, pad), jnp.pad(jcv, pad)
    ck = torch.from_numpy(np.array(jck))
    cv = torch.from_numpy(np.array(jcv))
    nxt = _tokens(cfg, 2, 2, seed=3)
    for step in range(2):
        jlogits, jck, jcv = JT.decode_step_inplace(
            jparams, nxt[:, step:step + 1], jck, jcv,
            jnp.int32(PROMPT + step), jcfg)
        logits, ck2, cv2 = T.decode_step_inplace(
            params, torch.from_numpy(nxt[:, step:step + 1]), ck, cv,
            PROMPT + step, cfg)
        assert ck2 is ck and cv2 is cv                 # written in place
        for got, want in ((logits, jlogits), (ck, jck), (cv, jcv)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=TOL, atol=TOL)


def test_prefill_decode_consistency(carried):
    """prefill + in-place decode == full forward at the next position
    (tests/test_models_lm.py's check, in the port)."""
    _, _, _, cfg, params = carried
    toks = torch.from_numpy(_tokens(cfg, 2, PROMPT + 1, seed=4))
    _, ck, cv = T.prefill_step(params, toks[:, :-1], cfg)
    pad = (0, 0, 0, 0, 0, S_MAX - PROMPT)
    ck = torch.nn.functional.pad(ck, pad)
    cv = torch.nn.functional.pad(cv, pad)
    dec, _, _ = T.decode_step_inplace(params, toks[:, -1:], ck, cv, PROMPT,
                                      cfg)
    full, _ = T.forward(params, toks, cfg)
    torch.testing.assert_close(dec, full[:, -1], rtol=TOL, atol=TOL)
    # the plain path (use_kernel=False, query-chunked) agrees too
    chunked = dataclasses.replace(cfg, attn_chunk=4)
    plain, _ = T.forward(params, toks, chunked, use_kernel=False)
    torch.testing.assert_close(plain, full, rtol=TOL, atol=TOL)


def _record_margins(monkeypatch, server, margins):
    """Wrap the port's prefill and decode steps to record, for every token
    the server emits, the gap between its top-1 and top-2 logits."""
    prefill, decode = T.prefill_step, T.decode_step_inplace

    def top2_gap(rows):
        top = torch.topk(rows, 2, dim=-1).values
        return (top[:, 0] - top[:, 1]).tolist()

    def prefill_rec(*a, **kw):
        out = prefill(*a, **kw)
        margins.extend(top2_gap(out[0]))
        return out

    def decode_rec(*a, **kw):
        out = decode(*a, **kw)
        margins.extend(top2_gap(out[0][torch.from_numpy(server.active)]))
        return out

    monkeypatch.setattr(T, "prefill_step", prefill_rec)
    monkeypatch.setattr(T, "decode_step_inplace", decode_rec)


def test_lm_server_matches_jax(carried, monkeypatch):
    """serve_lm's schedule — 8 requests, 4 slots, equal prompt lengths —
    through the JAX server and the port's, the same params and prompts:
    the same tokens, every one of them chosen by a top-1 margin wider than
    twice the logit tolerance (so no near-tie decides a token)."""
    _, jcfg, jparams, cfg, params = carried
    kw = dict(requests=8, prompt_len=PROMPT, gen=6)
    max_len = PROMPT + kw["gen"] + 1
    want = serve.serve_requests(
        JSERVE.LMServer(jparams, jcfg, slots=4, max_len=max_len),
        rng=np.random.default_rng(0), **kw)
    server = serve.LMServer(params, cfg, slots=4, max_len=max_len)
    margins = []
    _record_margins(monkeypatch, server, margins)
    got = serve.serve_requests(server, rng=np.random.default_rng(0), **kw)
    assert sorted(got) == list(range(8))
    assert got == want
    assert all(len(v) == kw["gen"] for v in got.values())
    assert len(margins) == sum(len(v) for v in got.values())
    assert min(margins) > 2 * TOL


def test_serve_cli_runs_lm_on_the_cpu(capsys):
    assert serve.main(["--arch", "gemma2-9b", "--device", "cpu",
                       "--prompt-len", "12", "--gen", "3"]) == 0
    assert "served 8 requests, 24 tokens" in capsys.readouterr().out
