"""The port's LM training slice against the JAX package on the same inputs,
on the CPU: ``chunked_softmax_xent`` (values and the gradients of x and
the head: with and without a mask, with gemma2's final softcap, a chunk
that divides T and one that does not), ``loss_fn`` (loss, ``xent``,
``aux`` and every param's gradient) for every LM smoke config with the
JAX params carried across, ``launch.train`` on an LM (its losses over a
few steps against JAX's trainer on the same params and batches, and a
checkpoint JAX's trainer wrote resumed by the port's), ``--full``'s
depth-cut config, and ``_lm_flops_fwd``. Tolerances: rtol 1e-5 for the
loss's f32 value, tests/test_recsys.py's rtol 1e-4 / atol 1e-5 for
gradients and for steps of training, where two frameworks' float sums
meet in every layer."""
import dataclasses
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ARCHS, get_arch
from repro_torch.launch import steps, train
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.optim import adamw, linear_warmup_cosine
from repro_torch.optim.optimizers import tree_leaves

LM = [a for a, d in JARCHS.items() if d.family == "lm"]
RTOL, ATOL = 1e-4, 1e-5
MOONSHOT = "moonshot-v1-16b-a3b"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# chunked_softmax_xent
# ---------------------------------------------------------------------------

# (T, chunk): 4 chunks; a T the chunk does not divide (one block); T = chunk
XENT_CASES = [(64, 16), (60, 16), (16, 16)]


@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("t,chunk", XENT_CASES)
def test_chunked_xent_matches_jax(t, chunk, masked, softcap):
    rng = np.random.default_rng(t + chunk)
    d, v = 16, 97
    x = rng.standard_normal((t, d)).astype(np.float32)
    head = rng.standard_normal((d, v)).astype(np.float32) * 2
    labels = rng.integers(0, v, t).astype(np.int32)
    mask = (np.arange(t) % 3 != 0).astype(np.float32) if masked else None
    kw = dict(final_softcap=softcap, chunk=chunk)

    def jloss(x, head):
        return JL.chunked_softmax_xent(
            x, head, jnp.asarray(labels),
            label_mask=None if mask is None else jnp.asarray(mask), **kw)

    want, (jgx, jgh) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(head))
    tx = torch.from_numpy(x).requires_grad_()
    th = torch.from_numpy(head).requires_grad_()
    got = L.chunked_softmax_xent(
        tx, th, torch.from_numpy(labels),
        label_mask=None if mask is None else torch.from_numpy(mask), **kw)
    got.backward()
    got = got.detach()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jgh), rtol=RTOL,
                               atol=ATOL)
    with torch.no_grad():                  # no checkpoint without autograd
        again = L.chunked_softmax_xent(
            tx, th, torch.from_numpy(labels),
            label_mask=None if mask is None else torch.from_numpy(mask),
            **kw)
    assert float(again) == float(got)


def test_chunked_xent_all_masked_is_zero():
    x, head = torch.ones((8, 4)), torch.ones((4, 5))
    labels = torch.zeros(8, dtype=torch.int32)
    for chunk in (4, 3):
        assert float(L.chunked_softmax_xent(
            x, head, labels, label_mask=torch.zeros(8), chunk=chunk)) == 0.0


# ---------------------------------------------------------------------------
# loss_fn for every LM arch
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=LM)
def carried(request):
    """(arch id, JAX config, JAX params, port config, port params)."""
    jcfg = JARCHS[request.param].smoke_config
    cfg = ARCHS[request.param].smoke_config
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    params = T.params_from_jax(_np(jparams), cfg, device="cpu")
    return request.param, jcfg, jparams, cfg, params


def _batch(cfg, b, s, seed, masked):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if masked:
        out["mask"] = (rng.random((b, s)) < 0.7).astype(np.float32)
    return out


# xent_chunk: 8 divides T = 2 x 12 = 24 (three checkpointed chunks); 7 does
# not (one block)
@pytest.mark.parametrize("xent_chunk", [8, 7])
@pytest.mark.parametrize("masked", [False, True])
def test_loss_fn_value_and_grads_match_jax(carried, masked, xent_chunk):
    arch_id, jcfg, jparams, cfg, params = carried
    jcfg = dataclasses.replace(jcfg, xent_chunk=xent_chunk)
    cfg = dataclasses.replace(cfg, xent_chunk=xent_chunk)
    batch = _batch(cfg, 2, 12, seed=xent_chunk, masked=masked)
    (jloss, jm), jgrads = jax.value_and_grad(JT.loss_fn, has_aux=True)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    loss, metrics, grads = steps.value_and_grad(
        T.loss_fn, params, train.batch_tensors(batch, "cpu"), cfg)
    assert loss.shape == () and loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert sorted(metrics) == sorted(jm) == ["aux", "xent"]
    for k in jm:
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    assert (float(metrics["aux"]) > 0) == (cfg.moe is not None)
    got_l, want_l = tree_leaves(grads), jax.tree.leaves(jgrads)
    assert len(got_l) == len(want_l)
    for i, (g, w) in enumerate(zip(got_l, want_l)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=f"{arch_id} leaf {i}")


def test_loss_fn_plain_attention_path_agrees(carried):
    """``use_kernel=False`` (the card's reference) on the CPU: the same
    loss, query-chunked."""
    _, _, _, cfg, params = carried
    batch = train.batch_tensors(_batch(cfg, 2, 12, seed=1, masked=False),
                                "cpu")
    want, _ = T.loss_fn(params, batch, cfg)
    got, _ = T.loss_fn(params, batch, dataclasses.replace(cfg, attn_chunk=4),
                       use_kernel=False)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

class _LossLog:
    """A ``FaultTolerantLoop`` stand-in factory that records every step's
    loss (both trainers call ``loop.run(state, batches, stepper, ...)``)."""

    def __init__(self, loop_cls):
        self.loop_cls, self.losses = loop_cls, []

    def __call__(self, *a, **kw):
        loop = self.loop_cls(*a, **kw)
        run = loop.run

        def logged(state, batches, stepper, **k):
            def rec(state, batch):
                state, metrics = stepper(state, batch)
                self.losses.append(float(metrics["loss"]))
                return state, metrics
            return run(state, batches, rec, **k)

        loop.run = logged
        return loop


def _carry_init(monkeypatch, seed):
    """The port's trainer starts from the JAX trainer's params."""
    def init(cfg, *, generator, device):
        jcfg = JARCHS[MOONSHOT].smoke_config
        return T.params_from_jax(
            _np(JT.init_params(jax.random.PRNGKey(seed), jcfg)), cfg, device)
    monkeypatch.setattr(T, "init_params", init)


COMMON = ["--arch", MOONSHOT, "--batch", "2", "--seq", "16", "--seed", "1"]


def _run_jax(monkeypatch, argv):
    monkeypatch.setattr(sys, "argv", ["train", *argv])
    log = _LossLog(jtrain.FaultTolerantLoop)
    monkeypatch.setattr(jtrain, "FaultTolerantLoop", log)
    assert jtrain.main() == 0
    monkeypatch.setattr(jtrain, "FaultTolerantLoop", log.loop_cls)
    return log.losses


def _run_port(monkeypatch, argv):
    log = _LossLog(train.FaultTolerantLoop)
    monkeypatch.setattr(train, "FaultTolerantLoop", log)
    assert train.main([*argv, "--device", "cpu"]) == 0
    monkeypatch.setattr(train, "FaultTolerantLoop", log.loop_cls)
    return log.losses


def test_train_cli_lm_losses_match_jax(tmp_path, monkeypatch):
    """``launch.train --arch moonshot-v1-16b-a3b`` on both packages, the
    same params and token batches: every step's loss at rtol 1e-4."""
    _carry_init(monkeypatch, 1)
    argv = [*COMMON, "--steps", "5", "--ckpt-interval", "100"]
    want = _run_jax(monkeypatch, [*argv, "--ckpt-dir", str(tmp_path / "j")])
    got = _run_port(monkeypatch, [*argv, "--ckpt-dir", str(tmp_path / "p")])
    assert len(got) == len(want) == 5
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert got[-1] < got[0]


def _like(lr, n_steps):
    cfg = get_arch(MOONSHOT).smoke_config
    params = T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    opt = adamw(linear_warmup_cosine(lr, n_steps // 10 + 1, n_steps))
    return params, opt.init(params)


def test_jax_lm_checkpoint_resumes_in_the_port(tmp_path, monkeypatch):
    """JAX's trainer writes step 3; JAX's and the port's trainers each
    resume a copy of it to step 6 (replaying batches from 0, as the
    reference does) and land on the same params and moments."""
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    argv = [*COMMON, "--ckpt-interval", "3"]
    _run_jax(monkeypatch, [*argv, "--ckpt-dir", str(jdir), "--steps", "3"])
    shutil.copytree(jdir, tdir)
    want_losses = _run_jax(monkeypatch, [*argv, "--ckpt-dir", str(jdir),
                                         "--steps", "6"])
    got_losses = _run_port(monkeypatch, [*argv, "--ckpt-dir", str(tdir),
                                         "--steps", "6"])
    np.testing.assert_allclose(got_losses, want_losses, rtol=RTOL)
    like = _like(3e-4, 6)
    got, at = CheckpointManager(str(tdir)).restore(like, step=6)
    want, jat = CheckpointManager(str(jdir)).restore(like, step=6)
    assert at == jat == 6
    for tree in (lambda s: s[0], lambda s: s[1]["mu"], lambda s: s[1]["nu"]):
        for g, w in zip(tree_leaves(tree(got)), tree_leaves(tree(want))):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=RTOL,
                                       atol=ATOL)
    assert int(got[1]["count"]) == int(want[1]["count"]) == 6


def test_full_lm_training_config():
    """``--full`` for an LM: CONFIG at every width, n_layers cut to
    FULL_TRAIN_LAYERS; llama4's cut state does not fit and is refused."""
    arch = get_arch(MOONSHOT)
    cfg = train.training_config(arch, True)
    assert vars(cfg) == dict(vars(arch.config), n_layers=4)
    assert train.FULL_TRAIN_LAYERS == 4
    assert round(train.lm_state_bytes(cfg) / 1e9, 1) == 35.4
    assert train.lm_state_bytes(dataclasses.replace(cfg, n_layers=6)) \
        > train.FULL_TRAIN_STATE
    assert train.training_config(arch, False) is arch.smoke_config
    with pytest.raises(ValueError, match="124.5 GB"):
        train.training_config(get_arch("llama4-scout-17b-a16e"), True)
    for arch_id in ("gemma2-9b", "phi3-mini-3.8b", "deepseek-coder-33b"):
        full = train.training_config(get_arch(arch_id), True)
        assert full.n_layers == 4 and full.d_model == \
            get_arch(arch_id).config.d_model


@pytest.mark.parametrize("preset,want", [
    ({}, {"PYTORCH_ALLOC_CONF": "expandable_segments:True"}),
    ({"PYTORCH_ALLOC_CONF": "max_split_size_mb:512"},
     {"PYTORCH_ALLOC_CONF": "max_split_size_mb:512,expandable_segments:True"}),
    ({"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:False"},
     {"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:False"}),
])
def test_full_lm_grows_segments(monkeypatch, preset, want):
    """An LM's --full run has the CUDA allocator grow its segments in
    place; a setting the caller made is kept. ``main`` sets it before it
    resolves the device, so without a card the run still raises after
    setting it, and a run of another family leaves the variables alone."""
    for var in ("PYTORCH_ALLOC_CONF", "PYTORCH_CUDA_ALLOC_CONF"):
        monkeypatch.delenv(var, raising=False)
    for var, value in preset.items():
        monkeypatch.setenv(var, value)
    train.grow_segments()
    assert {v: x for v in ("PYTORCH_ALLOC_CONF", "PYTORCH_CUDA_ALLOC_CONF")
            if (x := os.environ.get(v)) is not None} == want
    for var in ("PYTORCH_ALLOC_CONF", "PYTORCH_CUDA_ALLOC_CONF"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(train, "resolve_device", _no_card)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "two-tower-retrieval", "--full"])
    assert "PYTORCH_ALLOC_CONF" not in os.environ
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", MOONSHOT, "--full"])
    assert os.environ["PYTORCH_ALLOC_CONF"] == \
        "expandable_segments:True"


def _no_card(device=None):
    raise RuntimeError("no CUDA device is present")


@pytest.mark.parametrize("arch_id", LM)
def test_lm_flops_match_jax(arch_id):
    for cfg, jcfg in ((ARCHS[arch_id].config, JARCHS[arch_id].config),
                      (ARCHS[arch_id].smoke_config,
                       JARCHS[arch_id].smoke_config)):
        for tokens, kv in ((8192, 4096), (4, 8192), (16, None)):
            assert steps._lm_flops_fwd(cfg, tokens, kv_len=kv) == \
                jsteps._lm_flops_fwd(jcfg, tokens, kv_len=kv)
