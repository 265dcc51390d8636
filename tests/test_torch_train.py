"""The port's two-tower training slice against the JAX package on the same
inputs, on the CPU: bag_lookup's plain backward (bit for bit against
jax.vjp of JAX's bag_lookup, and a model of the CUDA kernel's pass over
its int32 CSR order), loss_fn's value, metrics and gradients, the train step
with and without microbatches, the data readers, the trainer CLI, a
checkpoint JAX's trainer wrote resumed by the port's, and the reference's
resume, which restarts the batches (mirrored, ROADMAP C). Tolerances are
tests/test_recsys.py's (rtol 1e-4, atol 1e-5) wherever two frameworks'
float sums meet; the backward alone is exact."""
import dataclasses
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.data import pipeline as jdp
from repro.kernels.embedding_bag.ops import bag_lookup as jbag_lookup
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.models import recsys as JRS
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.data import pipeline as dp
from repro_torch.kernels.embedding_bag.embedding_bag import (
    backward_order, embedding_bag_backward,
)
from repro_torch.kernels.embedding_bag.ops import bag_lookup
from repro_torch.kernels.embedding_bag.ref import embedding_bag_backward_ref
from repro_torch.launch import steps, train
from repro_torch.models import recsys as RS
from repro_torch.optim import adamw, linear_warmup_cosine, opt_state_from_jax
from repro_torch.optim.optimizers import tree_leaves, tree_map
from test_torch_engine import release_jax_executables  # noqa: F401

RTOL, ATOL = 1e-4, 1e-5      # tests/test_recsys.py's tolerance
ARCH = "two-tower-retrieval"


def _bits(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32).view(np.int32)


def _bwd_case(v, d, b, l, kind, seed):
    """(idx, g): ids in [-1, V) with ``kind`` = ``random`` (repeats within
    and across bags), ``dup`` (every bag one id over and over),
    ``padded`` (half the bags all -1, the rest a quarter -1) or ``hot``
    (ids from 3 rows); a bag gradient whose magnitudes span e^±9, with
    -0.0 entries."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(-1, v, (b, l)).astype(np.int32)
    if kind == "dup":
        idx[:] = rng.integers(0, v, (b, 1))
    elif kind == "padded":
        idx[::2] = -1
        idx[1::2] = np.where(rng.random((len(idx[1::2]), l)) < 0.25, -1,
                             idx[1::2])
    elif kind == "hot":
        idx = rng.integers(0, min(v, 3), (b, l)).astype(np.int32)
    idx[0, 0] = -1
    g = (rng.standard_normal((b, d))
         * np.exp(rng.uniform(-9, 9, (b, 1)))).astype(np.float32)
    g[rng.random((b, d)) < 0.05] = -0.0
    return idx, g


def _kernel_walk(g, idx, v, mode):
    """The CUDA kernel's algorithm on the host: the int32 CSR order of
    ``backward_order``, one pass over the rows, each row's run of
    positions walked in ascending order into an f32 sum from +0.0, mean
    slots divided by their bag's count, -1 slots in no run, rows with an
    empty run written as zeros."""
    order = backward_order(idx, v)
    off, perm = order.offsets.numpy(), order.perm.numpy()
    l = idx.shape[1]
    gn = g.numpy()
    cnt = np.maximum(order.counts.numpy(), 1).astype(np.float32)
    out = np.empty((v, g.shape[1]), np.float32)
    for r in range(v):
        acc = np.zeros(g.shape[1], np.float32)
        for pos in np.sort(perm[off[r]:off[r + 1]]):
            x = gn[pos // l]
            acc = acc + (x / cnt[pos // l] if mode == "mean" else x)
        out[r] = acc
    return out


# (V, D, B, L): V from 1 up, rows of 1..130 columns
BWD_SHAPES = [(1, 4, 5, 3), (2, 16, 9, 1), (7, 16, 40, 8), (64, 130, 33, 5),
              (300, 24, 200, 37)]


@pytest.mark.parametrize("kind", ["random", "dup", "padded", "hot"])
@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("v,d,b,l", BWD_SHAPES)
def test_plain_backward_bit_equal_to_jax_vjp(v, d, b, l, mode, kind):
    idx, g = _bwd_case(v, d, b, l, kind, seed=v * 1000 + b + l)
    table = np.random.default_rng(v).standard_normal((v, d)).astype(
        np.float32)
    _, vjp = jax.vjp(lambda t: jbag_lookup(t, jnp.asarray(idx), mode),
                     jnp.asarray(table))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    tidx, tg = torch.from_numpy(idx), torch.from_numpy(g)
    got = embedding_bag_backward_ref(tg, tidx, v, mode=mode)
    assert got.dtype == torch.float32 and got.shape == (v, d)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # the wrapper on CPU tensors is the plain version, and counts nothing
    before = embedding_bag_backward.launches
    assert torch.equal(embedding_bag_backward(tg, tidx, v, mode=mode), got)
    assert embedding_bag_backward.launches == before
    # autograd through bag_lookup; the indices get no gradient
    tt = torch.from_numpy(table).requires_grad_(True)
    out = bag_lookup(tt, tidx, mode)
    (ag,) = torch.autograd.grad(out, tt, tg)
    np.testing.assert_array_equal(_bits(ag), _bits(want))
    # the kernel's order of summation gives the same bits
    np.testing.assert_array_equal(_bits(_kernel_walk(tg, tidx, v, mode)),
                                  _bits(want))


def test_backward_order_keys():
    """The order as int32 CSR arrays: row r's run of flat positions is
    ``perm[offsets[r]:offsets[r + 1]]``, ascending; -1 slots in no run."""
    idx = torch.tensor([[2, -1, 0], [0, 2, 2]], dtype=torch.int32)
    order = backward_order(idx, 3)
    assert all(x.dtype == torch.int32 for x in order)
    assert order.offsets.tolist() == [0, 2, 2, 5]
    assert order.perm[:5].tolist() == [2, 3, 0, 4, 5]
    assert order.counts.tolist() == [2, 3]


def test_bag_lookup_raises_for_a_bf16_table_that_needs_a_gradient():
    table = torch.zeros((4, 2), dtype=torch.bfloat16, requires_grad=True)
    idx = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="float32"):
        bag_lookup(table, idx)
    with torch.no_grad():
        assert bag_lookup(table, idx).dtype == torch.float32
    with pytest.raises(ValueError, match="mode"):
        embedding_bag_backward(torch.zeros((1, 2)), idx, 4, mode="max")


# ---------------------------------------------------------------------------
# the loss and the step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def carried():
    """JAX params at the smoke config and a B = 16 batch, each with its
    port twin on the CPU."""
    jcfg = JARCHS[ARCH].smoke_config
    cfg = get_arch(ARCH).smoke_config
    jparams = JRS.init_params(jax.random.PRNGKey(3), jcfg)
    params = RS.params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    batch_np = RS.make_batch(cfg, 16, seed=5)
    jbatch = {k: jnp.asarray(v) for k, v in batch_np.items()}
    return jcfg, jparams, jbatch, cfg, params, batch_np


def _close_trees(got: dict, want, what: str):
    got_l, want_l = tree_leaves(got), jax.tree.leaves(want)
    assert len(got_l) == len(want_l)
    for i, (g, w) in enumerate(zip(got_l, want_l)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=f"{what} leaf {i}")


@pytest.mark.parametrize("use_kernel", [True, False])
def test_loss_fn_value_metrics_and_grads_match_jax(carried, use_kernel):
    jcfg, jparams, jbatch, cfg, params, batch_np = carried
    (jloss, jm), jgrads = jax.value_and_grad(JRS.loss_fn, has_aux=True)(
        jparams, jbatch, jcfg)
    batch = train.batch_tensors(batch_np, "cpu")
    loss, metrics, grads = steps.value_and_grad(
        lambda p, b, c: RS.loss_fn(p, b, c, use_kernel=use_kernel),
        params, batch, cfg)
    assert loss.shape == () and loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL)
    assert sorted(metrics) == sorted(jm) == ["in_batch_acc", "xent"]
    for k in jm:
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    _close_trees(grads, jgrads, "grad")
    for key in ("user_table", "item_table"):
        assert float(grads[key].abs().sum()) > 0


def test_softmax_xent_label_mask_matches_jax():
    from repro.models import layers as JL
    from repro_torch.models import layers as L
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 5, 11)).astype(np.float32) * 4
    labels = rng.integers(0, 11, (3, 5)).astype(np.int32)
    mask = rng.random((3, 5)) < 0.6
    for m in (None, mask, np.zeros_like(mask)):
        want = JL.softmax_xent(jnp.asarray(logits), jnp.asarray(labels),
                               label_mask=None if m is None else jnp.asarray(m))
        got = L.softmax_xent(torch.from_numpy(logits),
                             torch.from_numpy(labels),
                             label_mask=None if m is None
                             else torch.from_numpy(m))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("micro", [1, 2])
def test_train_step_matches_jax_after_5_steps(carried, micro):
    jcfg, jparams, _, cfg, params, _ = carried
    jstep, jopt = jsteps._train_step_fn(JRS.loss_fn, jcfg, micro=micro)
    jstep = jax.jit(jstep)
    step, opt = steps._train_step_fn(RS.loss_fn, cfg, micro=micro)
    js, s = jopt.init(jparams), opt.init(params)
    jp, p = jparams, params
    for t in range(5):
        b = RS.make_batch(cfg, 8, seed=100 + t)
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
        p, s, m = step(p, s, train.batch_tensors(b, "cpu"))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=RTOL, err_msg=f"loss {t}")
        np.testing.assert_allclose(float(m["gnorm"]), float(jm["gnorm"]),
                                   rtol=RTOL, err_msg=f"gnorm {t}")
        assert sorted(m) == sorted(jm)
    _close_trees(p, jp, "params")
    _close_trees(s["mu"], js["mu"], "mu")
    assert int(s["count"]) == int(js["count"]) == 5


def test_training_reduces_loss():
    """tests/test_recsys.py's fixed-batch check on the port: a few SGD
    steps on 8 pairs reduce the sampled-softmax loss."""
    cfg = get_arch(ARCH).smoke_config
    params = RS.init_params(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    batch = train.batch_tensors(RS.make_batch(cfg, 8, seed=0), "cpu")
    losses = []
    for _ in range(12):
        loss, _, g = steps.value_and_grad(RS.loss_fn, params, batch, cfg)
        params = tree_map(lambda p, gg: p - 0.5 * gg, params, g)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.8, losses


# ---------------------------------------------------------------------------
# data, configs, the trainer CLI
# ---------------------------------------------------------------------------

def _assert_batches_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_data_readers_match_jax():
    _assert_batches_equal(dp.lm_batch(1000, 3, 17, seed=4, step=9),
                          jdp.lm_batch(1000, 3, 17, seed=4, step=9))
    for kw in ({}, {"seed": 3, "start_step": 5}):
        got = dp.token_batches(50_000, 2, 8, **kw)
        want = jdp.token_batches(50_000, 2, 8, **kw)
        for _ in range(3):
            _assert_batches_equal(next(got), next(want))
    for full in (False, True):
        cfg = train.training_config(get_arch(ARCH), full)
        jcfg = dataclasses.replace(JARCHS[ARCH].smoke_config, **vars(cfg))
        for kw in ({}, {"seed": 7, "start_step": 2}):
            got = dp.recsys_batches(cfg, 6, **kw)
            want = jdp.recsys_batches(jcfg, 6, **kw)
            for _ in range(3):
                _assert_batches_equal(next(got), next(want))


def test_graph_readers_build_lm_and_build_gnn_raise(tmp_path):
    """Nothing raises any more (A18.5): the graph readers give the JAX
    package's batches, build_lm and build_gnn build, and the trainer runs
    an LM and a GNN."""
    from repro.graph.generators import make_graph as jmake_graph
    from repro_torch.graph.generators import make_graph

    g, jg = make_graph("mesh", 120, 330, seed=2), jmake_graph("mesh", 120,
                                                             330, seed=2)
    for kw in ({}, {"with_positions": True, "out_dim": 2, "seed": 5}):
        _assert_batches_equal(dp.graph_full_batch(g, 16, **kw),
                              jdp.graph_full_batch(jg, 16, **kw))
    got = dp.graph_minibatches(g, 8, 4, (3, 2), seed=1, start_step=2)
    want = jdp.graph_minibatches(jg, 8, 4, (3, 2), seed=1, start_step=2)
    for _ in range(2):
        _assert_batches_equal(next(got), next(want))
    # build_lm builds (LM training is ported), and so does build_gnn
    args = type("Args", (), dict(full=False, seed=0, batch=2, seq=8))()
    cfg, loss_fn, params, batches = train.build_lm(get_arch("gemma2-9b"),
                                                   args, "cpu")
    assert cfg is get_arch("gemma2-9b").smoke_config and loss_fn is not None
    assert next(batches)["tokens"].shape == (2, 8)
    assert params["embed"].device.type == "cpu"
    cfg, loss_fn, params, batches = train.build_gnn(get_arch("meshgraphnet"),
                                                    args, "cpu")
    assert cfg is get_arch("meshgraphnet").smoke_config
    assert next(batches)["node_feat"].shape == (256, 16)
    assert params["proc"]["edge"]["ln"]["g"].shape == (cfg.n_layers,
                                                       cfg.d_hidden)
    assert train.main(["--arch", "phi3-mini-3.8b", "--device", "cpu",
                       "--steps", "1", "--batch", "2", "--seq", "8",
                       "--ckpt-interval", "100", "--ckpt-dir",
                       str(tmp_path)]) == 0
    assert train.main(["--arch", "schnet", "--device", "cpu", "--steps", "2",
                       "--ckpt-interval", "100", "--ckpt-dir",
                       str(tmp_path / "schnet")]) == 0


def test_training_config():
    arch = get_arch(ARCH)
    assert train.training_config(arch, False) is arch.smoke_config
    full = train.training_config(arch, True)
    assert vars(full) == dict(vars(arch.config), user_vocab=4_194_304,
                              item_vocab=4_194_304)
    assert full.dtype == "float32" and full.user_vocab % 512 == 0


def test_train_cli_on_cpu(tmp_path, capsys):
    assert train.main(["--arch", ARCH, "--device", "cpu", "--steps", "4",
                       "--ckpt-dir", str(tmp_path), "--ckpt-interval", "2",
                       "--log-every", "1"]) == 0
    out = capsys.readouterr().out
    assert "params=135,168" in out and "done: 4 steps" in out
    assert CheckpointManager(str(tmp_path)).latest() == 4
    assert train.main(["--arch", ARCH, "--device", "cpu", "--steps", "4",
                       "--ckpt-dir", str(tmp_path)]) == 0
    assert "resumed from checkpoint step 4" in capsys.readouterr().out


def test_train_cli_without_a_device_needs_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", ARCH, "--steps", "1",
                    "--ckpt-dir", str(tmp_path)])


def _ckpt_state(directory, step, like):
    state, got = CheckpointManager(str(directory)).restore(like, step=step)
    assert got == step
    return state


def _like_state(cfg, lr, steps_):
    params = RS.init_params(cfg, generator=torch.Generator().manual_seed(1),
                            device="cpu")
    opt = adamw(linear_warmup_cosine(lr, steps_ // 10 + 1, steps_))
    return opt, (params, opt.init(params))


def test_resume_replays_batches_from_zero(tmp_path):
    """The reference's resume (src/repro/launch/train.py:63, :106-131)
    builds its batches without ``start_step``, so a run of 3 steps resumed
    to 6 trains on batches 0, 1, 2, 0, 1, 2 — the port mirrors it."""
    cfg = get_arch(ARCH).smoke_config
    args = ["--arch", ARCH, "--device", "cpu", "--ckpt-dir", str(tmp_path),
            "--ckpt-interval", "3", "--batch", "8", "--seed", "2"]
    assert train.main(args + ["--steps", "3"]) == 0
    assert train.main(args + ["--steps", "6"]) == 0
    _, like = _like_state(cfg, 3e-4, 6)
    got = _ckpt_state(tmp_path, 6, like)

    params = RS.init_params(cfg, generator=torch.Generator().manual_seed(2),
                            device="cpu")
    batches = [train.batch_tensors(b, "cpu") for b in
               [RS.make_batch(cfg, 8, seed=2 + t) for t in range(3)]]
    state = None
    for n_steps in (3, 6):          # each run's own schedule, as the CLI's
        opt = adamw(linear_warmup_cosine(3e-4, n_steps // 10 + 1, n_steps))
        step = steps.train_step(RS.loss_fn, cfg, opt)
        if state is None:
            state = opt.init(params)
        for b in batches:
            params, state, _ = step(params, state, b)
    for x, y in zip(tree_leaves(got[0]) + [got[1]["count"]],
                    tree_leaves(params) + [state["count"]]):
        assert torch.equal(x, y)


def test_jax_trainer_checkpoint_resumes_in_the_port(tmp_path, monkeypatch):
    """JAX's trainer writes step 3; JAX's and the port's trainers each
    resume a copy of it to step 6, and land on the same params and state."""
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    common = ["--arch", ARCH, "--ckpt-interval", "3", "--batch", "8",
              "--seed", "1"]

    def run_jax(directory, n_steps):
        monkeypatch.setattr(sys, "argv", ["train", *common, "--ckpt-dir",
                                          str(directory), "--steps",
                                          str(n_steps)])
        assert jtrain.main() == 0

    run_jax(jdir, 3)
    shutil.copytree(jdir, tdir)
    run_jax(jdir, 6)
    assert train.main([*common, "--ckpt-dir", str(tdir), "--steps", "6",
                       "--device", "cpu"]) == 0
    cfg = get_arch(ARCH).smoke_config
    _, like = _like_state(cfg, 3e-4, 6)
    got = _ckpt_state(tdir, 6, like)
    want = _ckpt_state(jdir, 6, like)
    _close_trees(got[0], jax.tree.map(lambda t: t.numpy(), want[0]), "params")
    _close_trees(got[1]["mu"], jax.tree.map(lambda t: t.numpy(),
                                            want[1]["mu"]), "mu")
    assert int(got[1]["count"]) == int(want[1]["count"]) == 6


def test_jax_state_carried_into_the_train_step(carried):
    """params_from_jax and opt_state_from_jax carry a JAX trainer's state
    after 2 steps; both step on 3 more to the same params."""
    jcfg, jparams, _, cfg, _, _ = carried
    jstep, jopt = jsteps._train_step_fn(JRS.loss_fn, jcfg)
    jstep = jax.jit(jstep)
    jp, js = jparams, jopt.init(jparams)
    batches = [RS.make_batch(cfg, 8, seed=300 + t) for t in range(5)]
    for b in batches[:2]:
        jp, js, _ = jstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
    p = RS.params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    s = opt_state_from_jax(jax.tree.map(np.asarray, js), p)
    step, _ = steps._train_step_fn(RS.loss_fn, cfg)
    for b in batches[2:]:
        jp, js, _ = jstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
        p, s, _ = step(p, s, train.batch_tensors(b, "cpu"))
    _close_trees(p, jp, "params")
    assert int(s["count"]) == 5
