"""The port's optimizers against the JAX package's on the same gradient
trees: AdamW and SGD with momentum (with and without clipping, constant
and scheduled learning rates) over 20 steps, both schedules,
clip_by_global_norm and apply_updates at rtol 1e-5; a JAX state carried
across with opt_state_from_jax; the checkpoint leaves of the state; and
the port's counterparts of tests/test_optim_checkpoint.py's optimizer
tests. Every check runs on the CPU."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import save_pytree as jsave_pytree
from repro.optim import optimizers as JO
from repro_torch.checkpoint.ckpt import checkpoint_keys, save_pytree
from repro_torch.optim import (
    adamw, apply_updates, clip_by_global_norm, cosine_schedule,
    linear_warmup_cosine, opt_state_from_jax, sgd_momentum,
)
from repro_torch.optim.optimizers import tree_leaves, tree_map
from test_torch_engine import release_jax_executables  # noqa: F401

RTOL = 1e-5
# the tree's shapes: nested dicts, a 0-dim leaf, keys out of sorted order
SHAPES = {"w": (4, 3), "b": {"z": (5,), "a": ()}, "emb": (6, 2)}
STEPS = 20


def _tree(shapes, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in shapes.items()}


def _np_tree(rng, scale=1.0):
    return _tree(SHAPES, lambda s: (rng.standard_normal(s) * scale)
                 .astype(np.float32))


def _to_torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _assert_trees_close(got, want, rtol=RTOL, atol=0.0, what=""):
    got_l = tree_leaves(got)
    want_l = jax.tree.leaves(want)
    assert len(got_l) == len(want_l), what
    for i, (g, w) in enumerate(zip(got_l, want_l)):
        assert tuple(g.shape) == np.shape(w), (what, i)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol,
                                   atol=atol, err_msg=f"{what} leaf {i}")


OPTS = {
    "adamw_clip": (lambda m: m.adamw(3e-3, weight_decay=0.1, clip_norm=1.0)),
    "adamw_noclip_sched": (lambda m: m.adamw(
        m.linear_warmup_cosine(1e-2, 3, STEPS), weight_decay=0.05,
        clip_norm=0.0)),
    "adamw_cosine": (lambda m: m.adamw(m.cosine_schedule(5e-3, STEPS))),
    "sgd": (lambda m: m.sgd_momentum(0.05)),
    "sgd_clip_sched": (lambda m: m.sgd_momentum(
        m.cosine_schedule(0.1, STEPS), momentum=0.8, clip_norm=0.5)),
}
PORT = type("Port", (), {k: staticmethod(v) for k, v in dict(
    adamw=adamw, sgd_momentum=sgd_momentum, cosine_schedule=cosine_schedule,
    linear_warmup_cosine=linear_warmup_cosine).items()})


def _run_both(name, steps, *, carry_at=None):
    """Both packages' optimizer ``name`` over ``steps`` gradient trees from
    one numpy seed (gradients spread over 1e-3..10 so that clipping
    bites); the port's state is carried from JAX's at step ``carry_at``
    when given. Returns (port params, port state, jax params, jax
    state)."""
    rng = np.random.default_rng(11)
    p0 = _np_tree(rng)
    grads = [_np_tree(rng, scale=10.0 ** rng.uniform(-3, 1))
             for _ in range(steps)]
    jopt, opt = OPTS[name](JO), OPTS[name](PORT)
    jp, p = _to_jax(p0), _to_torch(p0)
    js, s = jopt.init(jp), opt.init(p)
    for t, g in enumerate(grads):
        if t == carry_at:
            s = opt_state_from_jax(jax.tree.map(np.asarray, js), p)
            p = _to_torch(jax.tree.map(np.asarray, jp))
        ju, js = jopt.update(_to_jax(g), js, jp)
        jp = JO.apply_updates(jp, ju)
        u, s = opt.update(_to_torch(g), s, p)
        p = apply_updates(p, u)
    return p, s, jp, js


@pytest.mark.parametrize("name", sorted(OPTS))
def test_optimizer_matches_jax_over_20_steps(name):
    p, s, jp, js = _run_both(name, STEPS)
    _assert_trees_close(p, jp, what="params")
    assert sorted(s) == sorted(js)
    for key in s:
        if key == "count":
            assert s[key].dtype == torch.int32 and s[key].shape == ()
            assert int(s[key]) == int(js[key]) == STEPS
        elif key == "gnorm":
            assert s[key].dtype == torch.float32 and s[key].shape == ()
            np.testing.assert_allclose(float(s[key]), float(js[key]),
                                       rtol=RTOL)
        else:
            assert all(x.dtype == torch.float32 for x in tree_leaves(s[key]))
            _assert_trees_close(s[key], js[key], atol=1e-12, what=key)


@pytest.mark.parametrize("name", ["adamw_clip", "sgd_clip_sched"])
def test_jax_state_carried_across_steps_on(name):
    """A JAX state (and params) carried into the port at step 8 steps on
    to JAX's params after 20."""
    p, s, jp, js = _run_both(name, STEPS, carry_at=8)
    _assert_trees_close(p, jp, what="params")
    assert int(s["count"]) == STEPS


def test_opt_state_from_jax_checks_shapes_and_keys():
    params = _to_torch(_np_tree(np.random.default_rng(0)))
    js = jax.tree.map(np.asarray, JO.adamw(1e-3).init(_to_jax(
        jax.tree.map(np.asarray, tree_map(lambda t: t.numpy(), params)))))
    s = opt_state_from_jax(js, params)
    assert s["count"].dtype == torch.int32 and s["gnorm"].dtype == torch.float32
    bad = dict(js, mu=dict(js["mu"], w=np.zeros((3, 4), np.float32)))
    with pytest.raises(ValueError, match="does not fit"):
        opt_state_from_jax(bad, params)
    with pytest.raises(ValueError, match="unknown"):
        opt_state_from_jax(dict(js, extra=np.zeros(1)), params)


def test_bf16_params_keep_f32_state():
    p = {"t": torch.ones((3, 2), dtype=torch.bfloat16)}
    opt = adamw(1e-2)
    s = opt.init(p)
    assert s["mu"]["t"].dtype == torch.float32
    u, s = opt.update({"t": torch.full((3, 2), 0.5, dtype=torch.bfloat16)},
                      s, p)
    assert u["t"].dtype == torch.bfloat16
    assert s["nu"]["t"].dtype == torch.float32
    assert apply_updates(p, u)["t"].dtype == torch.bfloat16


def test_schedules_match_jax():
    for jlr, lr in ((JO.cosine_schedule(1.0, 100),
                     cosine_schedule(1.0, 100)),
                    (JO.cosine_schedule(3e-4, 7, final_frac=0.25),
                     cosine_schedule(3e-4, 7, final_frac=0.25)),
                    (JO.linear_warmup_cosine(1.0, 10, 100),
                     linear_warmup_cosine(1.0, 10, 100)),
                    (JO.linear_warmup_cosine(3e-4, 1, 3),
                     linear_warmup_cosine(3e-4, 1, 3))):
        for step in range(0, 121):
            want = float(jlr(jnp.asarray(step, jnp.int32)))
            got = lr(torch.tensor(step, dtype=torch.int32))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), want, rtol=RTOL,
                                       atol=1e-12)
            assert float(lr(step)) == float(got)   # a Python int step too


def test_clip_and_apply_updates_match_jax():
    rng = np.random.default_rng(4)
    g = _np_tree(rng, scale=30.0)
    for max_norm in (1.0, 1e6):
        got, gn = clip_by_global_norm(_to_torch(g), max_norm)
        want, jgn = JO.clip_by_global_norm(_to_jax(g), max_norm)
        np.testing.assert_allclose(float(gn), float(jgn), rtol=RTOL)
        _assert_trees_close(got, want, what=f"clip {max_norm}")
    p, u = _np_tree(rng), _np_tree(rng, scale=1e-3)
    _assert_trees_close(apply_updates(_to_torch(p), _to_torch(u)),
                        JO.apply_updates(_to_jax(p), _to_jax(u)), rtol=0,
                        what="apply_updates")


def test_checkpoint_holds_jax_leaves(tmp_path):
    """The trainer's (params, AdamW state) checkpoint has the leaf keys,
    order and dtypes of the JAX package's."""
    p0 = _np_tree(np.random.default_rng(2))
    jstate = (_to_jax(p0), JO.adamw(1e-3).init(_to_jax(p0)))
    params = _to_torch(p0)
    state = (params, adamw(1e-3).init(params))
    jpath, path = (os.path.join(tmp_path, f"{n}.npz") for n in ("j", "t"))
    jsave_pytree(jpath, jstate, step=0)
    save_pytree(path, state, step=0)
    assert checkpoint_keys(path) == checkpoint_keys(jpath)
    with np.load(path) as a, np.load(jpath) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k


# ---------------------------------------------------------------------------
# tests/test_optim_checkpoint.py's optimizer tests, on the port
# ---------------------------------------------------------------------------

def _grad(loss, w):
    leaves = {k: v.detach().requires_grad_(True) for k, v in w.items()}
    out = loss(leaves)
    gs = torch.autograd.grad(out, list(leaves.values()))
    return dict(zip(leaves, gs))


def test_adamw_converges_quadratic():
    w = {"a": torch.tensor([5.0, -3.0]), "b": torch.tensor(2.0)}
    opt = adamw(0.2, weight_decay=0.0)
    state = opt.init(w)

    def loss(w):
        return torch.sum(w["a"] ** 2) + w["b"] ** 2

    for _ in range(120):
        upd, state = opt.update(_grad(loss, w), state, w)
        w = apply_updates(w, upd)
    assert float(loss(w)) < 1e-3


def test_weight_decay_shrinks_params():
    w = {"a": torch.ones(4) * 10.0}
    opt = adamw(0.1, weight_decay=0.5)
    state = opt.init(w)
    for _ in range(20):
        upd, state = opt.update({"a": torch.zeros(4)}, state, w)
        w = apply_updates(w, upd)
    assert float(torch.abs(w["a"]).max()) < 10.0


def test_clip_by_global_norm():
    clipped, norm = clip_by_global_norm({"x": torch.ones(16) * 100.0}, 1.0)
    assert abs(float(norm) - 400.0) < 1e-3
    total = torch.sqrt(torch.sum(clipped["x"] ** 2))
    np.testing.assert_allclose(float(total), 1.0, rtol=1e-4)


def test_schedules():
    lr = cosine_schedule(1.0, 100)
    assert float(lr(0)) == pytest.approx(1.0)
    assert float(lr(100)) == pytest.approx(0.1, abs=1e-6)
    lrw = linear_warmup_cosine(1.0, 10, 100)
    assert float(lrw(0)) < float(lrw(9))
    assert float(lrw(10)) == pytest.approx(1.0, rel=1e-3)


def test_sgd_momentum_descends():
    w = {"x": torch.tensor([4.0])}
    opt = sgd_momentum(0.02)   # heavy-ball stable region for f=x²
    state = opt.init(w)
    for _ in range(150):
        upd, state = opt.update({"x": 2 * w["x"]}, state, w)
        w = apply_updates(w, upd)
    assert abs(float(w["x"][0])) < 0.1
