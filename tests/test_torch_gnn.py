"""The port's GNNs against the JAX package on the same inputs, on the CPU:
the segment ops (padding, empty segments, and the max / min gradients on
ties), the radial bases and edge vectors, ``layernorm`` and
``mlp_apply(final_act=True)``, the batch builders byte for byte, the SO(3)
tables, and each arch's loss and gradients against
``jax.value_and_grad`` at its smoke config on the trainer's mesh-graph
batch and on a molecule batch (rtol 1e-4 / atol 1e-5), with the JAX params
carried across. PNA on the molecule batch is held in f64: its std
aggregator amplifies a near-zero variance's rounding 5,000-fold, so two
f32 implementations differ there in the loss's fourth digit (JAX's own f32
loss is 8.6e-5 from its f64 loss; see ``models/gnn/pna.py``). NequIP's
gradients are non-finite where the reference's are (ROADMAP C)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.graph.generators import make_graph as jmake_graph
from repro.launch import steps as jsteps
from repro.models import layers as JL
from repro.models.gnn import common as JC
from repro.models.gnn import so3 as jso3
from repro_torch.configs import ARCHS, GNN_SHAPES
from repro_torch.graph.generators import make_graph
from repro_torch.launch import steps
from repro_torch.launch.train import batch_tensors
from repro_torch.models import layers as L
from repro_torch.models.gnn import common as C
from repro_torch.models.gnn import so3

GNN = ["meshgraphnet", "pna", "schnet", "nequip"]
RTOL, ATOL = 1e-4, 1e-5          # the port's training tests' bar


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(
                v.detach() if isinstance(v, torch.Tensor) else v)
    return out


# ---------------------------------------------------------------------------
# segment ops
# ---------------------------------------------------------------------------

def _segments(seed, e=40, n=7, f=3, ties=False):
    """Data (E, F) and ids in [-1, n) with -1 pads and two empty segments
    (n-1 and n-2 are never used); ``ties`` rounds the data to a coarse grid
    so many entries of a segment share its max and min."""
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((e, f)).astype(np.float32)
    if ties:
        data = np.round(data).astype(np.float32)
    ids = rng.integers(-1, n - 2, e).astype(np.int32)
    return data, ids, n


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("op", ["sum", "max", "min", "mean"])
def test_segment_ops_and_grads_match_jax(op, ties):
    data, ids, n = _segments(3, ties=ties)
    jf = getattr(JC, f"segment_{op}_pad")
    tf = getattr(C, f"segment_{op}_pad")
    cot = np.random.default_rng(4).standard_normal((n, 3)).astype(np.float32)

    def jloss(d):
        return jnp.sum(jf(d, jnp.asarray(ids), n) * cot)

    want, jgrad = jax.value_and_grad(jloss)(jnp.asarray(data))
    want_out = np.asarray(jf(jnp.asarray(data), jnp.asarray(ids), n))
    td = torch.from_numpy(data).requires_grad_()
    got_out = tf(td, torch.from_numpy(ids), n)
    torch.sum(got_out * torch.from_numpy(cot)).backward()
    np.testing.assert_allclose(got_out.detach().numpy(), want_out, rtol=1e-6,
                               atol=1e-6)
    # max / min fill empty segments with ±inf, as JAX's do
    assert np.array_equal(np.isfinite(got_out.detach().numpy()),
                          np.isfinite(want_out))
    np.testing.assert_allclose(td.grad.numpy(), np.asarray(jgrad),
                               rtol=1e-6, atol=1e-6)
    if ties and op in ("max", "min"):
        # a tie shares the gradient: some entry gets a fraction of it
        g = np.abs(td.grad.numpy())
        assert ((g > 0) & (g < np.abs(cot).max() - 1e-6)).any()


def test_segment_fill_gather_degree_and_bases_match_jax():
    data, ids, n = _segments(5)
    for op, fill in (("max", 0.0), ("min", 0.0), ("max", -3.5)):
        want = getattr(JC, f"segment_{op}_pad")(jnp.asarray(data),
                                                jnp.asarray(ids), n, fill=fill)
        got = getattr(C, f"segment_{op}_pad")(torch.from_numpy(data),
                                              torch.from_numpy(ids), n,
                                              fill=fill)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        C.gather_src(torch.from_numpy(data), torch.from_numpy(ids)).numpy(),
        np.asarray(JC.gather_src(jnp.asarray(data), jnp.asarray(ids))))
    np.testing.assert_array_equal(
        C.in_degree(torch.from_numpy(ids), n).numpy(),
        np.asarray(JC.in_degree(jnp.asarray(ids), n)))
    rng = np.random.default_rng(6)
    d = np.abs(rng.standard_normal(50)).astype(np.float32) * 4
    d[:3] = 0.0
    # the centres of jnp.linspace and torch.linspace differ by an ulp, which
    # exp(-900 (d - mu)^2) at 300 bases turns into 1e-4 relative
    for name, r, cut in (("gaussian_rbf", 300, 10.0),
                         ("gaussian_rbf", 16, 10.0), ("bessel_rbf", 8, 5.0)):
        np.testing.assert_allclose(
            getattr(C, name)(torch.from_numpy(d), r, cut).numpy(),
            np.asarray(getattr(JC, name)(jnp.asarray(d), r, cut)),
            rtol=RTOL, atol=ATOL)
    pos = rng.standard_normal((9, 3)).astype(np.float32)
    snd = rng.integers(-1, 9, 20).astype(np.int32)
    rcv = rng.integers(0, 9, 20).astype(np.int32)
    rcv[4] = -1
    got = C.edge_vectors(torch.from_numpy(pos), torch.from_numpy(snd),
                         torch.from_numpy(rcv))
    want = JC.edge_vectors(jnp.asarray(pos), jnp.asarray(snd),
                           jnp.asarray(rcv))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)


def test_layernorm_and_final_act_match_jax():
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((6, 24)) * 3 + 1).astype(np.float32)
    p = {"g": rng.standard_normal(24).astype(np.float32),
         "b": rng.standard_normal(24).astype(np.float32)}
    got = L.layernorm({k: torch.from_numpy(v) for k, v in p.items()},
                      torch.from_numpy(x))
    want = JL.layernorm({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    init = L.layernorm_init(24, device="cpu")
    assert init["g"].dtype == torch.float32 and float(init["g"].sum()) == 24
    assert float(init["b"].abs().sum()) == 0
    mlp = {f"l{i}": {"w": rng.standard_normal((a, b)).astype(np.float32)}
           for i, (a, b) in enumerate(((24, 8), (8, 5)))}
    tm = {k: {"w": torch.from_numpy(v["w"])} for k, v in mlp.items()}
    jm = {k: {"w": jnp.asarray(v["w"])} for k, v in mlp.items()}
    for final in (False, True):
        np.testing.assert_allclose(
            L.mlp_apply(tm, torch.from_numpy(x), final_act=final).numpy(),
            np.asarray(JL.mlp_apply(jm, jnp.asarray(x), final_act=final)),
            rtol=1e-5, atol=1e-5)


def test_batch_builders_and_so3_match_jax():
    for kw in ({}, {"with_positions": True, "out_dim": 3, "seed": 4}):
        got = C.graph_to_batch(make_graph("mesh", 150, 400, seed=1), 12, **kw)
        want = JC.graph_to_batch(jmake_graph("mesh", 150, 400, seed=1), 12,
                                 **kw)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    for kw in ({}, {"d_feat": 8, "out_dim": 2, "seed": 9}):
        got = C.batch_molecules(5, 12, 24, **kw)
        want = JC.batch_molecules(5, 12, 24, **kw)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    assert so3.paths(2) == jso3.paths(2) and so3.paths(1) == jso3.paths(1)
    for p in so3.paths(2):
        np.testing.assert_array_equal(so3.clebsch_gordan(*p),
                                      jso3.clebsch_gordan(*p))


def test_gnn_flops_match_jax():
    for arch_id in GNN:
        for shape in GNN_SHAPES.values():
            n, e = shape.n_pad, shape.e_pad
            assert steps._gnn_flops_fwd(ARCHS[arch_id], n, e, shape.d_feat) \
                == jsteps._gnn_flops_fwd(JARCHS[arch_id], n, e, shape.d_feat)
    assert set(steps._GNN_MODELS) == set(jsteps._GNN_MODELS)


# ---------------------------------------------------------------------------
# each arch against jax.value_and_grad
# ---------------------------------------------------------------------------

def mesh_batch():
    """The trainer's batch: a 256-node mesh graph with 16 features."""
    return C.graph_to_batch(make_graph("mesh", 256, 700, seed=0), 16,
                            with_positions=True, seed=0)


def molecule_batch(n_mol=8):
    return C.batch_molecules(n_mol, 12, 24, seed=0, d_feat=16)


def _jax_params(arch_id, cfg, seed=1):
    mod = jsteps._GNN_MODELS[arch_id]
    key = jax.random.PRNGKey(seed)
    if arch_id in ("meshgraphnet", "pna"):
        return mod.init_params(key, cfg, d_node=16)
    return mod.init_params(key, cfg)


def _port_params(arch_id, cfg, np_params):
    mod = steps._GNN_MODELS[arch_id]
    if arch_id in ("meshgraphnet", "pna"):
        return mod.params_from_jax(np_params, cfg, 16, device="cpu")
    return mod.params_from_jax(np_params, cfg, device="cpu")


def jax_value_and_grad(arch_id, params, batch, cfg):
    mod = jsteps._GNN_MODELS[arch_id]
    fn = jax.jit(jax.value_and_grad(mod.loss_fn, has_aux=True),
                 static_argnums=2)
    (loss, _), grads = fn(params, {k: jnp.asarray(v) for k, v in batch.items()},
                          cfg)
    return float(loss), _flat(_np(grads))


def port_value_and_grad(arch_id, params, batch, cfg):
    loss, _, grads = steps.value_and_grad(steps._GNN_MODELS[arch_id].loss_fn,
                                          params, batch_tensors(batch, "cpu"),
                                          cfg)
    return float(loss), _flat(grads)


def _f64(batch):
    return {k: v.astype(np.float64) if v.dtype == np.float32 else v
            for k, v in batch.items()}


@pytest.mark.parametrize("kind", ["mesh", "molecule"])
@pytest.mark.parametrize("arch_id", GNN)
def test_arch_loss_and_grads_match_jax(arch_id, kind):
    jcfg, cfg = JARCHS[arch_id].smoke_config, ARCHS[arch_id].smoke_config
    batch = mesh_batch() if kind == "mesh" else molecule_batch()
    jparams = _jax_params(arch_id, jcfg)
    if arch_id == "pna" and kind == "molecule":
        # f64 on both sides (see the module's docstring)
        with jax.enable_x64(True):
            jp64 = jax.tree.map(lambda x: jnp.asarray(x, jnp.float64),
                                jparams)
            want, wgrads = jax_value_and_grad(arch_id, jp64, _f64(batch), jcfg)
        params = jax.tree.map(lambda x: torch.from_numpy(
            np.asarray(x, np.float64)), _np(jparams))
        got, ggrads = port_value_and_grad(arch_id, params, _f64(batch), cfg)
    else:
        want, wgrads = jax_value_and_grad(arch_id, jparams, batch, jcfg)
        got, ggrads = port_value_and_grad(
            arch_id, _port_params(arch_id, cfg, _np(jparams)), batch, cfg)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert sorted(ggrads) == sorted(wgrads)
    for k in wgrads:
        assert ggrads[k].shape == wgrads[k].shape, k
        np.testing.assert_allclose(ggrads[k], wgrads[k], rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    assert np.isfinite(got)


@pytest.mark.parametrize("arch_id", GNN)
def test_params_from_jax_checks_shapes_at_the_full_config(arch_id):
    """``params_from_jax`` takes the JAX CONFIG's pytree leaf for leaf, and
    refuses the smoke config's."""
    jcfg, cfg = JARCHS[arch_id].config, ARCHS[arch_id].config
    shapes = jax.eval_shape(lambda: _jax_params(arch_id, jcfg))
    np_params = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    params = _port_params(arch_id, cfg, np_params)
    assert {k: v.shape for k, v in _flat(params).items()} == \
        {k: v.shape for k, v in _flat(np_params).items()}
    with pytest.raises(ValueError, match="do not fit"):
        _port_params(arch_id, ARCHS[arch_id].smoke_config, np_params)


def test_nequip_isolated_node_grads_nonfinite_as_in_jax():
    """The reference's fault, pinned (ROADMAP C): at NequIP's CONFIG on the
    ``molecule`` shape (128 molecules of 30 atoms, 64 edges each), 464
    atoms receive no edge; the norm gate's ``sqrt(sum(x * x))`` has the
    gradient 0/0 in the l > 0 channels no message reaches, and every leaf
    but the head's holds non-finite entries — exactly the same entries in
    both packages. The finite entries agree at the bar."""
    arch_id = "nequip"
    jcfg, cfg = JARCHS[arch_id].config, ARCHS[arch_id].config
    batch = C.batch_molecules(128, 30, 64, seed=0)
    assert (np.bincount(batch["receivers"], minlength=3840) == 0).sum() == 464
    jparams = _jax_params(arch_id, jcfg, seed=0)
    want, wgrads = jax_value_and_grad(arch_id, jparams, batch, jcfg)
    got, ggrads = port_value_and_grad(
        arch_id, _port_params(arch_id, cfg, _np(jparams)), batch, cfg)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert np.isfinite(got)
    assert {k: int((~np.isfinite(v)).sum()) for k, v in wgrads.items()} == {
        "embed": 512, "head/l0/w": 0, "head/l1/w": 0, "layers/mix0": 9216,
        "layers/mix1": 24576, "layers/mix2": 24576,
        "layers/radial/l0/w": 1024, "layers/radial/l1/w": 58368}
    for k in wgrads:
        fin = np.isfinite(wgrads[k])
        np.testing.assert_array_equal(np.isfinite(ggrads[k]), fin, err_msg=k)
        np.testing.assert_allclose(ggrads[k][fin], wgrads[k][fin], rtol=RTOL,
                                   atol=ATOL, err_msg=k)
