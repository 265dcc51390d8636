"""GNN training in the port against the JAX package on the CPU: the halo
MeshGraphNet over SDP's blocked layout (``runtime.gnn_halo_train``, all
P blocks stacked on one device) against JAX's dense ``loss_fn`` at P = 1,
2, 4 and 8 and against JAX's ``make_mgn_halo_loss`` under ``shard_map``
at P = 4 (in a child process with 4 forced host devices, as
tests/test_distribution.py runs JAX's halo exchange), loss and gradients
at rtol 1e-4 / atol 1e-5; and the trainer CLI for ``meshgraphnet``,
``pna`` and ``schnet`` against JAX's trainer from the same params (every
step's loss, then a resume), with ``--arch nequip`` failing as JAX's does
(ROADMAP C)."""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import ARCHS as JARCHS
from repro.graph.generators import make_graph as jmake_graph
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.models.gnn import common as JC
from repro.models.gnn import meshgraphnet as JMGN
from repro_torch.configs import ARCHS
from repro_torch.graph.generators import make_graph
from repro_torch.graph.halo import build_halo_spec
from repro_torch.launch import steps, train
from repro_torch.launch.train import batch_tensors
from repro_torch.models import layers as L
from repro_torch.models.gnn import common as C
from repro_torch.models.gnn import meshgraphnet as MGN
from repro_torch.runtime.gnn_halo_train import halo_batch, make_mgn_halo_loss
from test_torch_engine import release_jax_executables  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-4, 1e-5          # the port's training tests' bar
D_FEAT = 8


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(
                v.detach() if hasattr(v, "detach") else v)
    return out


def _nest(flat: dict) -> dict:
    out: dict = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def _assert_grads(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)


def _cfgs(remat: bool):
    return (dataclasses.replace(ARCHS["meshgraphnet"].smoke_config,
                                remat=remat),
            dataclasses.replace(JARCHS["meshgraphnet"].smoke_config,
                                remat=remat))


def _halo_loss(spec, params, batch, cfg):
    loss_fn = make_mgn_halo_loss(cfg, spec.block_size)
    hb = halo_batch(spec, batch["node_feat"], batch["targets"])
    loss, _, grads = steps.value_and_grad(loss_fn, params,
                                          batch_tensors(hb, "cpu"), cfg)
    return float(loss), _flat(grads)


@pytest.fixture(scope="module")
def dense_reference():
    """JAX's dense MeshGraphNet on a 150-node mesh graph (no positions, so
    its edge features are the ones the halo body uses)."""
    cfg, jcfg = _cfgs(True)
    jg = jmake_graph("mesh", 150, 400, seed=3)
    batch = JC.graph_to_batch(jg, D_FEAT, seed=1)
    jparams = JMGN.init_params(jax.random.PRNGKey(2), jcfg, d_node=D_FEAT)
    fn = jax.jit(jax.value_and_grad(JMGN.loss_fn, has_aux=True),
                 static_argnums=2)
    (loss, _), grads = fn(jparams, {k: jnp.asarray(v) for k, v in
                                    batch.items()}, jcfg)
    params = MGN.params_from_jax(_np(jparams), cfg, D_FEAT, device="cpu")
    return batch, params, float(loss), _flat(_np(grads))


@pytest.mark.parametrize("p", [1, 2, 4, 8])
def test_halo_mgn_matches_jax_dense_loss(dense_reference, p):
    batch, params, want, wgrads = dense_reference
    g = make_graph("mesh", 150, 400, seed=3)
    for remat in (True, False):
        cfg, _ = _cfgs(remat)
        a = np.random.default_rng(p).integers(0, p, g.n)
        got, ggrads = _halo_loss(build_halo_spec(g, a, p), params, batch, cfg)
        np.testing.assert_allclose(got, want, rtol=RTOL)
        _assert_grads(ggrads, wgrads)
    # the port's own dense loss agrees too
    loss, _, grads = steps.value_and_grad(MGN.loss_fn, params,
                                          batch_tensors(batch, "cpu"), cfg)
    np.testing.assert_allclose(float(loss), want, rtol=RTOL)
    _assert_grads(_flat(grads), wgrads)


JAX_HALO_P4 = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from repro.configs import ARCHS
from repro.graph.generators import make_graph
from repro.graph.halo import build_halo_spec, scatter_nodes
from repro.launch.mesh import make_mesh_compat
from repro.models.gnn import common as C, meshgraphnet as MGN
from repro.runtime.gnn_halo_train import make_mgn_halo_loss

cfg = dataclasses.replace(ARCHS["meshgraphnet"].smoke_config, remat=True)
g = make_graph("mesh", 150, 400, seed=3)
b = C.graph_to_batch(g, 8, seed=1)
a = np.random.default_rng(44).integers(0, 4, g.n)
spec = build_halo_spec(g, a, 4)
hb = {"node_feat": scatter_nodes(spec, b["node_feat"]),
      "targets": scatter_nodes(spec, b["targets"]),
      "node_mask": scatter_nodes(spec, b["node_mask"], fill=False),
      "publish_idx": spec.publish_idx, "halo_map": spec.halo_map,
      "senders": spec.senders, "receivers": spec.receivers}
params = MGN.init_params(jax.random.PRNGKey(5), cfg, d_node=8)
loss_fn = make_mgn_halo_loss(make_mesh_compat((4,), ("data",)), cfg,
                             spec.block_size)
(loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
    params, {k: jnp.asarray(v) for k, v in hb.items()})
out = {"loss": np.asarray(loss)}
for prefix, tree in (("p", params), ("g", grads)):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(k.key for k in path)
        out[prefix + ":" + key] = np.asarray(leaf)
np.savez(sys.argv[1], **out)
print("JAX_HALO_P4_OK", len(jax.devices()))
"""


def test_halo_mgn_matches_jax_shard_map_at_p4(tmp_path):
    out_path = tmp_path / "jax_halo.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(JAX_HALO_P4),
                          str(out_path)], capture_output=True, text=True,
                         env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "JAX_HALO_P4_OK 4" in out.stdout
    res = np.load(out_path)
    jparams = _nest({k[2:]: res[k] for k in res.files if k.startswith("p:")})
    wgrads = {k[2:]: res[k] for k in res.files if k.startswith("g:")}
    cfg, _ = _cfgs(True)
    params = MGN.params_from_jax(jparams, cfg, D_FEAT, device="cpu")
    g = make_graph("mesh", 150, 400, seed=3)
    batch = C.graph_to_batch(g, D_FEAT, seed=1)
    a = np.random.default_rng(44).integers(0, 4, g.n)
    got, ggrads = _halo_loss(build_halo_spec(g, a, 4), params, batch, cfg)
    np.testing.assert_allclose(got, float(res["loss"]), rtol=RTOL)
    _assert_grads(ggrads, wgrads)


# ---------------------------------------------------------------------------
# the trainer CLI
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


def _carry_init(monkeypatch, arch_id):
    """The port's trainer starts from the JAX trainer's params (the key of
    its default ``--seed`` 0)."""
    mod, jmod = steps._GNN_MODELS[arch_id], jsteps._GNN_MODELS[arch_id]
    init = mod.init_params

    def carried(cfg, *d_node, generator, device):
        kw = {"d_node": d_node[0]} if d_node else {}
        jp = jmod.init_params(jax.random.PRNGKey(0),
                              JARCHS[arch_id].smoke_config, **kw)
        specs = C.leaf_specs(init(cfg, *d_node, generator=generator,
                                  device=device))
        return L.params_from_numpy(_np(jp), specs, cfg.name, device)

    monkeypatch.setattr(mod, "init_params", carried)


def _run_jax(monkeypatch, argv):
    monkeypatch.setattr(sys, "argv", ["train", *argv])
    log = _LossLog(jtrain.FaultTolerantLoop)
    monkeypatch.setattr(jtrain, "FaultTolerantLoop", log)
    try:
        assert jtrain.main() == 0
    finally:
        monkeypatch.setattr(jtrain, "FaultTolerantLoop", log.loop_cls)
    return log.losses


def _run_port(monkeypatch, argv):
    log = _LossLog(train.FaultTolerantLoop)
    monkeypatch.setattr(train, "FaultTolerantLoop", log)
    try:
        assert train.main([*argv, "--device", "cpu"]) == 0
    finally:
        monkeypatch.setattr(train, "FaultTolerantLoop", log.loop_cls)
    return log.losses


@pytest.mark.parametrize("arch_id", ["meshgraphnet", "pna", "schnet"])
def test_train_cli_gnn_matches_jax_and_resumes(tmp_path, monkeypatch,
                                               capsys, arch_id):
    """Both trainers from the same params on the same fixed batch: every
    step's loss at rtol 1e-4 over 4 steps (a checkpoint at step 2), then
    each resumes its own checkpoint to step 6, replaying as JAX's does."""
    _carry_init(monkeypatch, arch_id)
    argv = ["--arch", arch_id, "--ckpt-interval", "2", "--log-every", "1"]
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    want = _run_jax(monkeypatch, [*argv, "--steps", "4", "--ckpt-dir", jdir])
    got = _run_port(monkeypatch, [*argv, "--steps", "4", "--ckpt-dir", tdir])
    assert len(got) == len(want) == 4
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert np.isfinite(got).all() and got[-1] < got[0]
    capsys.readouterr()
    want = _run_jax(monkeypatch, [*argv, "--steps", "6", "--ckpt-dir", jdir])
    got = _run_port(monkeypatch, [*argv, "--steps", "6", "--ckpt-dir", tdir])
    printed = capsys.readouterr().out
    assert printed.count("resumed from checkpoint step 4") == 2
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_train_cli_nequip_diverges_as_jax_does(tmp_path, monkeypatch):
    """NequIP's gradients are non-finite on the trainer's molecule batch
    (it has atoms that receive no edge: ROADMAP C), so both trainers stop
    on their finiteness assertion."""
    batch = C.batch_molecules(8, 12, 24, seed=0)
    assert (np.bincount(batch["receivers"], minlength=96) == 0).any()
    argv = ["--arch", "nequip", "--steps", "3", "--ckpt-interval", "100"]
    monkeypatch.setattr(sys, "argv", ["train", *argv, "--ckpt-dir",
                                      str(tmp_path / "jax")])
    with pytest.raises(AssertionError, match="training diverged"):
        jtrain.main()
    with pytest.raises(AssertionError, match="training diverged"):
        train.main([*argv, "--device", "cpu", "--ckpt-dir",
                    str(tmp_path / "port")])
