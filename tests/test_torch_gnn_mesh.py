"""The port's sharded GNN bundles (``launch.steps.build_gnn``, run by
``runtime.gnn_mesh`` on a (data 2, model 2) mesh of CPU entries, and
``build_gnn_halo``, run by ``runtime.gnn_halo_train``'s mesh program)
against the JAX package's jitted bundles and against the port's own
one-card steps.

JAX's side runs in a child process with 4 forced host devices, once a
session (``test_torch_recsys_sharded.shared_jax_run``): for each of the
four archs at its smoke config, on a full graph (a 60-node mesh graph), a
fanout-sampled minibatch of it and a batch of 8 molecules (and SchNet on
6, whose targets stay whole on every entry), ``jax.jit(bundle.fn,
in_shardings=..., out_shardings=...)`` of ``repro.launch.steps.
build_gnn`` from JAX's ``init_params`` and the JAX package's batch
builders, padded to the bundle's specs, and the unsharded loss's jitted
gradient. The halo case takes a 400-node mesh graph's SDP layout at P = 4
(the port's CPU session, as ``tests/test_torch_halo.py``); the child
builds JAX's ``build_gnn_halo`` from an ``artifacts/halo_frac.json``
holding the layout's boundary fraction in its working directory, and so
does the port (``monkeypatch.chdir``). The child saves inputs and outputs
to one ``.npz``; the port places the same inputs by its bundle's
``in_shardings`` and runs its ``fn``.

Tolerances (f32): loss and metrics within ``rtol`` 2e-6; params, ``mu``,
``nu`` and each gradient leaf within 2e-5 relative L2 over the entries
finite on both sides, the non-finite entries the same (NequIP's, as
JAX's: ROADMAP C); ``count`` exact. PNA's f32 bundle against JAX's: its
loss and metrics within 1e-4, params, ``mu`` and ``nu`` within 1e-2
(AdamW's first step moves a param by ~lr whatever its gradient's size) —
its std
aggregator multiplies an error in a near-zero variance by up to 5,000
(``models.gnn.pna``'s docstring) and XLA rounds ``sq - mean**2`` once, so
two f32 implementations part there (molecule: the loss 1.5e-5 apart,
``mu`` 1.3e-3) — so PNA's mesh
gradients are held to JAX's in f64 (the mesh program run on f64 params
and batch), at 2e-5, as ``tests/test_torch_gnn.py`` holds the one-card
PNA; against the port's one-card PNA the mesh holds 2e-5 in f32.
The mesh's segment sums are f64
partials reduce-scattered in f64 and rounded once, so against the port's
one-card step (its sums f64-accumulated too) they sit ~1e-7 apart; the
matmuls on edge and node shards round as the one-card ones do.
"""
import json

import numpy as np
import pytest
import torch

from test_torch_recsys_sharded import one_thread, shared_jax_run  # noqa: F401

from repro_torch.configs import ARCHS
from repro_torch.configs.base import ArchDef
from repro_torch.configs.shapes import GNNShape
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import gather, make_mesh, place_tree
from repro_torch.models import layers as L
from repro_torch.models.gnn import pna as PNA
from repro_torch.optim.optimizers import opt_state_from_jax
from repro_torch.runtime import collectives as C
from repro_torch.runtime import gnn_halo_train as GH
from repro_torch.runtime import gnn_mesh as GM
from test_torch_engine import release_jax_executables  # noqa: F401

ARCH_IDS = ("meshgraphnet", "pna", "schnet", "nequip")
GRAPH = ("mesh", 60, 150, 0)
SHAPES = {
    "full": dict(name="full", kind="full", n_nodes=0, n_edges=0, d_feat=8),
    "minibatch": dict(name="minibatch", kind="minibatch", n_nodes=0,
                      n_edges=0, d_feat=8, batch_nodes=8, fanout=[3, 2]),
    "molecule": dict(name="molecule", kind="molecule", n_nodes=6,
                     n_edges=10, mol_batch=8),
    "molecule6": dict(name="molecule6", kind="molecule", n_nodes=6,
                      n_edges=10, mol_batch=6),
}
CASES = [(a, s) for a in ARCH_IDS for s in ("full", "minibatch",
                                             "molecule")] + \
        [("schnet", "molecule6")]
HALO_GRAPH = ("mesh", 400, 1100, 1)
STATE_REL = 2e-5
METRIC_RTOL = 2e-6
PNA_JAX_REL = 1e-2
PNA_JAX_METRIC_RTOL = 1e-4


def _key(case) -> str:
    return "|".join(case)


JAX_CHILD = """
import json, os, sys, tempfile
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
import numpy as np
from repro.configs import ARCHS
from repro.configs.base import ArchDef
from repro.configs.shapes import GNNShape
from repro.graph import halo as H
from repro.graph.generators import make_graph
from repro.graph.sampler import make_minibatch
from repro.launch.mesh import make_mesh_compat
from repro.launch.steps import _GNN_MODELS, build_gnn, build_gnn_halo, make_opt
from repro.models.gnn.common import batch_molecules, graph_to_batch

cases, shapes, graph, halo_graph, path = (
    json.loads(sys.argv[1]), json.loads(sys.argv[2]), json.loads(sys.argv[3]),
    json.loads(sys.argv[4]), sys.argv[5])
mesh = make_mesh_compat((2, 2), ("data", "model"))
g = make_graph(*graph[:3], seed=graph[3])
out = {}

def put(prefix, tree):
    if isinstance(tree, dict):
        for k, v in tree.items():
            put(f"{prefix}/{k}", v)
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            put(f"{prefix}/{i}", v)
    else:
        out[prefix] = np.asarray(tree)

def fit(bn, specs):
    res = {}
    for k, sp in specs.items():
        x = np.asarray(bn[k])
        fill = -1 if k in ("senders", "receivers", "graph_id",
                           "publish_idx", "halo_map") else 0
        p = np.full(sp.shape, fill, dtype=sp.dtype)
        p[tuple(slice(0, s) for s in x.shape)] = x
        res[k] = p
    return res

def arch_of(arch_id):
    cfg = ARCHS[arch_id].smoke_config
    return cfg, ArchDef(arch_id, "gnn", cfg, cfg, "smoke",
                        gnn_inputs=ARCHS[arch_id].gnn_inputs)

def params_of(arch_id, cfg, n, d_feat):
    key = jax.random.PRNGKey(n)
    mod = _GNN_MODELS[arch_id]
    if arch_id in ("meshgraphnet", "pna"):
        return mod.init_params(key, cfg=cfg, d_node=d_feat)
    return mod.init_params(key, cfg=cfg)

def run(key, bundle, params, batch, loss_fn, cfg):
    args = (params, make_opt().init(params), batch)
    put(f"{key}/in", args)
    fn = jax.jit(bundle.fn, in_shardings=bundle.in_shardings,
                 out_shardings=bundle.out_shardings)
    put(f"{key}/out", jax.device_get(fn(*args)))
    put(f"{key}/grad", jax.device_get(jax.jit(jax.grad(
        lambda p: loss_fn(p, batch, cfg)[0]))(params)))
    if key.startswith("pna"):
        with jax.enable_x64(True):
            p64 = jax.tree.map(lambda x: np.asarray(x, np.float64), params)
            b64 = {k: v.astype(np.float64) if v.dtype == np.float32 else v
                   for k, v in batch.items()}
            put(f"{key}/grad64", jax.device_get(jax.jit(jax.grad(
                lambda p: loss_fn(p, b64, cfg)[0]))(p64)))

for n, (arch_id, shape_key) in enumerate(cases):
    cfg, arch = arch_of(arch_id)
    sh = dict(shapes[shape_key])
    if sh["kind"] != "molecule":
        sh.update(n_nodes=g.n, n_edges=g.num_edges)
    sh["fanout"] = tuple(sh.get("fanout", ()))
    bundle = build_gnn(arch, GNNShape(**sh), mesh)
    specs = bundle.specs[2]
    d_feat = specs["node_feat"].shape[1] if "node_feat" in specs else 0
    if sh["kind"] == "full":
        bn = graph_to_batch(g, sh["d_feat"], seed=n, with_positions=True)
    elif sh["kind"] == "minibatch":
        bn = make_minibatch(g, sh["d_feat"], sh["batch_nodes"], sh["fanout"],
                            seed=n)
    else:
        bn = batch_molecules(sh["mol_batch"], sh["n_nodes"], sh["n_edges"],
                             seed=n, d_feat=16)
    run("|".join((arch_id, shape_key)), bundle,
        params_of(arch_id, cfg, n, d_feat), fit(bn, specs),
        _GNN_MODELS[arch_id].loss_fn, cfg)

# the halo bundle over a small graph's SDP layout (the port's CPU session)
from repro_torch.api import Partitioner
from repro_torch.core.config import EngineConfig
from repro_torch.graph import generators as tgen, stream as tstream
tg = tgen.make_graph(*halo_graph[:3], seed=halo_graph[3])
s = tstream.build_stream(tg, seed=0)
part = Partitioner.from_stream(s, EngineConfig(k_max=4, k_init=4,
                                               autoscale=False),
                               policy="sdp", device="cpu").feed(s)
assign = part.state.assignment.numpy().copy()
assign[assign < 0] = 0
hg = make_graph(*halo_graph[:3], seed=halo_graph[3])
spec = H.build_halo_spec(hg, assign, 4)
nb = spec.block_size
frac = (max(spec.publish_size, -(-spec.halo_size // 4)) + 0.5) / nb
n_edges = max(hg.num_edges, int(np.ceil(1.6 * spec.senders.shape[1])))
os.chdir(tempfile.mkdtemp())
os.makedirs("artifacts")
with open("artifacts/halo_frac.json", "w") as f:
    json.dump({"halo": {"sdp": frac}}, f)
cfg, arch = arch_of("meshgraphnet")
bundle = build_gnn_halo(arch, GNNShape("halo", "full", 4 * nb, n_edges,
                                       d_feat=8), mesh)
bn = graph_to_batch(hg, 8, seed=0)
hb = {"node_feat": H.scatter_nodes(spec, bn["node_feat"]),
      "targets": H.scatter_nodes(spec, bn["targets"]),
      "node_mask": H.scatter_nodes(spec, bn["node_mask"], fill=False),
      "publish_idx": spec.publish_idx, "halo_map": spec.halo_map,
      "senders": spec.senders, "receivers": spec.receivers}
args = (params_of("meshgraphnet", cfg, 99, 8), None, fit(hb, bundle.specs[2]))
args = (args[0], make_opt().init(args[0]), args[2])
put("halo/in", args)
fn = jax.jit(bundle.fn, in_shardings=bundle.in_shardings,
             out_shardings=bundle.out_shardings)
put("halo/out", jax.device_get(fn(*args)))
out["halo/frac"] = np.float64(frac)
out["halo/shape"] = np.array([4 * nb, n_edges, nb])
np.savez(path, **out)
"""


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    return shared_jax_run(tmp_path_factory, JAX_CHILD, [
        json.dumps(CASES), json.dumps(SHAPES), json.dumps(GRAPH),
        json.dumps(HALO_GRAPH)], 900)


def _tree(runs, prefix):
    out: dict = {}
    for k, v in runs.items():
        if not k.startswith(prefix + "/"):
            continue
        node = out
        keys = k[len(prefix) + 1:].split("/")
        for part in keys[:-1]:
            node = node.setdefault(part, {})
        node[keys[-1]] = v
    return out


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _close(got, want, what, rel=STATE_REL):
    """Relative L2 over the entries finite on both sides within ``rel``,
    and the same non-finite entries."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    fin = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), fin), what
    d, w = got[fin] - want[fin], want[fin]
    den = np.linalg.norm(w)
    assert np.linalg.norm(d) <= rel * (den if den else 1.0), what


def _arch(arch_id) -> ArchDef:
    cfg = ARCHS[arch_id].smoke_config
    return ArchDef(arch_id, "gnn", cfg, cfg, "smoke",
                   gnn_inputs=ARCHS[arch_id].gnn_inputs)


def _mesh():
    return make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)


def _shape(arch_id, shape_key) -> GNNShape:
    sh = dict(SHAPES[shape_key])
    if sh["kind"] != "molecule":
        from repro_torch.graph.generators import make_graph
        g = make_graph(*GRAPH[:3], seed=GRAPH[3])
        sh.update(n_nodes=g.n, n_edges=g.num_edges)
    sh["fanout"] = tuple(sh.get("fanout", ()))
    return GNNShape(**sh)


def _params(arch_id, np_params, cfg, batch):
    mod = S._GNN_MODELS[arch_id]
    if arch_id in ("meshgraphnet", "pna"):
        return mod.params_from_jax(np_params, cfg,
                                   batch["node_feat"].shape[-1], device="cpu")
    return mod.params_from_jax(np_params, cfg, device="cpu")


def _inputs(runs, prefix, arch_id, cfg):
    ins = _tree(runs, f"{prefix}/in")
    batch = {k: torch.from_numpy(v) for k, v in ins["2"].items()}
    params = _params(arch_id, ins["0"], cfg, batch)
    return params, opt_state_from_jax(ins["1"], params), batch


def _check_train(got, want, metric_rtol=METRIC_RTOL,
                 state_rel=STATE_REL):
    params, state, metrics = got
    for k, v in metrics.items():
        g, w = float(gather(v)), float(want["2"][k])
        assert np.isfinite(g) == np.isfinite(w), k
        if np.isfinite(w):
            np.testing.assert_allclose(g, w, rtol=metric_rtol, err_msg=k)
    assert int(gather(state["count"])) == int(want["1"]["count"]) == 1
    for name, tree, ref in (("params", params, want["0"]),
                            ("mu", state["mu"], want["1"]["mu"]),
                            ("nu", state["nu"], want["1"]["nu"])):
        refs = dict(_flat(ref))
        for path, x in _flat(tree):
            _close(gather(x), refs[path], (name, path), state_rel)


@pytest.mark.parametrize("case", CASES, ids=_key)
def test_gnn_mesh_matches_jax_bundle(case, jax_runs):
    arch_id, shape_key = case
    cfg = ARCHS[arch_id].smoke_config
    b = S.build_gnn(_arch(arch_id), _shape(arch_id, shape_key), _mesh())
    args = _inputs(jax_runs, _key(case), arch_id, cfg)
    C.reset_wire_bytes()
    got = b.fn(*place_tree(args, b.in_shardings))
    if arch_id == "pna":
        _check_train(got, _tree(jax_runs, f"{_key(case)}/out"),
                     PNA_JAX_METRIC_RTOL, PNA_JAX_REL)
    else:
        _check_train(got, _tree(jax_runs, f"{_key(case)}/out"))
    wire = C.wire_bytes()
    assert sum(wire["all_gather"].values()) > 0
    assert sum(wire["reduce_scatter"].values()) > 0


def _grads(loss_fn, params):
    leaves = [(k, x.detach().requires_grad_(True))
              for k, x in L.leaves(params)]
    tree: dict = {}
    for k, x in leaves:
        node = tree
        keys = k.split("/")
        for part in keys[:-1]:
            node = node.setdefault(part, {})
        node[keys[-1]] = x
    with torch.enable_grad():
        loss = loss_fn(tree)
        gs = torch.autograd.grad(loss, [x for _, x in leaves])
    return float(loss), {k: g for (k, _), g in zip(leaves, gs)}


def _sharded_grads(b, arch_id, cfg, params, batch):
    """The bundle's mesh program's loss and gradients (those of the first
    entry's leaves, which ``copy_to`` makes every copy's sum)."""
    ctx = GM.Ctx(_mesh())
    shards = {k: list(v.shards) for k, v in
              place_tree(batch, b.in_shardings[2]).items()}
    split = tuple(b.in_shardings[2]["targets"].spec) != () \
        and "graph_id" in batch
    rest = S._entry_trees(place_tree(params, b.in_shardings[0]), ctx.n)[1:]
    return _grads(lambda t: GM.loss(ctx, S._GNN_MODELS[arch_id], cfg,
                                    [t] + rest, shards, b.meta["n_nodes"],
                                    split)[0][0], params)


@pytest.mark.parametrize("case", CASES, ids=_key)
def test_gnn_mesh_gradients_match_one_card_and_jax(case, jax_runs):
    """The mesh program's loss and gradients against the port's one-card
    ``loss_fn`` and JAX's unsharded gradient: NequIP's non-finite entries
    (an atom or padded node no edge reaches) are the same on all three."""
    arch_id, shape_key = case
    cfg = ARCHS[arch_id].smoke_config
    b = S.build_gnn(_arch(arch_id), _shape(arch_id, shape_key), _mesh())
    params, _, batch = _inputs(jax_runs, _key(case), arch_id, cfg)
    mod = S._GNN_MODELS[arch_id]
    loss, grads = _sharded_grads(b, arch_id, cfg, params, batch)
    want_loss, want = _grads(lambda t: mod.loss_fn(t, batch, cfg)[0], params)
    np.testing.assert_allclose(loss, want_loss, rtol=METRIC_RTOL)
    for k, g in grads.items():
        _close(g, want[k], ("one card", k))
    if arch_id == "pna":                # JAX's f64 step (docstring)
        params = {k: v.double() for k, v in L.leaves(params)}
        params = S._nest(params)
        batch = {k: v.double() if v.dtype == torch.float32 else v
                 for k, v in batch.items()}
        _, grads = _sharded_grads(b, arch_id, cfg, params, batch)
    jax_grads = dict(_flat(_tree(jax_runs, f"{_key(case)}/grad" + (
        "64" if arch_id == "pna" else ""))))
    for k, g in grads.items():
        _close(g, jax_grads[f"/{k}"], ("jax", k))
    if case == ("nequip", "molecule"):  # 8 molecules' atoms with no in-edge
        assert any(not bool(torch.isfinite(g).all()) for g in grads.values())


def test_pna_extrema_share_ties_across_entries():
    """Every edge twice, the copies on other entries: PNA's max and min
    tie across entries, and the mesh shares each tie's gradient evenly,
    as one card's ``scatter_reduce`` does — the same loss and gradients
    as the one-card step."""
    from repro_torch.graph.generators import make_graph
    from repro_torch.models.gnn import common as GC
    cfg = ARCHS["pna"].smoke_config
    g = make_graph(*GRAPH[:3], seed=GRAPH[3])
    shape = GNNShape("twice", "full", g.n, 2 * g.num_edges, d_feat=8)
    b = S.build_gnn(_arch("pna"), shape, _mesh())
    bn = GC.graph_to_batch(g, 8, seed=0)
    e = b.specs[2]["senders"].shape[0]
    twice = dict(bn, **{k: np.concatenate([bn[k], bn[k]])
                        for k in ("senders", "receivers")})
    batch = {k: torch.from_numpy(v)
             for k, v in GC.fit_batch(twice, b.specs[2]).items()}
    assert e >= 4 * g.num_edges
    params = PNA.init_params(cfg, 8, generator=torch.Generator()
                             .manual_seed(0), device="cpu")
    loss, grads = _sharded_grads(b, "pna", cfg, params, batch)
    want_loss, want = _grads(lambda t: PNA.loss_fn(t, batch, cfg)[0], params)
    np.testing.assert_allclose(loss, want_loss, rtol=METRIC_RTOL)
    for k, gr in grads.items():
        _close(gr, want[k], k)


def test_fit_batch_pads_rows_and_never_cuts():
    """``fit_batch`` pads a batch's rows to a bundle's specs (index leaves
    with -1, the rest with 0) and raises where a leaf has more rows than
    its spec holds."""
    from repro_torch.graph.generators import make_graph
    from repro_torch.models.gnn import common as GC
    g = make_graph(*GRAPH[:3], seed=GRAPH[3])
    bn = GC.graph_to_batch(g, 8, seed=0, with_positions=True)
    shape = GNNShape("t", "full", g.n + 5, g.num_edges + 7, d_feat=8)
    specs = S.build_gnn(_arch("meshgraphnet"), shape, _mesh()).specs[2]
    fit = GC.fit_batch(bn, specs)
    assert sorted(fit) == sorted(specs)
    for k, v in fit.items():
        assert v.shape == tuple(specs[k].shape), k
        n = bn[k].shape[0]
        assert np.array_equal(v[:n], bn[k]), k
        want = -1 if k in GC.INDEX_LEAVES else 0
        assert (v[n:] == want).all(), k
    small = GNNShape("s", "full", g.n - 8, g.num_edges, d_feat=8)
    with pytest.raises(ValueError, match="does not fit the bundle"):
        GC.fit_batch(bn, S.build_gnn(_arch("meshgraphnet"), small,
                                     _mesh()).specs[2])


def test_halo_graph_has_no_global_node_reads():
    """The halo program's graph holds block-local node ids: it reads and
    sums within the block and the exchange, and has none of the
    graph-parallel program's reads by global id."""
    for name in ("max", "min", "mean", "degree", "own"):
        assert hasattr(GM.Graph, name)
        assert not hasattr(GH.HaloGraph, name), name
    for name in ("map", "gather", "sum", "loss"):
        assert hasattr(GH.HaloGraph, name)


@pytest.fixture
def halo_dir(jax_runs, tmp_path, monkeypatch):
    """A working directory whose ``artifacts/halo_frac.json`` holds the
    JAX child's boundary fraction, as the child's did."""
    (tmp_path / "artifacts").mkdir()
    (tmp_path / "artifacts" / "halo_frac.json").write_text(json.dumps(
        {"halo": {"sdp": float(jax_runs["halo/frac"])}}))
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _halo_bundle(jax_runs):
    n_nodes, n_edges, _ = (int(x) for x in jax_runs["halo/shape"])
    return S.build_gnn_halo(_arch("meshgraphnet"),
                            GNNShape("halo", "full", n_nodes, n_edges,
                                     d_feat=8), _mesh())


def test_halo_mesh_matches_jax_bundle(jax_runs, halo_dir):
    b = _halo_bundle(jax_runs)
    assert b.meta["halo_frac"] == float(jax_runs["halo/frac"])
    cfg = ARCHS["meshgraphnet"].smoke_config
    args = _inputs(jax_runs, "halo", "meshgraphnet", cfg)
    C.reset_wire_bytes()
    got = b.fn(*place_tree(args, b.in_shardings))
    _check_train(got, _tree(jax_runs, "halo/out"))
    # the exchange: each layer's (B_max, F) published rows, all-gathered
    # once a layer (the smoke config has no remat to run it again)
    b_max = b.specs[2]["publish_idx"].shape[1]
    per_entry = 4 * b_max * cfg.d_hidden * 4 * 3 / 4
    assert C.wire_bytes()["all_gather"][0] == per_entry * cfg.n_layers


def test_halo_mesh_matches_stacked_path(jax_runs, halo_dir):
    """The mesh program against the stacked one-device path
    (``mgn_halo_local_loss``) on the same blocks: loss and gradients."""
    b = _halo_bundle(jax_runs)
    cfg = ARCHS["meshgraphnet"].smoke_config
    params, _, batch = _inputs(jax_runs, "halo", "meshgraphnet", cfg)
    nb = b.specs[2]["node_feat"].shape[1]
    mesh = _mesh()
    ctx = GM.Ctx(mesh)
    shards = {k: list(v.shards) for k, v in
              place_tree(batch, b.in_shardings[2]).items()}
    placed = place_tree(params, b.in_shardings[0])
    rest = S._entry_trees(placed, ctx.n)[1:]
    loss, grads = _grads(lambda t: GH.mgn_halo_mesh_loss(
        ctx, cfg, [t] + rest, shards, nb)[0][0], params)
    stacked = GH.make_mgn_halo_loss(cfg, nb)
    want_loss, want = _grads(lambda t: stacked(t, batch)[0], params)
    np.testing.assert_allclose(loss, want_loss, rtol=METRIC_RTOL)
    for k, g in grads.items():
        _close(g, want[k], k)


def test_halo_layout_larger_than_the_bundle_raises():
    """``fit_batch(..., axis=1)`` pads a layout's arrays to a halo
    bundle's specs and raises where the layout has more published rows,
    halo rows, edges or block rows than the bundle holds: a layout is
    never cut."""
    from repro_torch.graph.generators import make_graph
    from repro_torch.graph.halo import build_halo_spec
    from repro_torch.models.gnn import common as GC
    g = make_graph(*HALO_GRAPH[:3], seed=HALO_GRAPH[3])
    spec = build_halo_spec(g, np.arange(g.n) % 4, 4)
    bn = GC.graph_to_batch(g, 8, seed=0)
    hb = GH.halo_batch(spec, bn["node_feat"], bn["targets"])
    shape = GNNShape("t", "full", g.n, g.num_edges, d_feat=8)
    b = S.build_gnn_halo(_arch("meshgraphnet"), shape, _mesh(), layout=spec)
    fit = GC.fit_batch(hb, b.specs[2], axis=1)
    for k, v in fit.items():
        assert v.shape == tuple(b.specs[2][k].shape), k
        x = np.asarray(hb[k])
        assert np.array_equal(v[:, :x.shape[1]], x), k
        if k in ("publish_idx", "halo_map", "senders", "receivers"):
            assert (v[:, x.shape[1]:] == -1).all(), k
    assert b.meta["b_max"] >= spec.publish_size
    # JAX's rule at frac 0.5 holds fewer published and halo rows than
    # this hash layout has
    small = S.build_gnn_halo(_arch("meshgraphnet"), shape, _mesh())
    assert small.specs[2]["publish_idx"].shape[1] < spec.publish_size
    with pytest.raises(ValueError, match="does not fit the bundle"):
        GC.fit_batch(hb, small.specs[2], axis=1)
