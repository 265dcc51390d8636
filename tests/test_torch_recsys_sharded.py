"""The port's sharded two-tower bundles (``launch.steps.build_recsys``, run by
``runtime.recsys_sharded`` on a mesh of CPU entries) against the JAX
package's jitted bundles and against the port's own one-card model.

JAX's side runs in a child process with 4 forced host devices, once a
session however many test workers ask for it (``shared_jax_run``):
``jax.jit(bundle.fn, in_shardings=..., out_shardings=...)`` of
``repro.launch.steps.build_recsys`` for an ``ArchDef`` carrying the smoke
config (vocabulary 4,096, f32 tables), from params drawn by JAX's
``init_params`` and batches from ``make_batch``'s seeded generator; the
child saves inputs and outputs to one ``.npz``. The port places the same
inputs by its bundle's ``in_shardings`` and runs its ``fn``. The cases:
train, pairwise serving with the pairs split over every axis (16), over
the data axes (6) or replicated (3, on (data 2, model 2)), and retrieval
(1 query x 64 candidates), under the ``baseline`` and ``opt`` schemes, on
(data 2, model 2) and (data 1, model 4).

Tolerances (f32; the bags are summed per row block and then across
blocks in rank order, not in one slot-ordered sum): loss, metrics and
scores within 2e-6 (``rtol``, or relative L2 for scores); params, ``mu``
and ``nu`` within 2e-5 relative L2 a leaf; ``count`` exact. A row
block's table gradient is bit-equal to the plain backward
(``embedding_bag_backward_ref``) of the same bag gradient.
"""
import hashlib
import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS
from repro_torch.configs.base import ArchDef
from repro_torch.configs.shapes import RecSysShape
from repro_torch.kernels.embedding_bag.ref import embedding_bag_backward_ref
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import gather, make_mesh, place_tree
from repro_torch.models import recsys as RS
from repro_torch.optim.optimizers import opt_state_from_jax
from repro_torch.runtime import collectives as C
from repro_torch.runtime import recsys_sharded as RSS
from test_torch_engine import release_jax_executables  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"d2m2": (2, 2), "d1m4": (1, 4)}
SCHEMES = ("baseline", "opt")
# (kind, batch, candidates)
KINDS = [("train", 16, 0), ("serve", 16, 0), ("serve", 6, 0),
         ("retrieval", 1, 64)]
CASES = [(m, sch, k, b, nc) for m in MESHES for sch in SCHEMES
         for k, b, nc in KINDS] + \
        [("d2m2", sch, "serve", 3, 0) for sch in SCHEMES]
STATE_REL = 2e-5
METRIC_RTOL = 2e-6


def _key(case) -> str:
    return "|".join(str(x) for x in case)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread a test (restored after it): the mesh programs
    issue many tiny ops, and six test workers each spinning eight OpenMP
    threads beside a JAX child took 216 s for this file and
    ``test_torch_gnn_mesh.py`` at ``-n 6``, against 85 s with one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def shared_jax_run(tmp_path_factory, script: str, args: list,
                   timeout: float) -> dict:
    """The ``.npz`` arrays ``script`` (run as ``python -c script args...
    PATH`` with the JAX package on the path) saves, computed once for the
    session: the first test worker to ask runs it, the others wait for
    its file."""
    base = tmp_path_factory.getbasetemp()
    root = base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base
    tag = hashlib.sha1((script + json.dumps(args)).encode()).hexdigest()[:16]
    path, lock = root / f"jax_{tag}.npz", root / f"jax_{tag}.lock"
    err = root / f"jax_{tag}.err"
    try:
        os.close(os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY))
        mine = True
    except FileExistsError:
        mine = False
    if mine:
        env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
                   JAX_PLATFORMS="cpu")
        tmp = root / f"jax_{tag}.tmp.npz"
        out = subprocess.run(
            [sys.executable, "-c", textwrap.dedent(script), *args, str(tmp)],
            capture_output=True, text=True, env=env, timeout=timeout)
        if out.returncode != 0:
            err.write_text(out.stderr[-4000:] or "failed")
        else:
            os.replace(tmp, path)
    t = time.monotonic()
    while not path.exists() and not err.exists():
        if time.monotonic() - t > timeout:
            raise TimeoutError(f"no JAX result at {path}")
        time.sleep(0.5)
    if err.exists():
        raise AssertionError(err.read_text())
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


JAX_CHILD = """
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
import numpy as np
from repro.configs import ARCHS
from repro.configs.base import ArchDef
from repro.configs.shapes import RecSysShape
from repro.launch.mesh import make_mesh_compat
from repro.launch.steps import build_recsys, make_opt
from repro.models import recsys as RS

cases, meshes, path = json.loads(sys.argv[1]), json.loads(sys.argv[2]), \\
    sys.argv[3]
cfg = ARCHS["two-tower-retrieval"].smoke_config
arch = ArchDef("two-tower-retrieval", "recsys", cfg, cfg, "smoke")
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

for n, (mesh_key, scheme, kind, b, nc) in enumerate(cases):
    key = "|".join(str(x) for x in (mesh_key, scheme, kind, b, nc))
    mesh = make_mesh_compat(tuple(meshes[mesh_key]), ("data", "model"))
    bundle = build_recsys(arch, RecSysShape("case", kind, b, nc), mesh,
                          scheme)
    params = RS.init_params(jax.random.PRNGKey(n), cfg)
    batch = RS.make_batch(cfg, b, seed=n)
    if kind == "train":
        args = (params, make_opt().init(params), batch)
    elif kind == "retrieval":
        rng = np.random.default_rng(n)
        args = (params, {"user_ids": batch["user_ids"],
                         "cand_item_emb": rng.standard_normal(
                             (nc, cfg.tower_mlp[-1])).astype(np.float32)})
    else:
        args = (params, {k: batch[k] for k in ("user_ids", "item_ids")})
    put(f"{key}/in", args)
    fn = jax.jit(bundle.fn, in_shardings=bundle.in_shardings,
                 out_shardings=bundle.out_shardings)
    put(f"{key}/out", jax.device_get(fn(*args)))
np.savez(path, **out)
"""


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    return shared_jax_run(tmp_path_factory, JAX_CHILD,
                          [json.dumps(CASES), json.dumps(MESHES)], 900)


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


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    den = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / (den if den else 1.0))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


CFG = ARCHS["two-tower-retrieval"].smoke_config
ARCH = ArchDef("two-tower-retrieval", "recsys", CFG, CFG, "smoke")


def _mesh(mesh_key):
    return make_mesh(MESHES[mesh_key], ("data", "model"),
                     devices=["cpu"] * 4)


def _bundle(case):
    mesh_key, scheme, kind, b, nc = case
    return S.build_recsys(ARCH, RecSysShape("case", kind, b, nc),
                          _mesh(mesh_key), scheme)


def _inputs(runs, case):
    ins = _tree(runs, f"{_key(case)}/in")
    params = RS.params_from_jax(ins["0"], CFG, "cpu")
    if case[2] == "train":
        return (params, opt_state_from_jax(ins["1"], params),
                {k: torch.from_numpy(v) for k, v in ins["2"].items()})
    return (params, {k: torch.from_numpy(v) for k, v in ins["1"].items()})


def _run_port(runs, case):
    bundle = _bundle(case)
    args = _inputs(runs, case)
    C.reset_wire_bytes()
    return bundle, args, bundle.fn(*place_tree(args, bundle.in_shardings))


def _check_train(got, want):
    params, state, metrics = got
    for k, v in metrics.items():
        np.testing.assert_allclose(float(gather(v)), float(want["2"][k]),
                                   rtol=METRIC_RTOL, err_msg=k)
    assert int(gather(state["count"])) == int(want["1"]["count"]) == 1
    for name, tree, ref in (("params", params, want["0"]),
                            ("mu", state["mu"], want["1"]["mu"]),
                            ("nu", state["nu"], want["1"]["nu"])):
        refs = dict(_flat(ref))
        for path, x in _flat(tree):
            assert _rel(gather(x), refs[path]) <= STATE_REL, (name, path)


@pytest.mark.parametrize("case", CASES, ids=_key)
def test_sharded_recsys_matches_jax_bundle(case, jax_runs):
    bundle, _, got = _run_port(jax_runs, case)
    if case[2] == "train":
        _check_train(got, _tree(jax_runs, f"{_key(case)}/out"))
        return
    want = jax_runs[f"{_key(case)}/out"]
    assert tuple(got.shape) == want.shape
    assert tuple(got.spec) == tuple(bundle.out_shardings.spec)
    assert _rel(gather(got), want) <= METRIC_RTOL


def _one_card(case, args):
    kind = case[2]
    if kind == "train":
        params, state, batch = args
        return S.train_step(RS.loss_fn, CFG, S.make_opt())(params, state,
                                                           batch)
    params, batch = args
    fn = RS.score_candidates if kind == "retrieval" else RS.serve_score
    return fn(params, batch, CFG)


@pytest.mark.parametrize("case", [c for c in CASES if c[0] == "d2m2"],
                         ids=_key)
def test_sharded_recsys_matches_one_card(case, jax_runs):
    _, args, got = _run_port(jax_runs, case)
    want = _one_card(case, _inputs(jax_runs, case))
    if case[2] != "train":
        assert _rel(gather(got), want) <= METRIC_RTOL
        return
    for k, v in want[2].items():
        np.testing.assert_allclose(float(gather(got[2][k])), float(v),
                                   rtol=METRIC_RTOL, err_msg=k)
    for (path, x), (_, y) in zip(_flat(got[1]["mu"]), _flat(want[1]["mu"])):
        assert _rel(gather(x), y) <= STATE_REL, path
    for (path, x), (_, y) in zip(_flat(got[0]), _flat(want[0])):
        assert _rel(gather(x), y) <= STATE_REL, path


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("mesh_key", list(MESHES))
def test_block_table_gradient_is_the_plain_backward(scheme, mesh_key):
    """Each entry's row block of the table gradient, for a bag gradient on
    the first entry's bags, is bit-equal to the plain backward of that
    gradient divided by the global count, at the block's shifted ids —
    and to those rows of the one-card gradient (``mean`` mode)."""
    mesh = _mesh(mesh_key)
    ctx = RSS.Ctx(mesh, CFG, scheme)
    rng = np.random.default_rng(3)
    v, d, b = CFG.user_vocab, CFG.embed_dim, 12
    table = torch.from_numpy(rng.standard_normal((v, d)).astype(np.float32))
    ids = rng.integers(-1, v, (b, CFG.field_slots)).astype(np.int32)
    ids[0] = -1                                  # a bag with no valid id
    ids[1, :2] = 7                               # a row twice in one bag
    ids = torch.from_numpy(ids)
    rows = v // ctx.size(ctx.rows)
    blocks = [table[ctx.entry_slice(ctx.rows, v, e)].clone()
              .requires_grad_(True) for e in range(ctx.n)]
    id_axes = ctx.da
    shards = [ids[ctx.entry_slice(id_axes, b, e)] for e in range(ctx.n)]
    out = RSS.bags(ctx, blocks, shards, id_axes)
    g = torch.from_numpy(rng.standard_normal(out[0].shape)
                         .astype(np.float32))
    torch.autograd.backward([out[0]], [g])
    mine = shards[0]
    cnt = torch.clamp((mine >= 0).sum(1, keepdim=True, dtype=torch.int32),
                      min=1)
    full = embedding_bag_backward_ref(g, mine, v, mode="mean")
    for e in range(ctx.n):
        if any(ctx.at[a][e] != 0 for a in ctx.da if a not in ctx.rows):
            continue                   # a copy that fed no entry-0 bag
        want = embedding_bag_backward_ref(
            g / cnt.to(g.dtype), RSS._block_ids(ctx, mine, rows, e), rows,
            mode="sum")
        assert torch.equal(blocks[e].grad, want), e
        assert torch.equal(blocks[e].grad,
                           full[ctx.entry_slice(ctx.rows, v, e)]), e


def test_opt_drops_the_table_gradient_all_reduce(jax_runs):
    """Under ``baseline`` the row blocks are copies over ``data`` and their
    dense gradients are all-reduced there (the step's largest
    collective); under ``opt`` no block has a copy."""
    table_bytes = 2 * (CFG.user_vocab // 2) * CFG.embed_dim * 4
    wire = {}
    for scheme in SCHEMES:
        _run_port(jax_runs, ("d2m2", scheme, "train", 16, 0))
        wire[scheme] = {op: sum(v.values())
                        for op, v in C.wire_bytes().items()}
    # 2 (g - 1) / g = 1 at g = 2, on each of 4 entries
    assert wire["baseline"]["all_reduce"] >= 4 * table_bytes
    assert wire["opt"]["all_reduce"] < table_bytes
    assert wire["opt"]["reduce_scatter"] > 0


def test_bundle_refuses_an_argument_placed_otherwise():
    """A recsys or GNN bundle's ``fn``, like an LM one's, takes its
    arguments placed as ``in_shardings`` and raises on any other."""
    mesh = _mesh("d2m2")
    params = RS.init_params(CFG, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in
             RS.make_batch(CFG, 16, seed=0).items() if k != "log_q"}
    b = _bundle(("d2m2", "baseline", "serve", 16, 0))
    placed = place_tree(params, b.in_shardings[0])
    with pytest.raises(ValueError, match="argument 1/user_ids must be placed"):
        b.fn(placed, batch)
    opt_sh = S._recsys_param_shardings(params, mesh, all_axes=True)
    with pytest.raises(ValueError, match="argument 0/item_table is placed"):
        b.fn(place_tree(params, opt_sh), place_tree(batch, b.in_shardings[1]))
