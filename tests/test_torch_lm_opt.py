"""The port's LM ``opt`` train step (``launch.steps.build_lm(...,
scheme="opt")``: ZeRO-3 weights, sequence parallelism, two microbatches,
run by ``runtime.lm_seqpar`` on a mesh of CPU entries) against the JAX
package's jitted ``opt`` bundle and against the port's one-card
``train_step(micro=2)``.

JAX's side runs in a child process with 4 forced host devices, once a
session (``test_torch_recsys_sharded.shared_jax_run``): ``jax.jit``
of ``repro.launch.steps.build_lm(..., scheme="opt")`` inside ``with
mesh:`` (the scheme's bare ``PartitionSpec`` constraints need an ambient
mesh, as ``launch/dryrun.py`` provides one), from params drawn by JAX's
``init_params``, fresh AdamW moments and a batch from numpy's seeded
generator; it saves inputs and outputs to one ``.npz``. The port places
the same inputs by its bundle's ``in_shardings`` and runs its ``fn``. The
cases (arch, mesh, global batch, seq):

* gemma2 (both softcaps, local and global windows, GQA, a tied embedding)
  on (data 2, model 2) at B = 8: two rows a data rank in each microbatch;
* moonshot (MoE) on (data 2, model 2) at B = 8 — each entry's tokens span
  two of JAX's dispatch groups (``tp | R``: an all-to-all turns the
  sequence split into a row split) and microbatch 0's rows all start on
  data rank 0 —, on (data 1, model 4) at B = 2 (one row: each entry's
  block is one group) and at B = 4 (two rows over four entries, ``R |
  tp``: one row segment to each of two entries);
* phi3 (dense, untied), deepseek (7 heads, one KV head) on (data 2, model
  2);
* gemma2 at S = 1,024 on (data 1, model 4): JAX's online softmax over
  512-key chunks (``attention_kv_chunked``).

Tolerances are ``test_torch_lm_sharded.py``'s (f32): the loss within rtol
2e-6; params, ``mu`` and ``nu`` within 2e-5 relative L2 a leaf;
``count`` exact. The same bundles are held to the one-card step on the
bundle's config, and their wire counters to a count worked out from the
specs with ``collectives.ring_wire_bytes``; on a (pod 2, data 2, model 2)
mesh gemma2's and moonshot's steps are held to the one-card step.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS
from repro_torch.configs.base import ArchDef
from repro_torch.configs.shapes import LMShape
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import (
    _block_slices, gather, make_mesh, place_tree,
)
from repro_torch.models import transformer as T
from repro_torch.optim.optimizers import opt_state_from_jax, tree_paths
from repro_torch.runtime import collectives as C
from repro_torch.runtime import lm_seqpar as SP

from test_torch_lm_sharded import (
    METRIC_RTOL, STATE_REL, _flat, _rel, _tree,
)
from test_torch_recsys_sharded import one_thread, shared_jax_run  # noqa: F401
from test_torch_engine import release_jax_executables  # noqa: F401

MESHES = {"d2m2": (2, 2), "d1m4": (1, 4)}
CASES = [("gemma2-9b", "d2m2", 8, 16), ("moonshot-v1-16b-a3b", "d2m2", 8, 16),
         ("moonshot-v1-16b-a3b", "d1m4", 2, 16),
         ("moonshot-v1-16b-a3b", "d1m4", 4, 16),
         ("phi3-mini-3.8b", "d2m2", 4, 16),
         ("deepseek-coder-33b", "d2m2", 4, 16),
         ("gemma2-9b", "d1m4", 2, 1024)]


def _key(case) -> str:
    return "|".join(str(x) for x in case)


JAX_CHILD = """
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses
import jax
import numpy as np
from repro.configs import ARCHS
from repro.configs.base import ArchDef
from repro.configs.shapes import LMShape
from repro.launch.mesh import make_mesh_compat
from repro.launch.steps import build_lm, make_opt
from repro.models import transformer as T

cases, meshes, path = json.loads(sys.argv[1]), json.loads(sys.argv[2]), \\
    sys.argv[3]
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

for n, (arch_id, mesh_key, b, s) in enumerate(cases):
    key = "|".join(str(x) for x in (arch_id, mesh_key, b, s))
    cfg = dataclasses.replace(ARCHS[arch_id].smoke_config, n_layers=2)
    arch = ArchDef(arch_id, "lm", cfg, cfg, "smoke")
    mesh = make_mesh_compat(tuple(meshes[mesh_key]), ("data", "model"))
    bundle = build_lm(arch, LMShape("case", "train", s, b), mesh, "opt")
    params = T.init_params(jax.random.PRNGKey(100 + n), cfg)
    rng = np.random.default_rng(100 + n)
    batch = {k: rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
             for k in ("labels", "tokens")}
    args = (params, make_opt().init(params), batch)
    put(f"{key}/in", args)
    with mesh:
        fn = jax.jit(bundle.fn, in_shardings=bundle.in_shardings,
                     out_shardings=bundle.out_shardings)
        put(f"{key}/out", jax.device_get(fn(*args)))
np.savez(path, **out)
"""


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """JAX's runs, once a session however many test workers ask."""
    return shared_jax_run(tmp_path_factory, JAX_CHILD,
                          [json.dumps(CASES), json.dumps(MESHES)], 900)


def _arch(arch_id) -> ArchDef:
    cfg = dataclasses.replace(ARCHS[arch_id].smoke_config, n_layers=2)
    return ArchDef(arch_id, "lm", cfg, cfg, "smoke")


def _mesh(mesh_key):
    return make_mesh(MESHES[mesh_key], ("data", "model"),
                     devices=["cpu"] * 4)


def _setup(case, runs):
    arch_id, mesh_key, b, s = case
    arch, mesh = _arch(arch_id), _mesh(mesh_key)
    shape = LMShape("case", "train", s, b)
    bundle = S.build_lm(arch, shape, mesh, "opt")
    ins = _tree(runs, f"{_key(case)}/in")
    params = T.params_from_jax(ins["0"], arch.config, "cpu")
    state = opt_state_from_jax(ins["1"], params)
    batch = {k: torch.from_numpy(v) for k, v in ins["2"].items()}
    return S._lm_opt_cfg(arch, shape, mesh), mesh, bundle, \
        (params, state, batch)


def _run(bundle, args):
    placed = place_tree(args, bundle.in_shardings)
    C.reset_wire_bytes()
    out = bundle.fn(*placed)
    return out, C.wire_bytes()


@pytest.mark.parametrize("case", CASES, ids=_key)
def test_opt_step_matches_jax_bundle(case, jax_runs):
    _, _, bundle, args = _setup(case, jax_runs)
    (params, state, metrics), _ = _run(bundle, args)
    want = _tree(jax_runs, f"{_key(case)}/out")
    assert set(metrics) == set(want["2"]) == {"loss", "gnorm"}
    for k, v in metrics.items():
        np.testing.assert_allclose(float(gather(v)), float(want["2"][k]),
                                   rtol=METRIC_RTOL, err_msg=k)
    assert int(gather(state["count"])) == int(want["1"]["count"]) == 1
    for name, tree, ref in (("params", params, want["0"]),
                            ("mu", state["mu"], want["1"]["mu"]),
                            ("nu", state["nu"], want["1"]["nu"])):
        refs = dict(_flat(ref))
        for path, x in _flat(tree):
            assert _rel(gather(x).float(), refs[path]) <= STATE_REL, \
                (name, path)


@pytest.mark.parametrize("case", CASES, ids=_key)
def test_opt_step_matches_one_card_micro_step(case, jax_runs):
    """The bundle against ``train_step(loss_fn, cfg, opt, micro=2)`` on one
    device with the bundle's config (MoE dispatch groups n_dp · tp), on the
    same inputs."""
    cfg, _, bundle, args = _setup(case, jax_runs)
    (params, state, metrics), _ = _run(bundle, args)
    p0, s0, batch = _setup(case, jax_runs)[3]
    want_p, want_s, want = S.train_step(T.loss_fn, cfg, S.make_opt(),
                                        micro=2)(p0, s0, batch)
    assert set(metrics) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(float(gather(metrics[k])), float(v),
                                   rtol=METRIC_RTOL, err_msg=k)
    for got, ref in ((params, want_p), (state["mu"], want_s["mu"]),
                     (state["nu"], want_s["nu"])):
        refs = dict(tree_paths(ref))
        for path, x in tree_paths(got):
            assert _rel(gather(x), refs[path]) <= STATE_REL, path


def _nbytes(shape, dtype) -> float:
    return float(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()


def _expected_wire(cfg, mesh, bundle, b, s) -> dict:
    """Each entry's wire bytes by op for one opt train step, worked out
    from the bundle's specs and the layout (``runtime.lm_seqpar``): the
    weights' all-gathers in the forward and again in the recompute, their
    gradients reduce-scattered once; K / V gathered over model (forward,
    recompute) and their gradients scattered; the tokens' and labels'
    gathers once a step; a microbatch's table gathers, embedding scatter
    (its adjoint an all-gather) and final activation gather (its adjoint a
    scatter); the MoE's regrouping and expert all-to-alls (forward,
    recompute, backward). Entry 0's figures; every entry's are equal but
    the ``R | tp`` regrouping's, which is checked per entry."""
    ring = C.ring_wire_bytes
    n_dp, tp = mesh.dims
    n = n_dp * tp
    dt, hd = cfg.torch_dtype, cfg.head_dim
    rows, s_loc = b // (2 * n_dp), s // tp
    params = bundle.specs[0]
    ag = rs = a2a = 0.0

    def gathered(path, over):
        """A layer slice gathered over ``over`` entries: (forward +
        recompute) all-gathers and one reduce-scatter of its gradient,
        a layer a microbatch."""
        nonlocal ag, rs
        x = params["layers"]
        for k in path.split("/"):
            x = x[k]
        full = _nbytes(x.shape[1:], x.dtype)
        if over > 1:
            ag += 2 * cfg.n_layers * 2 * ring("all_gather", full, over)
            rs += cfg.n_layers * 2 * ring("reduce_scatter", full / over, over)

    for w in ("wq", "wk", "wv", "wo"):
        gathered(f"attn/{w}", n)
    if cfg.moe is None:
        for w in ("wi", "wg", "wo"):
            gathered(f"mlp/{w}", n)
    else:
        gathered("moe/router", n_dp)
        for w in ("wi", "wg", "wo"):
            x = params["layers"]["moe"][w]
            full = _nbytes((x.shape[1] // tp,) + tuple(x.shape[2:]), x.dtype)
            if n_dp > 1:
                ag += 2 * cfg.n_layers * 2 * ring("all_gather", full, n_dp)
                rs += cfg.n_layers * 2 * ring("reduce_scatter", full / n_dp,
                                              n_dp)
        e, k = cfg.moe.n_experts, cfg.moe.top_k
        tg = rows * s_loc
        cap = int(cfg.moe.capacity_factor * tg * k / e) + 1
        buf = _nbytes((1, e, cap, cfg.d_model), dt)
        # dispatch and return all-to-alls: forward, recompute, backward
        a2a += 2 * 3 * 2 * cfg.n_layers * ring("all_to_all", buf, tp)
    kv = _nbytes((rows, s, cfg.n_kv_heads, hd), dt)
    if tp > 1:
        ag += 2 * 2 * cfg.n_layers * 2 * ring("all_gather", kv, tp)
        rs += 2 * cfg.n_layers * 2 * ring("reduce_scatter", kv / tp, tp)
    # tokens and labels: (B / n_dp, S / tp) int32 over data, then model
    tok = _nbytes((b, s_loc), torch.int32)
    ag += 2 * (ring("all_gather", tok, n_dp) + ring("all_gather", tok * tp,
                                                    tp))
    # a microbatch's tables over data (forward only: outside the layers)
    tables = [params["embed"]] + ([] if cfg.tie_embeddings
                                  else [params["lm_head"]])
    for t in tables:
        full = _nbytes((t.shape[0] // tp, t.shape[1]) if t is params["embed"]
                       else (t.shape[0], t.shape[1] // tp), t.dtype)
        if n_dp > 1:
            ag += 2 * ring("all_gather", full, n_dp)
            rs += 2 * ring("reduce_scatter", full / n_dp, n_dp)
    act = _nbytes((rows, s, cfg.d_model), dt)
    if tp > 1:
        # the embedding's scatter and its adjoint; the final gather and its
        rs += 2 * 2 * ring("reduce_scatter", act / tp, tp)
        ag += 2 * 2 * ring("all_gather", act, tp)
    return {"all_gather": ag, "reduce_scatter": rs, "all_to_all": a2a}


def _regroup_bytes(cfg, mesh, b, s) -> list:
    """Each entry's bytes received by the MoE regrouping and its inverse,
    forward, recompute and backward, over both microbatches."""
    n_dp, tp = mesh.dims[0], mesh.dims[1]
    rows, s_loc = b // (2 * n_dp), s // tp
    seg = _nbytes((1, s_loc, cfg.d_model), cfg.torch_dtype)
    routes = [[(q % tp, q // tp) for q in range(j * rows, (j + 1) * rows)]
              for j in range(tp)]
    got = [sum(seg for src, _ in routes[j] if src != j) for j in range(tp)]
    back = [sum(seg for q in range(rows) if (q * tp + m) // rows != m)
            for m in range(tp)]
    if all(src == j for j, r in enumerate(routes) for src, _ in r):
        return [0.0] * (n_dp * tp)
    # regroup: forward + recompute + the backward of ungroup; ungroup the
    # same with the roles swapped
    per = [3 * (got[m] + back[m]) for m in range(tp)]
    return [2 * cfg.n_layers * per[e % tp] for e in range(n_dp * tp)]


@pytest.mark.parametrize("case", CASES, ids=_key)
def test_opt_wire_bytes_match_the_specs(case, jax_runs):
    cfg, mesh, bundle, args = _setup(case, jax_runs)
    arch_id, _, b, s = case
    _, wire = _run(bundle, args)
    want = _expected_wire(cfg, mesh, bundle, b, s)
    regroup = _regroup_bytes(cfg, mesh, b, s) if cfg.moe else \
        [0.0] * len(mesh.devices)
    for e in range(len(mesh.devices)):
        assert wire["all_gather"][e] == pytest.approx(want["all_gather"],
                                                      rel=1e-12)
        assert wire["reduce_scatter"][e] == pytest.approx(
            want["reduce_scatter"], rel=1e-12)
        assert wire["all_to_all"].get(e, 0.0) == pytest.approx(
            want["all_to_all"] + regroup[e], rel=1e-12)
    assert any(wire["all_reduce"].values())


def test_regroup_is_jax_groups():
    """``regroup`` hands entry (r, j) JAX's dispatch group r·tp + j — the
    contiguous span of the microbatch's b-major tokens — for every split of
    a data rank's rows the meshes reach (``tp | R``, ``R = 1``, ``R | tp``)
    and one where neither divides; ``ungroup`` undoes it."""
    for dims, rows in (((2, 2), 2), ((1, 4), 1), ((1, 4), 2), ((1, 4), 8),
                       ((2, 2), 3)):
        mesh = make_mesh(dims, ("data", "model"), devices=["cpu"] * 4)
        ctx = SP.make_ctx(mesh, _arch("moonshot-v1-16b-a3b").config)
        n_dp, tp = dims
        s, d = 8 * tp, 3
        x = torch.arange(n_dp * rows * s * d, dtype=torch.float32).reshape(
            n_dp * rows, s, d)
        spec = ("data", "model", None)
        shards = [x[sl] for sl in _block_slices(mesh, spec, x.shape)]
        groups = x.reshape(n_dp * tp, -1, d)       # JAX's contiguous groups
        got = SP.regroup(ctx, shards)
        for e, g in enumerate(got):
            assert torch.equal(g, groups[ctx.rank(ctx.axes, e)])
        back = SP.ungroup(ctx, got, tuple(shards[0].shape))
        for a, b in zip(back, shards):
            assert torch.equal(a, b)


def test_permute_chunks_adjoint():
    """``permute_chunks``' backward sends each chunk's gradient back by the
    inverse routing (the gradient of a sum of weighted outputs), and a
    routing that misses or repeats a chunk raises."""
    mesh = make_mesh((1, 4), ("data", "model"), devices=["cpu"] * 4)
    g = torch.Generator().manual_seed(0)
    xs = [torch.randn((2, 3), generator=g, requires_grad=True)
          for _ in range(4)]
    routes = [[(1, 0), (0, 1)], [(2, 1), (3, 0)], [(0, 0), (2, 0)],
              [(3, 1), (1, 1)]]
    ws = [torch.randn((1, 6), generator=g) for _ in range(4)]
    outs = C.permute_chunks(xs, mesh, "model", 0, 1, routes)
    sum((o * w).sum() for o, w in zip(outs, ws)).backward()
    for r, route in enumerate(routes):
        for pos, (src, j) in enumerate(route):
            assert torch.equal(outs[r][:, 3 * pos:3 * pos + 3], xs[src][j:j + 1])
            assert torch.equal(xs[src].grad[j:j + 1],
                               ws[r][:, 3 * pos:3 * pos + 3])
    with pytest.raises(ValueError, match="exactly once"):
        C.permute_chunks(xs, mesh, "model", 0, 1,
                         [[(0, 0), (0, 0)]] + routes[1:])


def test_uneven_layout_raises():
    """A sequence that does not split over model, or a microbatch whose
    rows do not split over the data ranks, builds its bundle (JAX's specs)
    and raises when the step runs, naming the ROADMAP item."""
    arch = _arch("phi3-mini-3.8b")
    mesh = _mesh("d2m2")
    for b, s in ((4, 15), (2, 16)):
        bundle = S.build_lm(arch, LMShape("t", "train", s, b), mesh, "opt")
        with pytest.raises(ValueError, match="A item 3.5"):
            bundle.fn()
        want = ("data", "model") if s % 2 == 0 else ("data",)
        assert tuple(bundle.in_shardings[2]["tokens"].spec) == want


@pytest.mark.parametrize("arch_id", ["gemma2-9b", "moonshot-v1-16b-a3b"])
def test_opt_pod_mesh_matches_one_card(arch_id):
    """On a (pod 2, data 2, model 2) mesh the data axes are ("pod",
    "data"): the microbatches' rows, the dispatch groups (n_dp · tp = 8)
    and the loss's sums run over both. B = 16 gives two rows a data rank
    in each microbatch. Metrics and ``mu`` against the one-card
    ``train_step(micro=2)``."""
    arch = _arch(arch_id)
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"),
                     devices=["cpu"] * 8)
    shape = LMShape("t", "train", 16, 16)
    cfg = S._lm_opt_cfg(arch, shape, mesh)
    bundle = S.build_lm(arch, shape, mesh, "opt")
    assert tuple(bundle.in_shardings[2]["tokens"].spec) == \
        (("pod", "data"), "model")
    params = T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (16, 16))
                                 .astype(np.int32))
             for k in ("tokens", "labels")}
    opt = S.make_opt()
    _, state, metrics = bundle.fn(*place_tree(
        (params, opt.init(params), batch), bundle.in_shardings))
    _, want_state, want = S.train_step(T.loss_fn, cfg, opt, micro=2)(
        params, opt.init(params), batch)
    for k, v in want.items():
        np.testing.assert_allclose(float(gather(metrics[k])), float(v),
                                   rtol=METRIC_RTOL, err_msg=k)
    refs = dict(tree_paths(want_state["mu"]))
    for path, x in tree_paths(state["mu"]):
        assert _rel(gather(x), refs[path]) <= STATE_REL, path
