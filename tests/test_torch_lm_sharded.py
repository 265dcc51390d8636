"""The port's sharded LM steps (``launch.steps.build_lm``'s bundles, run by
``runtime.lm_sharded`` on a mesh of CPU entries) against the JAX package's
jitted bundles and against the port's own one-card steps.

JAX's side runs in a child process with 4 forced host devices:
``jax.jit(bundle.fn, in_shardings=..., out_shardings=...)`` of
``repro.launch.steps.build_lm`` for an ``ArchDef`` carrying the arch's
smoke config (f32, 2 layers) and a small ``LMShape``, from params drawn
by JAX's ``init_params`` and a batch from numpy's seeded generator; the
child saves params, inputs and outputs to one ``.npz``. The port places
the same params and inputs by its bundle's ``in_shardings`` and runs its
``fn``. The cases:

* gemma2 (tied embedding, both softcaps, local / global windows, GQA),
  moonshot (MoE, one dispatch group a data rank), phi3 (untied, dense)
  and deepseek (7 heads: at ``model`` 2 a query head straddles two
  entries, the ``tp ∤ H`` path);
* on (data 2, model 2) and (data 1, model 4) — the latter takes
  gemma2-smoke's 2 KV heads through the ``tp ∤ Hkv`` path (KV gathered
  over ``model``, a sequence-sharded decode cache);
* train, prefill and decode, and the B = 1 decode whose cache is split
  over every axis (its blocks merged across entries).

The same steps are held to the port's one-card steps on (data 2, model
2) and on a (pod 2, data 2, model 2) mesh, and the block merge of the
sequence-sharded decode to attention over all keys.

Tolerances (f32; the sharded sums run in another order than one matmul's
or XLA's): loss and metrics within ``rtol`` 2e-6; params, ``mu``, ``nu``,
logits and caches within 2e-5 relative L2 a leaf (each has been seen at
most ~1e-6 apart); ``count`` exact.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS
from repro_torch.configs.base import ArchDef
from repro_torch.configs.shapes import LMShape
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import gather, make_mesh, place_tree
from repro_torch.models import transformer as T
from repro_torch.optim.optimizers import opt_state_from_jax
from repro_torch.runtime import collectives as C
from test_torch_engine import release_jax_executables  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH_IDS = ["gemma2-9b", "moonshot-v1-16b-a3b", "phi3-mini-3.8b",
            "deepseek-coder-33b"]
MESHES = {"d2m2": (2, 2), "d1m4": (1, 4)}
SEQ, BATCH, DECODE_SLOTS, CACHE_LEN = 16, 2, 32, 20
# (kind, global batch, seq) of each case; the B = 1 decode only where
# B < n_dp, on (data 2, model 2)
KINDS = [("train", BATCH, SEQ), ("prefill", BATCH, SEQ),
         ("decode", 2 * BATCH, DECODE_SLOTS)]
CASES = [(a, m, k, b, s) for a in ARCH_IDS for m in MESHES
         for k, b, s in KINDS] + \
        [(a, "d2m2", "decode", 1, DECODE_SLOTS) for a in ARCH_IDS]
STATE_REL = 2e-5
METRIC_RTOL = 2e-6


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

for n, (arch_id, mesh_key, kind, b, s) in enumerate(cases):
    key = "|".join(str(x) for x in (arch_id, mesh_key, kind, b, s))
    cfg = dataclasses.replace(ARCHS[arch_id].smoke_config, n_layers=2)
    arch = ArchDef(arch_id, "lm", cfg, cfg, "smoke")
    mesh = make_mesh_compat(tuple(meshes[mesh_key]), ("data", "model"))
    bundle = build_lm(arch, LMShape("case", kind, s, b), mesh)
    params = T.init_params(jax.random.PRNGKey(n), cfg)
    rng = np.random.default_rng(n)
    if kind == "train":
        batch = {k: rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
                 for k in ("labels", "tokens")}
        args = (params, make_opt().init(params), batch)
    elif kind == "prefill":
        args = (params, rng.integers(0, cfg.vocab, (b, s)).astype(np.int32))
    else:
        shape = (cfg.n_layers, b, s, cfg.n_kv_heads, cfg.head_dim)
        args = (params, rng.integers(0, cfg.vocab, (b, 1)).astype(np.int32),
                rng.standard_normal(shape).astype(np.float32),
                rng.standard_normal(shape).astype(np.float32),
                np.int32(%d))
    put(f"{key}/in", args)
    fn = jax.jit(bundle.fn, in_shardings=bundle.in_shardings,
                 out_shardings=bundle.out_shardings)
    put(f"{key}/out", jax.device_get(fn(*args)))
np.savez(path, **out)
""" % CACHE_LEN


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax") / "runs.npz")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(JAX_CHILD), json.dumps(CASES),
         json.dumps(MESHES), path],
        capture_output=True, text=True, env=env, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def _tree(runs, prefix):
    """The nested dict of ``runs`` entries under ``prefix``/."""
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


def _arch(arch_id) -> ArchDef:
    cfg = dataclasses.replace(ARCHS[arch_id].smoke_config, n_layers=2)
    return ArchDef(arch_id, "lm", cfg, cfg, "smoke")


def _mesh(mesh_key):
    return make_mesh(MESHES[mesh_key], ("data", "model"),
                     devices=["cpu"] * 4)


def _bundle(arch_id, mesh_key, kind, b, s):
    arch = _arch(arch_id)
    return arch.config, S.build_lm(arch, LMShape("case", kind, s, b),
                                   _mesh(mesh_key))


def _inputs(runs, case, cfg):
    """The case's inputs as the port's tensors, in the bundle's order."""
    arch_id, mesh_key, kind, b, s = case
    ins = _tree(runs, f"{_key(case)}/in")
    params = T.params_from_jax(ins["0"], cfg, "cpu")
    if kind == "train":
        state = opt_state_from_jax(ins["1"], params)
        batch = {k: torch.from_numpy(v) for k, v in ins["2"].items()}
        return (params, state, batch)
    rest = tuple(torch.from_numpy(np.asarray(ins[str(i)]))
                 for i in range(1, len(ins)))
    return (params,) + rest


def _run_port(runs, case):
    cfg, bundle = _bundle(*case)
    args = _inputs(runs, case, cfg)
    placed = place_tree(args, bundle.in_shardings)
    C.reset_wire_bytes()
    out = bundle.fn(*placed)
    return cfg, bundle, args, out


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
            assert _rel(gather(x).float(), refs[path]) <= STATE_REL, \
                (name, path)


def _check_outputs(got, want):
    for i, x in enumerate(got):
        assert tuple(x.shape) == want[str(i)].shape
        assert _rel(gather(x), want[str(i)]) <= STATE_REL, i


@pytest.mark.parametrize("case", CASES, ids=_key)
def test_sharded_step_matches_jax_bundle(case, jax_runs):
    got = _run_port(jax_runs, case)[3]
    want = _tree(jax_runs, f"{_key(case)}/out")
    if case[2] == "train":
        _check_train(got, want)
    else:
        _check_outputs(got, want)
    assert any(C.wire_bytes()["all_reduce"].values())


def _one_card(cfg, kind, args):
    """The port's one-card step on the same inputs (the config the mesh
    gives: MoE dispatch groups = n_dp)."""
    if kind == "train":
        params, state, batch = args
        return S.train_step(T.loss_fn, cfg, S.make_opt())(params, state,
                                                          batch)
    if kind == "prefill":
        return T.prefill_step(args[0], args[1], cfg)
    params, token, ck, cv, n = args
    return T.decode_step_inplace(params, token, ck.clone(), cv.clone(),
                                 int(n), cfg)


@pytest.mark.parametrize("case", [c for c in CASES if c[1] == "d2m2"],
                         ids=_key)
def test_sharded_step_matches_one_card_step(case, jax_runs):
    cfg_smoke, _, _, got = _run_port(jax_runs, case)
    cfg = S._lm_cfg_for_mesh(_arch(case[0]), _mesh(case[1]))
    want = _one_card(cfg, case[2], _inputs(jax_runs, case, cfg_smoke))
    if case[2] == "train":
        for k, v in want[2].items():
            np.testing.assert_allclose(float(gather(got[2][k])), float(v),
                                       rtol=METRIC_RTOL, err_msg=k)
        for (path, x), (_, y) in zip(_flat(got[1]["mu"]), _flat(want[1]["mu"])):
            assert _rel(gather(x), y) <= STATE_REL, path
        return
    for x, y in zip(got, want):
        assert _rel(gather(x), y) <= STATE_REL


def test_moe_aux_and_gnorm_are_global(jax_runs):
    """moonshot's aux loss on (data 2, model 2) is the product of the two
    global means (not the mean of per-rank products), and gnorm counts
    each replicated leaf once: both equal the one-card step's."""
    case = ("moonshot-v1-16b-a3b", "d2m2", "train", BATCH, SEQ)
    _, _, args, got = _run_port(jax_runs, case)
    metrics = {k: float(gather(v)) for k, v in got[2].items()}
    cfg = S._lm_cfg_for_mesh(_arch(case[0]), _mesh(case[1]))
    _, aux = T.backbone(args[0], args[2]["tokens"], cfg)
    assert metrics["aux"] == pytest.approx(float(aux), rel=METRIC_RTOL)
    half = [T.backbone(args[0], args[2]["tokens"][i:i + 1], dataclasses
                       .replace(cfg, moe=dataclasses.replace(
                           cfg.moe, dispatch_groups=1)))[1]
            for i in range(2)]
    assert abs(metrics["aux"] - float(sum(half) / 2)) > 1e-6
    grads = S.value_and_grad(T.loss_fn, args[0], args[2], cfg)[2]
    gn = float(torch.sqrt(sum(torch.sum(g.double() ** 2)
                              for _, g in _flat(grads))))
    assert metrics["gnorm"] == pytest.approx(gn, rel=METRIC_RTOL)


def test_attention_lse_blocks_merge_to_whole_attention():
    """``flash_attention(lse=True)``'s plain version on disjoint key blocks,
    merged as the sequence-sharded decode merges them (each block's output
    weighed by exp(lse - max)), equals attention over all keys; a block
    the row cannot see has lse -inf and weighs 0. f32, as the plain
    version computes: within 1e-5."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention,
    )
    from repro_torch.kernels.flash_attention.ref import attention_ref
    g = torch.Generator().manual_seed(0)
    q = torch.randn((2, 4, 1, 16), generator=g)
    k = torch.randn((2, 2, 64, 16), generator=g)
    v = torch.randn((2, 2, 64, 16), generator=g)
    for window, off in ((0, 63), (0, 40), (20, 63), (8, 30)):
        kw = dict(window=window, softcap=30.0)
        want = attention_ref(q, k, v, q_offset=off, **kw)
        parts = [flash_attention(q, k[:, :, s:s + 16], v[:, :, s:s + 16],
                                 q_offset=off - s, lse=True, **kw)
                 if s <= off else
                 (torch.zeros_like(q), torch.full((2, 4, 1), float("-inf")))
                 for s in range(0, 64, 16)]
        top = torch.stack([lse for _, lse in parts]).amax(0)
        w = [torch.exp(lse - top) for _, lse in parts]
        got = sum(o * x[..., None] for (o, _), x in zip(parts, w)) \
            / sum(w)[..., None]
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        whole, lse = flash_attention(q, k, v, q_offset=off, lse=True, **kw)
        torch.testing.assert_close(whole, want, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(lse, torch.logsumexp(torch.stack(
            [x for _, x in parts]), 0), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch_id", ["gemma2-9b", "moonshot-v1-16b-a3b"])
def test_pod_mesh_matches_one_card(arch_id):
    """On a (pod 2, data 2, model 2) mesh the data axes are ("pod",
    "data"): a train step's metrics and ``mu``, and a B = 1 decode whose
    cache is split over all three axes, against the one-card step."""
    arch = _arch(arch_id)
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"),
                     devices=["cpu"] * 8)
    cfg = S._lm_cfg_for_mesh(arch, mesh)
    params = T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (4, SEQ))
                                 .astype(np.int32))
             for k in ("tokens", "labels")}
    opt = S.make_opt()
    b = S.build_lm(arch, LMShape("t", "train", SEQ, 4), mesh)
    _, state, metrics = b.fn(*place_tree((params, opt.init(params), batch),
                                         b.in_shardings))
    _, want_state, want = S.train_step(T.loss_fn, cfg, opt)(
        params, opt.init(params), batch)
    for k, v in want.items():
        np.testing.assert_allclose(float(gather(metrics[k])), float(v),
                                   rtol=METRIC_RTOL, err_msg=k)
    for (path, x), (_, y) in zip(_flat(state["mu"]), _flat(want_state["mu"])):
        assert _rel(gather(x), y) <= STATE_REL, path
    b = S.build_lm(arch, LMShape("d", "decode", DECODE_SLOTS, 1), mesh)
    assert tuple(b.in_shardings[2].spec)[2] == ("pod", "data", "model")
    g = torch.Generator().manual_seed(1)
    shape = (cfg.n_layers, 1, DECODE_SLOTS, cfg.n_kv_heads, cfg.head_dim)
    ck, cv = torch.randn(shape, generator=g), torch.randn(shape, generator=g)
    token = batch["tokens"][:1, :1]
    lg, k2, _ = b.fn(*place_tree((params, token, ck, cv, torch.tensor(
        CACHE_LEN, dtype=torch.int32)), b.in_shardings))
    want, wk, _ = T.decode_step_inplace(params, token, ck.clone(), cv.clone(),
                                        CACHE_LEN, cfg)
    assert _rel(gather(lg), want) <= STATE_REL
    assert _rel(gather(k2), wk) <= STATE_REL
