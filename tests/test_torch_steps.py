"""The port's step bundles (``repro_torch.launch.steps``: ``StepBundle``,
``build_lm``, ``build_step``) against the JAX package's.

Every LM arch x LM shape at its full ``CONFIG`` is built on a (16, 16)
("data", "model") mesh of ``meta`` entries, which allocates nothing, and
held to JAX's ``build_step`` on ``make_production_mesh()`` (256 forced
host devices, in a child process, as ``tests/test_steps_and_stats.py``
builds its bundles): name, kind, each spec's shape and dtype, each in and
out ``PartitionSpec``, ``donate`` and ``meta``, all exact, and so is every
LM arch's ``train_4k`` cell under the ``opt`` scheme. So is every GNN
and recsys cell: the GNNs under ``baseline`` and MeshGraphNet's full-graph
cells under ``halo`` too, recsys under ``baseline`` and ``opt``. The
cells JAX refuses (skip-marked, the ``halo`` scheme beyond MeshGraphNet's
full graphs) raise. A bundle's
``fn`` updates donated arguments in place and raises on an argument that
is not placed as ``in_shardings``. Every decode cell whose cache is split
over the sequence dispatches its key blocks to the split kernel, the one
that gives the log-sum-exp their merge needs."""
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
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.launch.mesh import (
    Placement, SpecBlocks, _block_slices, gather, make_mesh, place,
    place_tree,
)
from repro_torch.models import transformer as T
from test_torch_engine import release_jax_executables  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM_CELLS = [(a, s) for a, d in ARCHS.items() if d.family == "lm"
            for s in d.shapes]
# (arch, shape, scheme) of every GNN and recsys cell the JAX child builds
OTHER_CELLS = [(a, s, sch) for a, d in ARCHS.items() if d.family != "lm"
               for s in d.shapes
               for sch in (("baseline", "opt") if d.family == "recsys"
                           else ("baseline", "halo") if a == "meshgraphnet"
                           else ("baseline",))]

JAX_BUNDLES = """
import json, os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=256"
import jax
from repro.configs import ARCHS
from repro.launch.mesh import make_production_mesh
from repro.launch.steps import build_step

def walk(x, pre, out, leaf):
    if isinstance(x, dict):
        for k in sorted(x):
            walk(x[k], f"{pre}/{k}", out, leaf)
    elif isinstance(x, (tuple, list)):
        for i, v in enumerate(x):
            walk(v, f"{pre}/{i}", out, leaf)
    else:
        out[pre] = leaf(x)

mesh = make_production_mesh()
res = {}
for a, arch in ARCHS.items():
    schemes = {"lm": ("baseline", "opt"), "recsys": ("baseline", "opt"),
               "gnn": ("baseline", "halo") if a == "meshgraphnet"
               else ("baseline",)}[arch.family]
    for s in arch.shapes:
      for sch in schemes:
        if arch.family == "lm" and sch == "opt" and s != "train_4k":
            continue
        key = f"{a}:{s}" if sch == "baseline" else f"{a}:{s}:{sch}"
        try:
            b = build_step(a, s, mesh, sch)
        except (ValueError, AssertionError) as e:
            res[key] = {"error": str(e)}
            continue
        specs, ins, outs = {}, {}, {}
        walk(b.specs, "", specs, lambda x: [list(x.shape), str(x.dtype)])
        walk(b.in_shardings, "", ins, lambda x: list(x.spec))
        walk(b.out_shardings, "", outs, lambda x: list(x.spec))
        res[key] = {"name": b.name, "kind": b.kind, "specs": specs,
                     "in": ins, "out": outs, "donate": list(b.donate),
                     "meta": b.meta}
print(json.dumps(res))
"""


def _walk(x, pre, out, leaf):
    if isinstance(x, Placement):
        out[pre] = leaf(x)
    elif isinstance(x, dict):
        for k in sorted(x):
            _walk(x[k], f"{pre}/{k}", out, leaf)
    elif isinstance(x, (tuple, list)):
        for i, v in enumerate(x):
            _walk(v, f"{pre}/{i}", out, leaf)
    else:
        out[pre] = leaf(x)


def _json(x):
    return json.loads(json.dumps(x))


@pytest.fixture(scope="module")
def jax_bundles():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(JAX_BUNDLES)],
                         capture_output=True, text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def meta_mesh():
    return make_mesh((16, 16), ("data", "model"), devices=["meta"] * 256)


def _assert_bundle_equal(b, want, mesh):
    specs, ins, outs = {}, {}, {}
    _walk(b.specs, "", specs, lambda x: [list(x.shape),
                                         str(x.dtype).replace("torch.", "")])
    _walk(b.in_shardings, "", ins, lambda x: list(x.spec))
    _walk(b.out_shardings, "", outs, lambda x: list(x.spec))
    for x in [v for v in _leaves(b.specs)]:
        assert x.device.type == "meta"
    got = {"name": b.name, "kind": b.kind, "specs": specs, "in": _json(ins),
           "out": _json(outs), "donate": list(b.donate),
           "meta": _json(b.meta)}
    for key in want:
        assert got[key] == want[key], key
    for sh in _leaves(b.in_shardings):
        assert sh.mesh is mesh


@pytest.mark.parametrize("arch_id,shape", LM_CELLS)
def test_lm_bundle_matches_jax(arch_id, shape, jax_bundles, meta_mesh):
    want = jax_bundles[f"{arch_id}:{shape}"]
    if "error" in want:
        with pytest.raises(ValueError, match="skip-marked"):
            S.build_step(arch_id, shape, meta_mesh)
        return
    _assert_bundle_equal(S.build_step(arch_id, shape, meta_mesh), want,
                         meta_mesh)


@pytest.mark.parametrize("arch_id,shape,scheme", OTHER_CELLS,
                         ids=lambda x: str(x))
def test_gnn_and_recsys_bundle_matches_jax(arch_id, shape, scheme,
                                           jax_bundles, meta_mesh):
    key = f"{arch_id}:{shape}" if scheme == "baseline" else \
        f"{arch_id}:{shape}:{scheme}"
    want = jax_bundles[key]
    if "error" in want:
        # JAX asserts a full-graph shape for the halo scheme
        with pytest.raises(ValueError, match="full-graph shape"):
            S.build_step(arch_id, shape, meta_mesh, scheme)
        return
    _assert_bundle_equal(S.build_step(arch_id, shape, meta_mesh, scheme),
                         want, meta_mesh)


def _leaves(tree):
    out = {}
    _walk(tree, "", out, lambda x: x)
    return list(out.values())


@pytest.mark.parametrize("arch_id", ["meshgraphnet", "nequip",
                                     "two-tower-retrieval"])
def test_gnn_and_recsys_cells_raise(arch_id, meta_mesh, jax_bundles):
    """Once raising (ROADMAP A18.4's builders), each family's first cell
    now builds, equal to JAX's; the halo scheme raises where JAX asserts
    (an arch other than MeshGraphNet, a shape that is not a full graph)."""
    shape = next(iter(ARCHS[arch_id].shapes))
    _assert_bundle_equal(S.build_step(arch_id, shape, meta_mesh),
                         jax_bundles[f"{arch_id}:{shape}"], meta_mesh)
    if arch_id == "nequip":
        with pytest.raises(ValueError, match="meshgraphnet hillclimb"):
            S.build_step(arch_id, shape, meta_mesh, "halo")
    if arch_id == "meshgraphnet":
        with pytest.raises(ValueError, match="full-graph shape"):
            S.build_step(arch_id, "molecule", meta_mesh, "halo")


def test_opt_and_halo_schemes(meta_mesh, jax_bundles):
    """Every LM arch's ``train_4k`` bundle under the ``opt`` scheme (ZeRO-3
    params, the batch at (data, model), MoE dispatch groups n_dp · tp)
    equals JAX's; the halo scheme is not an LM scheme; on other cells
    ``opt`` is the baseline, as in JAX."""
    lm = [a for a, d in ARCHS.items() if d.family == "lm"]
    for arch_id in lm:
        _assert_bundle_equal(
            S.build_step(arch_id, "train_4k", meta_mesh, "opt"),
            jax_bundles[f"{arch_id}:train_4k:opt"], meta_mesh)
    with pytest.raises(ValueError, match="build_gnn_halo"):
        S.build_step("gemma2-9b", "prefill_32k", meta_mesh, "halo")
    # JAX's opt scheme changes only the train cells
    a = S.build_step("phi3-mini-3.8b", "decode_32k", meta_mesh, "opt")
    b = S.build_step("phi3-mini-3.8b", "decode_32k", meta_mesh)
    ia, ib = {}, {}
    _walk(a.in_shardings, "", ia, lambda x: tuple(x.spec))
    _walk(b.in_shardings, "", ib, lambda x: tuple(x.spec))
    assert ia == ib and a.meta == b.meta


@pytest.mark.parametrize("dims", [(16, 16), (4, 16)], ids=str)
def test_sequence_sharded_decode_takes_the_split_kernel(dims):
    """A decode whose cache is split over the sequence merges its key blocks
    by the log-sum-exp that only the split kernel gives
    (``flash_attention(lse=True)``), so every such cell's block call must
    dispatch to it, however many (batch x kv head) CTAs an entry has: on a
    (4, 16) mesh llama4-scout's and deepseek-coder-33b's decode_32k give
    32 sequences x 8 KV heads an entry, past the H100's 132 SMs."""
    mesh = make_mesh(dims, ("data", "model"),
                     devices=["meta"] * int(np.prod(dims)))
    cells, past_sms = 0, 0
    for arch_id, shape in LM_CELLS:
        arch = ARCHS[arch_id]
        if arch.shapes[shape].kind != "decode" \
                or shape in arch.skip_shapes:
            continue
        b = S.build_step(arch_id, shape, mesh)
        place = b.out_shardings[1]
        if place.spec[3] == "model":            # split over heads
            continue
        sl = _block_slices(mesh, place.spec, b.specs[2].shape)[0]
        _, be, se, hkv, hd = (x.stop - x.start for x in sl)
        cfg = arch.config
        q = torch.empty((be, cfg.n_heads, 1, hd), dtype=torch.bfloat16,
                        device="meta")
        k = torch.empty((be, hkv, se, hd), dtype=torch.bfloat16,
                        device="meta")
        how = fa.dispatch(q, k, q_offset=se - 1, lse=True)
        assert how["kernel"] == "split", (arch_id, shape, how)
        cells += 1
        past_sms += be * hkv >= 132
        if be * hkv >= 132:
            assert fa.dispatch(q, k, q_offset=se - 1)["kernel"] == "prefill"
    assert cells > 0 and (past_sms > 0) == (dims == (4, 16))


# -- the step's contract, on a (data 2, model 2) mesh of CPU entries ----------

def _smoke(arch_id, n_layers=2):
    cfg = dataclasses.replace(ARCHS[arch_id].smoke_config, n_layers=n_layers)
    return ArchDef(arch_id, "lm", cfg, cfg, "smoke")


def _cpu_mesh(dims=(2, 2)):
    return make_mesh(dims, ("data", "model"), devices=["cpu"] * 4)


def test_train_step_donates_in_place():
    arch = _smoke("moonshot-v1-16b-a3b")
    mesh = _cpu_mesh()
    b = S.build_lm(arch, LMShape("t", "train", 8, 2), mesh)
    cfg = S._lm_cfg_for_mesh(arch, mesh)
    params = T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    state = S.make_opt().init(params)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (2, 8))
                                 .astype(np.int32))
             for k in ("tokens", "labels")}
    p, o, bt = place_tree((params, state, batch), b.in_shardings)
    before = {id(sh): sh.clone() for x in _leaves_sb(p) for sh in x.shards}
    ptrs = [sh.data_ptr() for x in _leaves_sb((p, o)) for sh in x.shards]
    p2, o2, metrics = b.fn(p, o, bt)
    assert p2 is p and o2 is o
    assert ptrs == [sh.data_ptr() for x in _leaves_sb((p2, o2))
                    for sh in x.shards]
    changed = [not torch.equal(before[id(sh)], sh)
               for x in _leaves_sb(p2) for sh in x.shards]
    assert any(changed)
    assert int(gather(o2["count"])) == 1
    assert set(metrics) == {"xent", "aux", "loss", "gnorm"}
    for m in metrics.values():
        assert isinstance(m, SpecBlocks) and tuple(m.spec) == ()
        assert len({float(x) for x in m.shards}) == 1


def _leaves_sb(tree):
    out = []

    def walk(x):
        if isinstance(x, SpecBlocks):
            out.append(x)
        elif isinstance(x, dict):
            for k in sorted(x):
                walk(x[k])
        elif isinstance(x, (tuple, list)):
            for v in x:
                walk(v)
    walk(tree)
    return out


def test_decode_writes_the_cache_in_place():
    arch = _smoke("gemma2-9b")
    mesh = _cpu_mesh()
    cfg = arch.config
    b = S.build_lm(arch, LMShape("d", "decode", 16, 1), mesh)
    params = T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    g = torch.Generator().manual_seed(1)
    ck = torch.randn((2, 1, 16, cfg.n_kv_heads, cfg.head_dim), generator=g)
    cv = torch.randn(ck.shape, generator=g)
    args = place_tree((params, torch.tensor([[3]], dtype=torch.int32), ck, cv,
                       torch.tensor(9, dtype=torch.int32)), b.in_shardings)
    ptrs = [sh.data_ptr() for sh in args[2].shards]
    _, k2, v2 = b.fn(*args)
    assert k2 is args[2] and v2 is args[3]
    assert ptrs == [sh.data_ptr() for sh in k2.shards]
    got = gather(k2)
    slot = torch.zeros(16, dtype=torch.bool)
    slot[9] = True
    assert torch.equal(got[:, :, ~slot], ck[:, :, ~slot])
    assert not torch.equal(got[:, :, slot], ck[:, :, slot])


def test_wrong_placement_raises():
    arch = _smoke("phi3-mini-3.8b")
    mesh = _cpu_mesh()
    b = S.build_lm(arch, LMShape("p", "prefill", 8, 2), mesh)
    params = T.init_params(arch.config,
                           generator=torch.Generator().manual_seed(0),
                           device="cpu")
    tokens = torch.zeros((2, 8), dtype=torch.int32)
    placed = place_tree(params, b.in_shardings[0])
    with pytest.raises(ValueError, match="argument 1 must be placed"):
        b.fn(placed, tokens)                   # a plain tensor
    wrong = place(tokens, Placement(mesh, spec=("model",)))
    with pytest.raises(ValueError, match="argument 1 is placed as"):
        b.fn(placed, wrong)
    other = make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
    assert other == mesh                        # an equal mesh is the mesh
    one = make_mesh((1, 4), ("data", "model"), devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="argument 0/embed is placed"):
        b.fn(place_tree(params, S._lm_shardings(params, one)),
             place(tokens, b.in_shardings[1]))
    with pytest.raises(ValueError, match="is \\(2, 8\\) torch.int64"):
        b.fn(placed, place(tokens.long(), b.in_shardings[1]))
