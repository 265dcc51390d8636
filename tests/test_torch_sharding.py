"""The port's sharding rules (``repro_torch.runtime.sharding``) and spec
placements (``launch.mesh.SpecBlocks``) against the JAX package's.

JAX's rules read only a mesh's ``axis_names`` and ``shape``, so its specs
come from a stand-in object that carries just those two (``_StandIn``),
in this process. The placement's block layout is held to JAX's
``NamedSharding.devices_indices_map`` on a real mesh of 8 forced host
devices, in a child process (the test process keeps JAX's one device).
Specs are compared as tuples (a JAX ``P`` is a tuple); every comparison
is exact."""
import dataclasses
import functools
import json
import os
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.launch import steps as jsteps
from repro.models import recsys as JRS
from repro.models import transformer as JT
from repro.runtime import sharding as JSHR
from repro_torch.configs import ARCHS
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import (
    PartitionSpec, Placement, RowBlocks, SpecBlocks, _block_slices, gather,
    make_mesh, place, place_tree, tree_map,
)
from repro_torch.models import recsys as RS
from repro_torch.models import transformer as T
from repro_torch.optim.optimizers import tree_leaves
from repro_torch.runtime import sharding as SHR
from test_torch_engine import release_jax_executables  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"data4_model2": ((4, 2), ("data", "model")),
          "pod2_data2_model2": ((2, 2, 2), ("pod", "data", "model"))}
LM_ARCHS = [a for a, d in ARCHS.items() if d.family == "lm"]
GNN_ARCHS = [a for a, d in ARCHS.items() if d.family == "gnn"]


def _StandIn(dims, names):
    """What JAX's rules read of a mesh: ``axis_names`` and ``shape``."""
    return SimpleNamespace(axis_names=tuple(names),
                           shape=dict(zip(names, dims)))


def _meshes(key):
    dims, names = MESHES[key]
    return (_StandIn(dims, names),
            make_mesh(dims, names, devices=["cpu"] * int(np.prod(dims))))


def _jax_specs(jtree, rules) -> dict:
    paths, _, _ = JSHR.tree_paths(jtree)
    flat = jax.tree.leaves(JSHR.specs_from_rules(jtree, rules),
                           is_leaf=lambda x: isinstance(x, jax.sharding.
                                                        PartitionSpec))
    return {p: tuple(s) for p, s in zip(paths, flat)}


def _port_specs(tree, rules) -> dict:
    paths, _ = SHR.tree_paths(tree)
    specs = tree_leaves(SHR.specs_from_rules(tree, rules))
    for s in specs:
        assert isinstance(s, PartitionSpec)
    return {p: tuple(s) for p, s in zip(paths, specs)}


def _lm_trees(arch_id):
    jcfg = dataclasses.replace(JARCHS[arch_id].smoke_config, n_layers=2)
    tcfg = dataclasses.replace(ARCHS[arch_id].smoke_config, n_layers=2)
    jtree = jax.eval_shape(functools.partial(JT.init_params, cfg=jcfg),
                           jax.random.PRNGKey(0))
    ttree = T.init_params(tcfg, generator=torch.Generator().manual_seed(0),
                          device="cpu")
    return jtree, ttree


def _gnn_trees(arch_id):
    jmod, tmod = jsteps._GNN_MODELS[arch_id], tsteps._GNN_MODELS[arch_id]
    jcfg, tcfg = JARCHS[arch_id].smoke_config, ARCHS[arch_id].smoke_config
    gen = torch.Generator().manual_seed(0)
    extra = (16,) if arch_id in ("meshgraphnet", "pna") else ()
    jtree = jax.eval_shape(lambda k: jmod.init_params(k, jcfg, *extra),
                           jax.random.PRNGKey(0))
    return jtree, tmod.init_params(tcfg, *extra, generator=gen, device="cpu")


def _recsys_trees():
    a = "two-tower-retrieval"
    jtree = jax.eval_shape(
        lambda k: JRS.init_params(k, JARCHS[a].smoke_config),
        jax.random.PRNGKey(0))
    ttree = RS.init_params(ARCHS[a].smoke_config,
                           generator=torch.Generator().manual_seed(0),
                           device="cpu")
    return jtree, ttree


@pytest.mark.parametrize("mesh_key", list(MESHES))
@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_lm_param_specs_match_jax(arch_id, mesh_key):
    jmesh, tmesh = _meshes(mesh_key)
    jtree, ttree = _lm_trees(arch_id)
    for jrules, trules in (
            (JSHR.lm_param_rules(jmesh), SHR.lm_param_rules(tmesh)),
            (JSHR.lm_param_rules(jmesh, fsdp=False),
             SHR.lm_param_rules(tmesh, fsdp=False)),
            (JSHR.lm_param_rules_zero(jmesh),
             SHR.lm_param_rules_zero(tmesh))):
        want, got = _jax_specs(jtree, jrules), _port_specs(ttree, trules)
        assert list(want) == list(got)          # same paths, same order
        assert want == got


@pytest.mark.parametrize("mesh_key", list(MESHES))
def test_gnn_and_recsys_param_specs_match_jax(mesh_key):
    jmesh, tmesh = _meshes(mesh_key)
    cases = [(_gnn_trees(a), JSHR.gnn_param_rules(jmesh),
              SHR.gnn_param_rules(tmesh)) for a in GNN_ARCHS]
    cases.append((_recsys_trees(), JSHR.recsys_param_rules(jmesh),
                  SHR.recsys_param_rules(tmesh)))
    for (jtree, ttree), jrules, trules in cases:
        want, got = _jax_specs(jtree, jrules), _port_specs(ttree, trules)
        assert list(want) == list(got)
        assert want == got


@pytest.mark.parametrize("mesh_key", list(MESHES))
def test_input_and_cache_specs_match_jax(mesh_key):
    jmesh, tmesh = _meshes(mesh_key)
    assert JSHR.batch_axes(jmesh) == SHR.batch_axes(tmesh)
    for batch in (1, 2, 3, 4, 6, 8, 16):
        for fn in ("lm_input_specs", "recsys_input_specs"):
            want = getattr(JSHR, fn)(jmesh, batch=batch)
            got = getattr(SHR, fn)(tmesh, batch=batch)
            assert {k: tuple(v) for k, v in want.items()} == \
                {k: tuple(v) for k, v in got.items()}, (fn, batch)
        for seq in (128, 8192):
            assert tuple(JSHR.lm_cache_spec(jmesh, batch=batch, seq=seq)) \
                == tuple(SHR.lm_cache_spec(tmesh, batch=batch, seq=seq))
    want = JSHR.gnn_input_specs(jmesh)
    got = SHR.gnn_input_specs(tmesh)
    assert {k: tuple(v) for k, v in want.items()} == \
        {k: tuple(v) for k, v in got.items()}


def test_partition_spec_normalises_as_jax():
    P = jax.sharding.PartitionSpec
    for entries in [(), (None,), ("data",), (("data",),), ((),),
                    (("pod", "data"), None), (None, ("data",), "model")]:
        assert tuple(PartitionSpec(*entries)) == tuple(P(*entries)), entries


# -- placements ---------------------------------------------------------------

CASES = [((16, 8), ("model", ("data",))), ((16, 8), (None, "model")),
         ((4, 16, 8), (None, ("pod", "data"), "model")),
         ((4, 16, 8), (None, ("data", "model"), None)),
         ((16, 6), (("model", "data"),)), ((8,), ()),
         ((2, 4, 8, 4), (None, "model", ("pod", "data"), None))]


def _jax_index_maps() -> dict:
    """Each mesh's device -> block slices under every case, from JAX's
    ``NamedSharding`` over 8 forced host devices (row-major device ids)."""
    code = f"""
        import json, os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        import jax, numpy as np
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
        meshes = {MESHES!r}
        cases = {CASES!r}
        out = {{}}
        for key, (dims, names) in meshes.items():
            mesh = Mesh(np.array(jax.devices()[:8]).reshape(dims), names)
            for i, (shape, spec) in enumerate(cases):
                if key == "data4_model2" and any(
                        "pod" in (e if isinstance(e, tuple) else (e,))
                        for e in spec):
                    continue
                m = NamedSharding(mesh, P(*spec)).devices_indices_map(shape)
                out[f"{{key}}/{{i}}"] = [
                    [[s.start or 0, n if s.stop is None else s.stop]
                     for s, n in zip(m[d], shape)]
                    for d in mesh.devices.reshape(-1)]
        print(json.dumps(out))
    """
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_spec_blocks_match_jax_named_sharding():
    maps = _jax_index_maps()
    assert len(maps) >= 10
    for name, want in maps.items():
        key, i = name.split("/")
        shape, spec = CASES[int(i)]
        _, tmesh = _meshes(key)
        got = [[[s.start, s.stop] for s in sl]
               for sl in _block_slices(tmesh, spec, shape)]
        assert got == want, name


@pytest.mark.parametrize("mesh_key", list(MESHES))
@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_lm_params_place_and_gather_round_trip(arch_id, mesh_key):
    """Every leaf of the LM's tree placed by its rule on 8 CPU entries:
    each entry holds its own block (a copy, not a view), and the gather
    gives the leaf back bit for bit."""
    _, tmesh = _meshes(mesh_key)
    _, params = _lm_trees(arch_id)
    for rules in (SHR.lm_param_rules(tmesh), SHR.lm_param_rules_zero(tmesh)):
        placed = place_tree(params, SHR.shardings_from_rules(params, rules,
                                                             tmesh))
        specs = SHR.specs_from_rules(params, rules)

        def check(x, y, spec):
            assert isinstance(y, SpecBlocks) and tuple(y.spec) == spec
            assert y.shape == x.shape and y.dtype == x.dtype
            for sl, shard in zip(_block_slices(tmesh, spec, x.shape),
                                 y.shards):
                torch.testing.assert_close(shard, x[sl], rtol=0, atol=0)
                assert shard.data_ptr() != x.data_ptr()
            torch.testing.assert_close(gather(y), x, rtol=0, atol=0)
            np.testing.assert_array_equal(np.asarray(y), x.numpy())
            again = place(y, Placement(tmesh, spec=PartitionSpec()))
            torch.testing.assert_close(gather(again), x, rtol=0, atol=0)

        tree_map(check, params, placed, specs)


def test_uneven_and_bad_specs_raise_and_row_blocks_stay():
    _, tmesh = _meshes("data4_model2")
    x = torch.arange(6 * 4, dtype=torch.float32).reshape(6, 4)
    with pytest.raises(ValueError, match="evenly"):
        place(x, Placement(tmesh, spec=PartitionSpec("data")))
    with pytest.raises(ValueError, match="rank"):
        place(x, Placement(tmesh, spec=PartitionSpec(None, None, "data")))
    with pytest.raises(ValueError, match="at most once"):
        place(x, Placement(tmesh, spec=PartitionSpec("model", "model")))
    with pytest.raises(ValueError, match="at most once"):
        place(x, Placement(tmesh, spec=PartitionSpec("vertices")))
    rb = place(torch.arange(8), Placement(tmesh, "data"))
    assert isinstance(rb, RowBlocks) and len(rb.blocks) == 4
    assert torch.equal(gather(rb), torch.arange(8))
    with pytest.raises(ValueError, match="needs 8 devices"):
        make_mesh((4, 2), ("data", "model"), devices=["cpu"] * 7)
