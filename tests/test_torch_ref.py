"""The port's dict/set oracle of Algorithm 1 (``repro_torch.core.ref``)
against the JAX package's (``repro.core.ref``) on every case of
tests/test_sdp_engine.py, field for field; the port's faithful engine
against the port's oracle with that file's ``_assert_match``; and the
oracle's random draws against ``jax.random.randint(fold_in(...))``. All
exact: no tolerance."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import run_reference as jref
from repro.graph import generators as jgen
from repro.graph import stream as jstream
from repro_torch.core import engine, run_reference
from repro_torch.core import rng
from repro_torch.core.config import EngineConfig
from repro_torch.core.ref import _Draws
from repro_torch.graph import generators as tgen
from repro_torch.graph import stream as tstream

from test_sdp_engine import CASES, _assert_match
from test_torch_engine import release_jax_executables  # noqa: F401


def _cfg(jcfg) -> EngineConfig:
    return EngineConfig(**dataclasses.asdict(jcfg))


def _static():
    return tuple(mod.build_stream(gen.make_graph("mesh", 120, 350, seed=1),
                                  seed=2)
                 for mod, gen in ((jstream, jgen), (tstream, tgen)))


def _dynamic():
    return tuple(mod.dynamic_schedule(gen.make_graph("social", 90, 260,
                                                     seed=4),
                                      n_intervals=4, seed=5,
                                      del_edges_per_interval=5)
                 for mod, gen in ((jstream, jgen), (tstream, tgen)))


def _assert_same_oracle(want, got):
    """Every field of two oracle states equal, the adjacency sets too."""
    assert got.assignment == want.assignment
    assert got.adj == want.adj
    assert got.active == want.active
    assert got.edge_load == want.edge_load
    assert got.vertex_count == want.vertex_count
    for f in ("n", "k_max", "total_edges", "cut_edges", "denied",
              "scale_events", "num_partitions"):
        assert getattr(got, f) == getattr(want, f), f
    np.testing.assert_array_equal(got.cut_matrix, want.cut_matrix)
    assert got.cut_matrix.dtype == want.cut_matrix.dtype


ALL = ([("static", p, c, 3) for p, c in CASES]
       + [("dynamic", p, c, 6) for p, c in CASES[:3]])


@pytest.mark.parametrize("kind,policy,jcfg,seed", ALL)
def test_oracle_matches_jax_oracle(kind, policy, jcfg, seed):
    s_j, s_t = _static() if kind == "static" else _dynamic()
    want = jref(s_j, policy=policy, cfg=jcfg, seed=seed)
    got = run_reference(s_t, policy=policy, cfg=_cfg(jcfg), seed=seed)
    _assert_same_oracle(want, got)


@pytest.mark.parametrize("kind,policy,jcfg,seed", ALL)
def test_port_engine_matches_port_oracle(kind, policy, jcfg, seed):
    _, s_t = _static() if kind == "static" else _dynamic()
    cfg = _cfg(jcfg)
    state, _ = engine.run_stream(s_t, policy=policy, cfg=cfg, seed=seed,
                                 device="cpu")
    _assert_match(state, run_reference(s_t, policy=policy, cfg=cfg,
                                       seed=seed))


def test_oracle_takes_cpu_tensor_streams():
    _, s_t = _dynamic()
    as_t = dataclasses.replace(s_t, **{f: torch.from_numpy(getattr(s_t, f))
                                      for f in ("etype", "vertex", "nbrs")})
    cfg = _cfg(CASES[0][1])
    _assert_same_oracle(run_reference(s_t, cfg=cfg, seed=6),
                        run_reference(as_t, cfg=cfg, seed=6))


@pytest.mark.parametrize("seed", [0, 3, 2**31 - 1])
def test_draws_match_jax_randint_of_fold_in(seed):
    """Event ``i``'s draw onto [0, P), P = 1..16, is JAX's
    ``randint(fold_in(PRNGKey(seed), i), (), 0, P)``."""
    idx = (0, 1, 2, 7, 100, 4095, 70_001)
    draws = _Draws(rng.prng_key(seed, device="cpu"), max(idx) + 1)
    key = jax.random.PRNGKey(seed)
    for i in idx:
        k = jax.random.fold_in(key, i)
        for p in range(1, 17):
            assert draws.randint(i, p) == int(jax.random.randint(k, (), 0, p))
