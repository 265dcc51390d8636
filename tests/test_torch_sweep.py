"""The port's sweep (``repro_torch.api.Sweep``, ``repro_torch.runtime.
sweep``) against the JAX package's unsharded ``Sweep`` on the same streams
and lanes, on the CPU: every lane's state bit for bit, and the scan
engine's traces, for every policy × both guards × autoscale on and off,
per-event and plain windowed lanes, shared and per-lane streams of
unequal geometry, chunked scans, and the stacked ``sweep_events``. Mirrors
tests/test_sweep.py and tests/test_geometry.py's heterogeneous lanes. The
kernel lanes' cases and the rebalance lanes are in
test_torch_sweep_kernel.py, ``Sweep``'s validation and the ``run_sweep``
shim in test_torch_sweep_api.py."""
import functools

import numpy as np
import pytest
import torch

from repro.api import Sweep as JSweep
from repro.core import EngineConfig as JCfg
from repro.graph import generators as jgen
from repro.graph import stream as jstream
from repro.runtime.sweep import sweep_events as jsweep_events
from repro_torch.api import Sweep, SweepRun
from repro_torch.core import transition as tx
from repro_torch.core.config import EngineConfig, POLICIES
from repro_torch.core.state import init_state
from repro_torch.graph import generators as tgen
from repro_torch.graph import stream as tstream
from repro_torch.runtime import sweep_events

from test_torch_engine import assert_same
from test_torch_engine import release_jax_executables  # noqa: F401

# the kernel lanes' cases of the same tests are in test_torch_sweep_kernel.py
ENGINES = ("scan", "windowed")


def _pair(make, graph, **kw):
    """The same stream from both packages' generators."""
    fam, n, m, gseed = graph
    return (getattr(jstream, make)(jgen.make_graph(fam, n, m, seed=gseed), **kw),
            getattr(tstream, make)(tgen.make_graph(fam, n, m, seed=gseed), **kw))


def _runs(lanes):
    """(policy, cfg kwargs, seed) lanes as JAX and port SweepRun tuples."""
    return ([(p, JCfg(**kw), s) for p, kw, s in lanes],
            [SweepRun(p, EngineConfig(**kw), s) for p, kw, s in lanes])


def _build(sweep, engine, window=64):
    if engine in ("windowed", "kernel"):
        sweep = sweep.windowed(window)
    return sweep.kernel() if engine == "kernel" else sweep


def _assert_lanes(jres, tres, traces=True):
    assert len(jres) == len(tres)
    for a, b in zip(jres, tres):
        assert (a.policy, a.seed) == (b.policy, b.seed)
        assert_same(a.state, b.state)
        if traces and b.trace is not None:
            assert_same(a.trace, b.trace)


@functools.lru_cache(maxsize=None)
def _churn():
    return _pair("interleaved_churn", ("social", 120, 360, 0),
                 warmup_frac=0.15, del_every=2, edge_del_every=4,
                 readd_every=6, seed=7)


def _policy_lanes(guard, autoscale):
    return [(p, dict(k_max=6, max_cap=110, k_init=1 if p == "sdp" else 4,
                     autoscale=autoscale, balance_guard=guard), seed)
            for p in POLICIES for seed in (3,)] + [
        ("sdp", dict(k_max=6, max_cap=90, k_init=2, autoscale=autoscale,
                     balance_guard=guard), 5)]


@functools.lru_cache(maxsize=None)
def _jax_policy_sweep(guard, autoscale):
    s_j, _ = _churn()
    jr, _ = _runs(_policy_lanes(guard, autoscale))
    return JSweep(s_j).lanes(jr).run()


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("autoscale", [True, False])
@pytest.mark.parametrize("guard", ["text", "alg1"])
def test_policy_lanes_match_jax(guard, autoscale, engine):
    """Every policy in one sweep (plus a second SDP config) on a
    delete-heavy churn stream: each lane's state equals JAX's scan lane
    (which equals its run_stream), and the scan engine's traces too."""
    _, s_t = _churn()
    _, tr = _runs(_policy_lanes(guard, autoscale))
    got = _build(Sweep(s_t, device="cpu").lanes(tr), engine).run()
    assert all((r.trace is None) == (engine != "scan") for r in got)
    _assert_lanes(_jax_policy_sweep(guard, autoscale), got)


def test_autoscale_lanes_scale_both_ways():
    """The autoscale cases above really scale out and in."""
    _, s_t = _churn()
    _, tr = _runs(_policy_lanes("text", True))
    res = Sweep(s_t, device="cpu").lanes(tr[:1]).run()
    nps = res[0].trace.num_partitions.numpy()
    assert (np.diff(nps) > 0).any() and (np.diff(nps) < 0).any()


@functools.lru_cache(maxsize=None)
def _per_lane_fixture():
    """tests/test_sweep.py's lanes with their own streams: different
    orders, lengths and churn mixes."""
    graph = ("social", 90, 260, 2)
    pairs = [_pair("build_stream", graph, seed=1),
             _pair("dynamic_schedule", graph, n_intervals=3, seed=3,
                   del_edges_per_interval=5),
             _pair("interleaved_churn", graph, warmup_frac=0.2, del_every=3,
                   edge_del_every=5, seed=4)]
    lanes = [("sdp", dict(k_max=8, k_init=1, max_cap=100), 0),
             ("ldg", dict(k_max=8, k_init=3, autoscale=False), 1),
             ("sdp", dict(k_max=8, k_init=2, max_cap=120), 2)]
    streams_j, streams_t = zip(*pairs)
    assert len({s.num_events for s in streams_t}) > 1
    jr, tr = _runs(lanes)
    return list(streams_j), list(streams_t), jr, tr


@functools.lru_cache(maxsize=None)
def _jax_per_lane():
    sj, _, jr, _ = _per_lane_fixture()
    return JSweep(sj).lanes(jr).run()


@pytest.mark.parametrize("engine", ENGINES + ("chunked",))
def test_per_lane_streams_match_jax(engine):
    """Per-lane streams of unequal length: each lane equals JAX's, traces
    sliced to the lane's true length; ``chunked(37)`` concatenates the
    same traces."""
    _, st, _, tr = _per_lane_fixture()
    sweep = Sweep(st, device="cpu").lanes(tr)
    sweep = sweep.chunked(37) if engine == "chunked" else _build(sweep, engine)
    got = sweep.run()
    for r, s in zip(got, st):
        if r.trace is not None:
            assert r.trace.cut_edges.shape[0] == s.num_events
    _assert_lanes(_jax_per_lane(), got)


def test_config_lanes_vary_k_match_jax():
    """fig8-style: one policy, k_init varies per lane (windowed)."""
    s_j, s_t = _pair("build_stream", ("mesh", 100, 300, 4), seed=5)
    jr, tr = _runs([("sdp", dict(k_max=16, k_init=k, autoscale=False), 0)
                    for k in (2, 4, 8, 16)])
    _assert_lanes(JSweep(s_j).lanes(jr).windowed(64).run(),
                  Sweep(s_t, device="cpu").lanes(tr).windowed(64).run())


@functools.lru_cache(maxsize=None)
def _heterogeneous():
    """tests/test_geometry.py's three lanes of pairwise-different (n,
    max_deg)."""
    pairs = [_pair("build_stream", ("mesh", 60, 150, 1), seed=1),
             _pair("dynamic_schedule", ("social", 90, 260, 2), n_intervals=3,
                   seed=3, del_edges_per_interval=5),
             _pair("interleaved_churn", ("mesh", 140, 380, 3),
                   warmup_frac=0.3, del_every=4, seed=5)]
    streams_j, streams_t = zip(*pairs)
    assert len({s.n for s in streams_t}) == 3
    assert len({s.max_deg for s in streams_t}) > 1
    jr, tr = _runs([("sdp", dict(k_max=8, k_init=1, max_cap=100), 0),
                    ("greedy", dict(k_max=8, k_init=3, autoscale=False), 1),
                    ("ldg", dict(k_max=8, k_init=2, autoscale=False), 2)])
    return (list(streams_j), list(streams_t), jr, tr,
            JSweep(list(streams_j)).lanes(jr).run())


@pytest.mark.parametrize("engine", ENGINES)
def test_heterogeneous_lanes_match_jax(engine):
    """Lanes of unequal geometry stacked at the union geometry (an LDG lane
    included, whose capacity reads the union n): equal to JAX's lanes."""
    _, st, _, tr, want = _heterogeneous()
    got = _build(Sweep(st, device="cpu").lanes(tr), engine).run()
    union_n = max(s.n for s in st)
    assert all(r.state.assignment.shape[0] == union_n for r in got)
    _assert_lanes(want, got)


def test_sweep_events_stacked_form_matches_jax():
    """The public resumable scan over stacked lanes, resumed at t0, equals
    JAX's ``sweep_events`` (states and traces), shared stream."""
    import jax
    import jax.numpy as jnp
    from repro.core import state as jstate
    from repro.core import transition as jtx
    s_j, s_t = _churn()
    lanes = _policy_lanes("alg1", True)[:4]
    jr, tr = _runs(lanes)
    n, d, k = s_t.n, s_t.max_deg, 6
    jst = [jstate.init_state(n, d, k, r[1].k_init, r[2]) for r in jr]
    jstacked = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *jst)
    jkns = jax.tree_util.tree_map(lambda *x: jnp.stack(x),
                                  *[jtx.knobs_arrays(r[1], n) for r in jr])
    pidx = [tx.POLICY_INDEX[r.policy] for r in tr]
    auto = [r.cfg.autoscale for r in tr]
    sl = slice(50, 180)
    want_s, want_t = jsweep_events(
        jstacked, jkns, jnp.asarray(pidx, jnp.int32), jnp.asarray(auto),
        jnp.asarray(s_j.etype[sl]), jnp.asarray(s_j.vertex[sl]),
        jnp.asarray(s_j.nbrs[sl]), jnp.int32(50), balance_guard="alg1",
        autoscale_mode="dynamic", shared_stream=True)
    tst = [init_state(n, d, k, r.cfg.k_init, r.seed, device="cpu")
           for r in tr]
    stacked = type(tst[0])(*(torch.stack(x) for x in zip(*tst)))
    kns = torch.stack([tx.knob_tensor(r.cfg, n, "cpu") for r in tr])
    got_s, got_t = sweep_events(
        stacked, kns, torch.tensor(pidx), auto,
        *(torch.from_numpy(np.ascontiguousarray(a[sl]))
          for a in (s_t.etype, s_t.vertex, s_t.nbrs)), 50,
        balance_guard="alg1", autoscale_mode="dynamic", shared_stream=True)
    assert_same(want_s, got_s)
    assert_same(want_t, got_t)
