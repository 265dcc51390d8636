"""The port's stream builders (repro_torch.graph.stream: dynamic_schedule,
poisson_arrivals, pad_stream, concat_streams, _append_dels and the three
adversarial quality streams, materialize_graph) and its offline stand-in
(repro_torch.core.offline) give arrays equal to the JAX package's for the
same seeds — fig16's inputs and its offline lane."""
import numpy as np
import pytest

from repro.core import metrics as jmet
from repro.core import offline as joff
from repro.core import geometry as jgeo
from repro.graph import csr as jcsr
from repro.graph import datasets as jds
from repro.graph import stream as jstream
from repro_torch.core import geometry as tgeo
from repro_torch.core import metrics as tmet
from repro_torch.core import offline as toff
from repro_torch.graph import csr as tcsr
from repro_torch.graph import datasets as tds
from repro_torch.graph import stream as tstream

from test_torch_graph import _same_graph, _same_stream

SEEDS = [0, 1, 7]


def _graphs(scale=0.06, cap=None):
    g_j = jds.load_dataset("wiki-vote", scale=scale)
    g_t = tds.load_dataset("wiki-vote", scale=scale)
    if cap is not None:
        g_j, g_t = jcsr.cap_degree(g_j, cap), tcsr.cap_degree(g_t, cap)
    return g_j, g_t


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kw", [{}, dict(add_pct=40.0, del_pct=10.0,
                                         n_intervals=3, max_deg=12,
                                         del_edges_per_interval=6)])
def test_dynamic_schedule_identical(seed, kw):
    g_j, g_t = _graphs()
    _same_stream(jstream.dynamic_schedule(g_j, seed=seed, **kw),
                 tstream.dynamic_schedule(g_t, seed=seed, **kw))


@pytest.mark.parametrize("seed", SEEDS)
def test_hub_arrivals_identical(seed):
    g_j, g_t = _graphs(cap=40)
    for kw in ({}, dict(del_frac=0.1, hub_frac=0.05, max_deg=30)):
        a = jstream.hub_arrivals(g_j, seed=seed, **kw)
        b = tstream.hub_arrivals(g_t, seed=seed, **kw)
        _same_stream(a, b)
        _same_graph(jstream.materialize_graph(a),
                    tstream.materialize_graph(b))


@pytest.mark.parametrize("seed", SEEDS)
def test_community_merge_identical(seed):
    for kw in (dict(block=40), dict(block=60, p_intra=0.2, bridges=10,
                                    bridge_deg=5, max_deg=20)):
        a = jstream.community_merge(seed=seed, **kw)
        b = tstream.community_merge(seed=seed, **kw)
        _same_stream(a, b)
        _same_graph(jstream.materialize_graph(a),
                    tstream.materialize_graph(b))


@pytest.mark.parametrize("seed", SEEDS)
def test_flash_crowd_identical(seed):
    g_j, g_t = _graphs()
    for kw in (dict(crowd=30), dict(crowd=50, attach=2, celebrities=3,
                                    depart_frac=0.0, max_deg=25)):
        a = jstream.flash_crowd(g_j, seed=seed, **kw)
        b = tstream.flash_crowd(g_t, seed=seed, **kw)
        _same_stream(a, b)
        _same_graph(jstream.materialize_graph(a),
                    tstream.materialize_graph(b))


@pytest.mark.parametrize("seed", SEEDS)
def test_materialize_graph_on_churn_identical(seed):
    """Vertex and edge deletions and re-adds (interleaved_churn) leave the
    same graph behind — the port's incidence-indexed deletion included."""
    g_j, g_t = _graphs()
    kw = dict(warmup_frac=0.3, del_every=2, edge_del_every=3, readd_every=4,
              seed=seed)
    _same_graph(
        jstream.materialize_graph(jstream.interleaved_churn(g_j, **kw)),
        tstream.materialize_graph(tstream.interleaved_churn(g_t, **kw)))
    kw = dict(add_pct=30.0, del_pct=15.0, del_edges_per_interval=9, seed=seed)
    _same_graph(
        jstream.materialize_graph(jstream.dynamic_schedule(g_j, **kw)),
        tstream.materialize_graph(tstream.dynamic_schedule(g_t, **kw)))


@pytest.mark.parametrize("seed", SEEDS)
def test_pad_concat_append_and_arrivals_identical(seed):
    g_j, g_t = _graphs()
    a = jstream.dynamic_schedule(g_j, seed=seed, max_deg=9)
    b = tstream.dynamic_schedule(g_t, seed=seed, max_deg=9)
    c_j = jstream.interleaved_churn(g_j, seed=seed)
    c_t = tstream.interleaved_churn(g_t, seed=seed)
    for mult in (1, 7, 64):
        _same_stream(jstream.pad_stream(a, mult), tstream.pad_stream(b, mult))
    _same_stream(jstream.concat_streams([a, c_j, a]),
                 tstream.concat_streams([b, c_t, b]))
    victims = np.random.default_rng(seed).choice(a.n, 5, replace=False)
    _same_stream(jstream._append_dels(a, victims, (3, 9)),
                 tstream._append_dels(b, victims, (3, 9)))
    for kw in (dict(rate=1000.0), dict(rate=37.5, mean_batch=3.0)):
        for x, y in zip(jstream.poisson_arrivals(a, seed=seed, **kw),
                        tstream.poisson_arrivals(b, seed=seed, **kw)):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
    for bad in (dict(rate=0.0), dict(rate=1.0, mean_batch=0.0)):
        with pytest.raises(ValueError):
            tstream.poisson_arrivals(b, **bad)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("k", [2, 4, 7])
def test_offline_partition_identical(seed, k):
    g_j, g_t = _graphs(scale=0.05)
    a_j = joff.bfs_grow(g_j, k, seed)
    a_t = toff.bfs_grow(g_t, k, seed)
    np.testing.assert_array_equal(a_j, a_t)
    for passes, slack in ((1, 0.05), (4, 0.2)):
        r_j = joff.fm_refine(g_j, a_j, k, passes=passes, balance_slack=slack)
        r_t = toff.fm_refine(g_t, a_t, k, passes=passes, balance_slack=slack)
        np.testing.assert_array_equal(r_j, r_t)
    o_j = joff.offline_partition(g_j, k, seed)
    o_t = toff.offline_partition(g_t, k, seed)
    assert o_j.dtype == o_t.dtype
    np.testing.assert_array_equal(o_j, o_t)
    assert joff.cut_of(g_j, o_j) == toff.cut_of(g_t, o_t)


def test_metrics_and_shrink_tier_identical():
    rng = np.random.default_rng(0)
    for _ in range(20):
        load = rng.integers(0, 500, 9)
        act = rng.random(9) < 0.7
        assert jmet.normalized_load_imbalance(load, act) == \
            tmet.normalized_load_imbalance(load, act)
        c, t = (int(x) for x in rng.integers(0, 1000, 2))
        assert jmet.edge_cut_ratio(c, t) == tmet.edge_cut_ratio(c, t)
        assert jmet.replication_factor(c, t) == tmet.replication_factor(c, t)
    assert tmet.normalized_load_imbalance(np.zeros(3), np.ones(3, bool)) == 0.0
    for cur in [(1024, 64, 16), (100, 7, 4), (8, 8, None)]:
        for req in [(1, 1), (60, 3), (129, 9), (1000, 64)]:
            for h in (2, 4):
                want = jgeo.shrink_tier(jgeo.Geometry(*cur),
                                        jgeo.Geometry(*req), hysteresis=h)
                got = tgeo.shrink_tier(tgeo.Geometry(*cur),
                                       tgeo.Geometry(*req), hysteresis=h)
                assert tuple(want) == tuple(got)
    with pytest.raises(ValueError, match="hysteresis"):
        tgeo.shrink_tier(tgeo.Geometry(8, 8), tgeo.Geometry(1, 1),
                         hysteresis=1)
