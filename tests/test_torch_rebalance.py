"""The port's rebalancing (repro_torch.rebalance, Partitioner.rebalance and
its cadence knobs) against the JAX package's, with no tolerance: the LPA
acceptance draws (``uniform``), ``migrate_core`` including its gated-off
moves, the migration pass on a tie-heavy state, the LPA pass and the whole
rebalance over random sessions, the LPA score's FMA form, the session's
auto / drift cadence, and fig16's lanes — leaf for leaf at quick scale, by
the pinned JAX digests at full scale."""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.api import Partitioner as JP
from repro.core import EngineConfig as JCfg
from repro.core import run_stream as jrun
from repro.core import transition as jtx
from repro.core.state import PartitionState as JState
from repro.rebalance import passes as jpasses
from repro_torch.api import Partitioner as TP
from repro_torch.api import scenarios as sc
from repro_torch.core import rng
from repro_torch.core import transition as ttx
from repro_torch.core.config import EngineConfig
from repro_torch.core.state import state_from_numpy
from repro_torch.rebalance import passes as tpasses

from test_torch_engine import assert_same, cfg_kw, churn_pair
from test_torch_graph import _same_stream

_J_RB = jax.jit(jpasses.rebalance_state, static_argnames=("m", "passes"))
_J_LPA = jax.jit(jpasses.lpa_pass, static_argnames=("passes",))
_J_MIG = jax.jit(jpasses.migration_pass, static_argnames=("m",))


def _f32(x):
    return torch.tensor(x, dtype=torch.float32)


def _carry(st):
    return state_from_numpy([np.asarray(x) for x in st], device="cpu")


def _session_state(seed, policy=None, n=150, m=420):
    policy = policy or ("sdp", "random", "hash", "ldg")[seed % 4]
    kw = cfg_kw(policy)
    s_j, _ = churn_pair(seed=seed, n=n, m=m)
    state, _ = jrun(s_j, policy=policy, cfg=JCfg(**kw), seed=seed)
    return state, kw


@pytest.mark.parametrize("seed", [0, 9, 2**31 - 1])
@pytest.mark.parametrize("n", [1, 7, 1001, 81306])
def test_uniform_bit_equal(seed, n):
    for t in (0, 5, 123456):
        key = jax.random.fold_in(jax.random.fold_in(
            jax.random.PRNGKey(seed), jpasses._SALT), t)
        kt = rng.fold_in(rng.fold_in(rng.prng_key(seed, "cpu"),
                                     tpasses._SALT), t)
        want = np.asarray(jax.random.uniform(key, (n,)))
        got = rng.uniform(kt, n).numpy()
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(want.view(np.int32), got.view(np.int32))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_migrate_core_matches_jax_and_gated_moves_change_nothing(seed):
    state, kw = _session_state(seed)
    n, k = state.assignment.shape[0], state.edge_load.shape[0]
    asg = np.asarray(state.assignment)
    act = np.asarray(state.active)
    r = np.random.default_rng(seed)
    cases = [(int(v), int(q), True) for v, q in
             zip(r.integers(0, n, 12), r.integers(0, k, 12))]
    present = np.flatnonzero(np.asarray(state.present))
    v0 = int(present[0])
    inactive = np.flatnonzero(~act)
    cases += [(v0, int(asg[v0]), True),                 # to its own label
              (v0, (int(asg[v0]) + 1) % k, False)]      # gate off
    if inactive.size:
        cases.append((v0, int(inactive[0]), True))       # to an inactive one
    absent = np.flatnonzero(~np.asarray(state.present))
    if absent.size:
        cases.append((int(absent[0]), 0, True))          # an absent vertex
    cases.append((v0, k + 5, True))                      # dst clipped
    for v, q, gate in cases:
        j_new, j_did = jtx.migrate_core(state, jnp.int32(v), jnp.int32(q),
                                        gate=jnp.bool_(gate))
        before = _carry(state)
        t_new, t_did = ttx.migrate_core(
            _carry(state), torch.tensor(v, dtype=torch.int32),
            torch.tensor(q, dtype=torch.int32), gate=torch.tensor(gate))
        assert bool(j_did) == bool(t_did)
        assert_same(j_new, t_new)
        if not bool(t_did):
            assert_same(JState(*(np.asarray(x) for x in before)), t_new)


def _tie_heavy(seed, n=96, k=8, d=6):
    """Every vertex sees each of two labels equally often, loads equal:
    gains tie everywhere, so the selection order decides."""
    r = np.random.default_rng(seed)
    assignment = (np.arange(n) % 2).astype(np.int32)
    adj = np.full((n, d), -1, np.int32)
    for v in range(n):
        nb = [u for u in r.permutation(n) if u != v][:d]
        adj[v] = nb
    present = np.ones(n, bool)
    key = np.asarray(jax.random.PRNGKey(seed))
    active = np.arange(k) < 4
    load = np.where(active, 100, 0).astype(np.int32)
    z = np.int32(0)
    return [assignment, present, adj, load, np.zeros(k, np.int32), active,
            np.int32(4), np.int32(n * d // 2), z, z, z, key,
            np.zeros((k, k), np.int32)]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("m", [1, 17, 96])
def test_migration_pass_tie_heavy_matches_jax(seed, m):
    leaves = _tie_heavy(seed)
    for slack in (0.0, 0.5, 4.0):
        js, jm = _J_MIG(JState(*map(jnp.asarray, leaves)), m=m,
                        slack=jnp.float32(slack), max_cap=jnp.float32(1e9))
        ts, tm = tpasses.migration_pass(
            state_from_numpy(leaves, device="cpu"), m=m, slack=_f32(slack),
            max_cap=_f32(1e9))
        assert int(jm) == int(tm)
        assert_same(js, ts)


def _synthetic(seed, n=300, d=6, k=16):
    """Arbitrary leaves (the pass reads them, it does not check them):
    near-equal large loads put LPA scores within rounding of its 1e-6
    margin, where the FMA form of the score decides."""
    r = np.random.default_rng(seed)
    kk = int(r.integers(2, k + 1))
    assignment = r.integers(0, kk, n).astype(np.int32)
    present = r.random(n) < 0.95
    assignment[~present] = -1
    adj = r.integers(-1, n, (n, d)).astype(np.int32)
    active = np.arange(k) < kk
    load = np.where(active, int(r.integers(1000, 400000))
                    + r.integers(0, 4, k), 0).astype(np.int32)
    z = np.int32(0)
    return [assignment, present, adj, load, np.zeros(k, np.int32), active,
            np.int32(kk), np.int32(10**6), z, z, z,
            np.asarray(jax.random.PRNGKey(seed)), np.zeros((k, k), np.int32)]


@pytest.mark.parametrize("block", range(4))
def test_lpa_score_form_over_many_states(block):
    """400 states; with the candidate's score unfused and the current
    label's as one FMA (XLA's CPU codegen) the port equals JAX on all of
    them — the unfused form alone misses at least one (seed 289)."""
    for seed in range(block * 100, block * 100 + 100):
        leaves = _synthetic(seed)
        slack = float(np.random.default_rng(seed).choice([0.0, 0.05, 0.25]))
        js = _J_LPA(JState(*map(jnp.asarray, leaves)), jnp.int32(seed),
                    passes=1, slack=jnp.float32(slack),
                    max_cap=jnp.float32(1e9))
        ts = tpasses.lpa_pass(state_from_numpy(leaves, device="cpu"), seed,
                              passes=1, slack=_f32(slack), max_cap=_f32(1e9))
        assert_same(js, ts)


@settings(max_examples=25, deadline=None, derandomize=True)
@given(seed=st.integers(0, 10**6), m=st.sampled_from([0, 1, 7, 40]),
       passes=st.sampled_from([0, 1, 3]),
       slack=st.sampled_from([0.0, 0.1, 0.25, 1.0]),
       t0=st.integers(0, 2**31 - 8))
def test_rebalance_state_property(seed, m, passes, slack, t0):
    """Random sessions (every policy, churn with deletions) and random
    (m, passes, slack, cursor): rebalance_state equals JAX's leaf for leaf,
    its stats too, and the counters equal a from-scratch recount."""
    state, kw = _session_state(seed % 1000)
    js, jst = _J_RB(state, jnp.int32(t0), jnp.float32(slack),
                    jnp.float32(kw["max_cap"]), True, m=m, passes=passes)
    ts, tst = tpasses.rebalance_state(_carry(state), t0, _f32(slack),
                                      _f32(kw["max_cap"]), True, m=m,
                                      passes=passes)
    assert_same(js, ts)
    assert_same(jst, tst)
    from repro_torch.core.metrics import recompute_counters
    rec = recompute_counters(ts.assignment.numpy(), ts.present.numpy(),
                             ts.adj.numpy(), ts.edge_load.shape[0])
    np.testing.assert_array_equal(rec["cut_matrix"], ts.cut_matrix.numpy())
    assert rec["cut_edges"] == int(ts.cut_edges)


def test_histograms_and_recount_match_jax():
    state, _ = _session_state(5)
    jh, jd = jpasses._histograms(state)
    for use_kernel in (True, False):
        th, td = tpasses._histograms(_carry(state), use_kernel)
        np.testing.assert_array_equal(np.asarray(jh), th.numpy())
        np.testing.assert_array_equal(np.asarray(jd), td.numpy())
    assert_same(jpasses._rebuild_counters(state),
                tpasses._rebuild_counters(_carry(state)))
    big = _carry(state)._replace(total_edges=torch.tensor(1 << 23,
                                                          dtype=torch.int32))
    with pytest.raises(ValueError, match="2\\*\\*24"):
        tpasses.rebalance_state(big, 0, _f32(0.1), _f32(1e9), m=1, passes=1)


# ---------------------------------------------------------------------------
# the session: rebalance(), auto_rebalance, rebalance_drift, events
# ---------------------------------------------------------------------------

def _feed_both(jp, tp, s_j, s_t, chunk):
    for t in range(0, s_j.num_events, chunk):
        sl = slice(t, t + chunk)
        jp.feed((s_j.etype[sl], s_j.vertex[sl], s_j.nbrs[sl]))
        tp.feed((s_t.etype[sl], s_t.vertex[sl], s_t.nbrs[sl]))
        assert_same(jp.state, tp.state)


def _same_events(jp, tp):
    assert tp.rebalance_events == jp.rebalance_events
    jm, tm = jp.metrics(), tp.metrics()
    for k in ("rebalances", "rebalance_moves", "rebalance_drift_fires",
              "edge_cut", "load_imbalance", "cursor"):
        assert jm[k] == tm[k], k
    assert tp._last_rebalance == jp._last_rebalance
    assert tp._drift_base == jp._drift_base


@pytest.mark.parametrize("policy,knobs", [
    ("sdp", dict(auto_rebalance=True, rebalance_every=40, rebalance_m=6,
                 rebalance_passes=1)),
    ("random", dict(auto_rebalance=True, rebalance_every=25,
                    rebalance_m=0, rebalance_passes=2,
                    rebalance_slack=0.05)),
    ("hash", dict(rebalance_drift=0.002, rebalance_m=10,
                  rebalance_passes=1)),
    ("ldg", dict(auto_rebalance=True, rebalance_every=60, rebalance_m=4,
                 rebalance_drift=0.01)),
])
def test_session_cadence_matches_jax(policy, knobs):
    s_j, s_t = churn_pair(seed=11, n=150, m=420)
    kw = cfg_kw(policy)
    jp = JP.from_stream(s_j, JCfg(**kw), policy=policy, seed=2, window=32,
                        **knobs)
    tp = TP.from_stream(s_t, EngineConfig(**kw), policy=policy, seed=2,
                        window=32, use_kernel=True, device="cpu", **knobs)
    _feed_both(jp, tp, s_j, s_t, 23)
    _same_events(jp, tp)
    assert tp.metrics()["rebalances"] >= 1
    # explicit passes with their own budgets; m = 0, passes = 0 is a no-op
    for args in (dict(m=50, passes=2, slack=0.0), dict(m=0, passes=0),
                 dict(m=3)):
        assert jp.rebalance(**args) == tp.rebalance(**args)
        assert_same(jp.state, tp.state)
    _same_events(jp, tp)


def test_rebalance_knob_validation_like_jax():
    cfg = EngineConfig()
    bad = [dict(rebalance_every=0), dict(rebalance_m=-1),
           dict(rebalance_passes=-2), dict(rebalance_slack=-0.1),
           dict(auto_rebalance=True, rebalance_m=0),
           dict(rebalance_drift=0.0),
           dict(rebalance_drift=0.1, rebalance_m=0)]
    for kw in bad:
        with pytest.raises(ValueError) as t_err:
            TP(cfg, device="cpu", **kw)
        with pytest.raises(ValueError) as j_err:
            JP(JCfg(), **kw)
        assert str(t_err.value) == str(j_err.value)


# ---------------------------------------------------------------------------
# fig16
# ---------------------------------------------------------------------------

def _jax_fig16_streams(quick):
    sys.path.insert(0, str(__import__("pathlib").Path(__file__).parents[1]))
    from benchmarks import fig16_quality
    return fig16_quality._streams(quick)


def _jax_fig16_cfg():
    c = sc.fig16_cfg()
    return JCfg(**{f: getattr(c, f) for f in c.__dataclass_fields__})


@pytest.mark.parametrize("lane", range(3))
def test_fig16_quick_lanes_match_jax(lane):
    """fig16's streams at quick scale, built by each package, are equal;
    each lane with and without rebalance(32, passes=2) equals JAX's leaf
    for leaf, its per-interval cut ratios too."""
    (name, s_j), (name_t, s_t) = (_jax_fig16_streams(True)[lane],
                                  sc.fig16_streams(True)[lane])
    assert name == name_t
    _same_stream(s_j, s_t)
    for rebalance in (False, True):
        jp, jrows = sc.quality_lane(JP, s_j, _jax_fig16_cfg(),
                                    rebalance=rebalance, m=sc.FIG16_M[True])
        tp, trows = sc.quality_lane(TP, s_t, sc.fig16_cfg(),
                                    rebalance=rebalance, m=sc.FIG16_M[True],
                                    device="cpu", use_kernel=True)
        assert jrows == trows
        assert_same(jp.state, tp.state)
        assert tp.rebalance_events == jp.rebalance_events


@pytest.mark.parametrize("lane", range(3))
def test_fig16_full_digests_are_jax(lane):
    """The JAX package's full-scale lanes, recomputed here, give the digests
    pinned in repro_torch.api.scenarios that chip_smoke.py holds the
    card's lanes to; the two packages' streams are equal."""
    (name, s_j), (_, s_t) = (_jax_fig16_streams(False)[lane],
                             sc.fig16_streams(False)[lane])
    _same_stream(s_j, s_t)
    for rebalance in (False, True):
        jp, _ = sc.quality_lane(JP, s_j, _jax_fig16_cfg(),
                                rebalance=rebalance, m=sc.FIG16_M[False])
        assert sc.state_digest(jp.state) == \
            sc.FIG16_FULL_DIGESTS[(name, rebalance)]


if __name__ == "__main__":
    # The JAX package's twitter session (the smoke run's: scale 1.0, the
    # churn stream, window 256) and the same state after rebalance(m=128,
    # passes=2) — the digests repro_torch.api.scenarios pins and
    # chip_smoke.py holds the card's run to. Too slow for the CPU tests.
    from repro.graph import csr as jcsr
    from repro.graph import datasets as jds
    from repro.graph import stream as jstream
    g = jcsr.cap_degree(jds.load_dataset("twitter"), sc.DEG_CAP)
    s = jstream.interleaved_churn(g, **sc.CHURN_ARGS)
    part = JP.from_stream(s, JCfg(**sc.LIFECYCLE_CFG["twitter"]),
                          policy="sdp", seed=0, window=256).feed(s)
    print("TWITTER_SESSION_DIGEST", sc.state_digest(part.state))
    print(part.rebalance(m=128, passes=2))
    print("TWITTER_REBALANCE_DIGEST", sc.state_digest(part.state))
