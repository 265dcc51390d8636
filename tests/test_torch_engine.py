"""The port's faithful per-event engine (repro_torch.core.engine.run_stream)
is bit-identical to the JAX package's on interleaved churn streams — every
PartitionState leaf and every EventTrace field, load_std included — for
every policy, both balance guards, autoscale on and off. Plus the port's
state helpers against their JAX twins."""
import numpy as np
import pytest
import torch

import jax
from repro.core import EngineConfig as JCfg
from repro.core import run_stream as jrun
from repro.core import state as jstate
from repro.core.geometry import Geometry as JGeometry
from repro.graph import generators as jgen
from repro.graph import stream as jstream
from repro_torch.core import engine as teng
from repro_torch.core import state as tstate
from repro_torch.core.config import EngineConfig, POLICIES
from repro_torch.core.geometry import Geometry
from repro_torch.core.transition import recompute_cut
from repro_torch.graph import generators as tgen
from repro_torch.graph import stream as tstream

CHURN = dict(warmup_frac=0.15, del_every=2, edge_del_every=4, readd_every=6)


def churn_pair(seed=7, n=120, m=360):
    """The same churn stream from both packages' generators."""
    kw = dict(CHURN, seed=seed)
    s_j = jstream.interleaved_churn(jgen.make_graph("social", n, m, seed=0), **kw)
    s_t = tstream.interleaved_churn(tgen.make_graph("social", n, m, seed=0), **kw)
    return s_j, s_t


def cfg_kw(policy, guard="text", autoscale=None):
    return dict(k_max=6, max_cap=110, k_init=1 if policy == "sdp" else 4,
                autoscale=(policy == "sdp") if autoscale is None else autoscale,
                balance_guard=guard)


def assert_same(jax_tuple, torch_tuple):
    for f in jax_tuple._fields:
        want = np.asarray(getattr(jax_tuple, f))
        got = getattr(torch_tuple, f).cpu().numpy()
        assert want.dtype == got.dtype, (f, want.dtype, got.dtype)
        np.testing.assert_array_equal(want, got, err_msg=f)


@pytest.mark.parametrize("autoscale", [True, False])
@pytest.mark.parametrize("guard", ["text", "alg1"])
@pytest.mark.parametrize("policy", POLICIES)
def test_run_stream_bit_identical(policy, guard, autoscale):
    s_j, s_t = churn_pair()
    kw = cfg_kw(policy, guard, autoscale)
    a, tr_a = jrun(s_j, policy=policy, cfg=JCfg(**kw), seed=3)
    b, tr_b = teng.run_stream(s_t, policy=policy, cfg=EngineConfig(**kw),
                              seed=3, device="cpu")
    assert_same(a, b)
    assert_same(tr_a, tr_b)


def test_autoscale_churn_exercises_scale_in_and_out():
    """The churn matrix above really scales both ways (else the autoscale
    cases would test nothing)."""
    _, s_t = churn_pair()
    b, tr = teng.run_stream(s_t, policy="sdp", cfg=EngineConfig(**cfg_kw("sdp")),
                            seed=3, device="cpu")
    nps = tr.num_partitions.numpy()
    assert (np.diff(nps) > 0).any() and (np.diff(nps) < 0).any()
    assert int(b.scale_events) >= 4


def test_chunked_run_stream_and_trace_at():
    _, s_t = churn_pair(seed=5)
    cfg = EngineConfig(**cfg_kw("sdp"))
    a, tr_a = teng.run_stream(s_t, cfg=cfg, seed=1, device="cpu")
    b, tr_b = teng.run_stream(s_t, cfg=cfg, seed=1, chunk=37, device="cpu")
    for x, y in zip(a + tr_a, b + tr_b):
        assert torch.equal(x, y)
    s_j, _ = churn_pair(seed=5)
    from repro.core import trace_at as jtrace_at
    _, jtr = jrun(s_j, cfg=JCfg(**cfg_kw("sdp")), seed=1)
    idx = [1, 50, s_t.num_events]
    want, got = jtrace_at(jtr, idx), teng.trace_at(tr_a, idx)
    for k in want:
        np.testing.assert_array_equal(want[k], got[k], err_msg=k)


def test_run_stream_at_a_larger_geometry():
    s_j, s_t = churn_pair(seed=2)
    kw = cfg_kw("greedy")
    a, _ = jrun(s_j, policy="greedy", cfg=JCfg(**kw), seed=0,
                geometry=JGeometry(200, 128))
    b, _ = teng.run_stream(s_t, policy="greedy", cfg=EngineConfig(**kw),
                           seed=0, geometry=Geometry(200, 128), device="cpu")
    assert_same(a, b)
    with pytest.raises(ValueError, match="cannot ingest"):
        teng.run_stream(s_t, cfg=EngineConfig(**kw), geometry=Geometry(3, 3),
                        device="cpu")


def test_state_helpers_match_jax():
    s_j, s_t = churn_pair(seed=4)
    kw = cfg_kw("sdp")
    a, _ = jrun(s_j, cfg=JCfg(**kw), seed=9)
    b, _ = teng.run_stream(s_t, cfg=EngineConfig(**kw), seed=9, device="cpu")
    # grow_state: pad n, max_deg and k_max exactly as the JAX package does
    assert_same(jstate.grow_state(a, JGeometry(150, 100, 8)),
                tstate.grow_state(b, Geometry(150, 100, 8)))
    with pytest.raises(ValueError, match="cannot shrink"):
        tstate.grow_state(b, Geometry(10, 10))
    assert tstate.state_bytes(b) == jstate.state_bytes(a)
    assert tstate.state_metrics(b) == jstate.state_metrics(a)
    # recounts from scratch agree with the incremental counters
    healed = tstate.recount_cut_matrix(b._replace(
        cut_matrix=torch.zeros_like(b.cut_matrix)))
    assert torch.equal(healed.cut_matrix, b.cut_matrix)
    assert int(recompute_cut(b.assignment, b.present, b.adj)) == \
        int(b.cut_edges)


def test_state_numpy_round_trip_and_validation():
    s_j, _ = churn_pair(seed=4)
    a, _ = jrun(s_j, cfg=JCfg(**cfg_kw("sdp")), seed=9)
    leaves = [np.asarray(x) for x in a]
    st = tstate.state_from_numpy(leaves, device="cpu")
    assert st.key.dtype == torch.uint32
    assert_same(a, st)
    back = tstate.state_to_numpy(st)
    for x, y in zip(leaves, back):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    st.adj[0, 0] = 12345                     # copies, never shared
    assert leaves[2][0, 0] != 12345
    bad = list(leaves)
    bad[1] = bad[1].astype(np.int32)
    with pytest.raises(ValueError, match="present"):
        tstate.state_from_numpy(bad, device="cpu")
    with pytest.raises(ValueError, match="expected 13 leaves"):
        tstate.state_from_numpy(leaves[:-1], device="cpu")


def test_init_state_matches_jax_and_needs_cuda_by_default(monkeypatch):
    a = jstate.init_state(9, 4, 5, 2, seed=11)
    b = tstate.init_state(9, 4, 5, 2, seed=11, device="cpu")
    assert_same(a, b)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tstate.init_state(9, 4, 5, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        teng.run_stream(churn_pair()[1])


def test_jax_key_layout_is_uint32_pair():
    """The carried key is the JAX key's raw words (the port's
    state_from_numpy contract)."""
    key = np.asarray(jax.random.PRNGKey(11))
    assert key.dtype == np.uint32 and key.shape == (2,)
