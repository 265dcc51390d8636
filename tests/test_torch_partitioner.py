"""The port's streaming session (repro_torch.api.Partitioner) against the
JAX package's: chopped feeds with use_kernel=True, auto-grow from an
unsized session, kernel/fallback window coverage, a JAX state carried
across mid-stream, the device rule, and the deferred arguments."""
import numpy as np
import pytest
import torch

from repro.api import Partitioner as JPartitioner
from repro.core import EngineConfig as JCfg
from repro.core import run_stream as jrun
from repro.graph import stream as jstream
from repro_torch.api import Partitioner
from repro_torch.api.partitioner import _DEFERRED
from repro_torch.core import engine as teng
from repro_torch.core.config import EngineConfig
from repro_torch.core.state import state_from_numpy
from repro_torch.kernels.fused_chooser.ops import run_window_mixed_fused

from test_torch_engine import assert_same, cfg_kw, churn_pair


def _feed_chunks(part, s, chunk):
    for t in range(0, s.num_events, chunk):
        sl = slice(t, t + chunk)
        part.feed((s.etype[sl], s.vertex[sl], s.nbrs[sl]))
    return part


@pytest.mark.parametrize("chunk", [1, 7, 45])
def test_chopped_feeds_match_jax_session(chunk):
    """Chunks of 1 and 7 ride the per-event loop, 45 straddles the 32-event
    windows; the port equals the JAX session with use_kernel=True leaf for
    leaf, and counts the same kernel/fallback windows."""
    s_j, s_t = churn_pair(seed=3)
    kw = cfg_kw("sdp")
    jp = _feed_chunks(JPartitioner.from_stream(s_j, JCfg(**kw), window=32,
                                               use_kernel=True), s_j, chunk)
    tp = _feed_chunks(Partitioner.from_stream(s_t, EngineConfig(**kw),
                                              window=32, use_kernel=True,
                                              device="cpu"), s_t, chunk)
    assert_same(jp.state, tp.state)
    jm, tm = jp.metrics(), tp.metrics()
    for k in ("kernel_windows", "fallback_windows", "cursor", "edge_cut",
              "total_edges", "num_partitions", "scale_events",
              "load_imbalance", "n", "max_deg", "state_bytes"):
        assert jm[k] == tm[k], k


@pytest.mark.parametrize("engine,use_kernel", [("auto", False),
                                               ("windowed", True),
                                               ("scan", True)])
def test_unsized_session_grows_like_jax(engine, use_kernel):
    s_j, s_t = churn_pair(seed=8)
    kw = cfg_kw("hash")
    jp = _feed_chunks(JPartitioner(JCfg(**kw), policy="hash", engine=engine,
                                   window=16, use_kernel=use_kernel), s_j, 50)
    tp = _feed_chunks(Partitioner(EngineConfig(**kw), policy="hash",
                                  engine=engine, window=16,
                                  use_kernel=use_kernel, device="cpu"), s_t, 50)
    assert tp.regeometries >= 1 and tp.geometry == tuple(jp.geometry)
    assert [(e["kind"], tuple(e["from"]), tuple(e["to"]))
            for e in tp.geometry_events] == \
        [(e["kind"], tuple(e["from"]), tuple(e["to"]))
         for e in jp.geometry_events]
    assert_same(jp.state, tp.state)
    assert tp.metrics()["kernel_windows"] == jp.metrics()["kernel_windows"]
    tp.grow_to(n=400, max_deg=150)
    assert (tp.n, tp.max_deg) == (400, 150)


def test_kernel_coverage_counts():
    _, s_t = churn_pair(seed=3)
    cfg = EngineConfig(**cfg_kw("sdp"))
    p = Partitioner.from_stream(s_t, cfg, window=32, use_kernel=True,
                                device="cpu")
    p.feed(s_t)
    full, tail = divmod(s_t.num_events, 32)
    m = p.metrics()
    assert m["kernel_windows"] == full
    assert m["fallback_windows"] == (1 if tail else 0)
    q = Partitioner.from_stream(s_t, cfg, window=32, device="cpu").feed(s_t)
    assert q.metrics()["kernel_windows"] == 0
    assert_same(p.state, q.state)


def test_trace_matches_jax():
    s_j, s_t = churn_pair(seed=6)
    kw = cfg_kw("sdp")
    jp = _feed_chunks(JPartitioner.from_stream(s_j, JCfg(**kw),
                                               collect_trace=True), s_j, 60)
    tp = _feed_chunks(Partitioner.from_stream(s_t, EngineConfig(**kw),
                                              collect_trace=True,
                                              device="cpu"), s_t, 60)
    assert_same(jp.trace(), tp.trace())
    assert_same(jp.state, tp.state)


def test_jax_state_carried_across_mid_stream():
    """A JAX state after the first half, carried with state_from_numpy; the
    port's engines ingest the second half; the result equals the JAX
    whole-stream run."""
    s_j, _ = churn_pair(seed=9)
    kw = cfg_kw("sdp")
    whole, _ = jrun(s_j, cfg=JCfg(**kw), seed=4)
    half = s_j.num_events // 2
    first = jstream.VertexStream(etype=s_j.etype[:half],
                                 vertex=s_j.vertex[:half],
                                 nbrs=s_j.nbrs[:half], n=s_j.n)
    mid, _ = jrun(first, cfg=JCfg(**kw), seed=4)
    cfg = EngineConfig(**kw)
    et = torch.from_numpy(s_j.etype[half:])
    vx = torch.from_numpy(s_j.vertex[half:])
    nb = torch.from_numpy(s_j.nbrs[half:])
    st = state_from_numpy([np.asarray(x) for x in mid], device="cpu")
    st, _ = teng.run_events(st, et, vx, nb, half, policy="sdp", cfg=cfg)
    assert_same(whole, st)
    # the same second half through the fused-window pipeline plus a tail
    st = state_from_numpy([np.asarray(x) for x in mid], device="cpu")
    w = 32
    t = 0
    rest = s_j.num_events - half
    while t + w <= rest:
        st = run_window_mixed_fused(st, et[t:t + w], vx[t:t + w],
                                    nb[t:t + w], half + t, policy="sdp",
                                    cfg=cfg)
        t += w
    st, _ = teng.run_events(st, et[t:], vx[t:], nb[t:], half + t,
                            policy="sdp", cfg=cfg)
    assert_same(whole, st)


# the constructor arguments the port once deferred; all but the sharding
# pair are ported now
_ONCE_DEFERRED = ("auto_rebalance", "auto_shrink", "rebalance_drift",
                  "rebalance_every", "rebalance_m", "rebalance_passes",
                  "rebalance_slack", "shard_devices", "sharded",
                  "shrink_every")


@pytest.mark.parametrize("name", _ONCE_DEFERRED)
def test_deferred_arguments_raise(name):
    """An argument of a later slice raises at any value but its default; one
    this port has taken in is accepted and kept as the JAX session keeps
    it."""
    if name in _DEFERRED:
        default, item = _DEFERRED[name]
        value = {bool: True, int: 7, float: 0.5}.get(type(default), 0.5)
        if name == "shard_devices":
            value = 2
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Partitioner(EngineConfig(), device="cpu", **{name: value})
        Partitioner(EngineConfig(), device="cpu", **{name: default})
        return
    value = {"auto_rebalance": True, "auto_shrink": True,
             "rebalance_drift": 0.5, "rebalance_slack": 0.5}.get(name, 7)
    part = Partitioner(EngineConfig(), device="cpu", **{name: value})
    jp = JPartitioner(JCfg(), **{name: value})
    assert getattr(part, name) == getattr(jp, name) == value


def test_deferred_methods_and_unknown_arguments(tmp_path):
    """The lifecycle methods run on a fresh session as the JAX session's
    do; an unknown argument is a TypeError."""
    p = Partitioner(EngineConfig(), device="cpu")
    jp = JPartitioner(JCfg())
    assert p.rebalance() == jp.rebalance()
    assert p.rebalance(m=0, passes=0) == {"cursor": 0, "m": 0, "passes": 0,
                                          "moved": 0}
    p.compact()
    jp.compact()
    assert p.geometry == tuple(jp.geometry)
    p.shrink_to(n=1, max_deg=1)
    assert p.snapshot(str(tmp_path)) == 0
    q = Partitioner.restore(str(tmp_path), EngineConfig(), device="cpu")
    assert q.cursor == 0 and q.geometry == p.geometry
    with pytest.raises(FileNotFoundError):
        Partitioner.restore(str(tmp_path / "none"), device="cpu")
    with pytest.raises(TypeError, match="unexpected keyword"):
        Partitioner(EngineConfig(), device="cpu", bogus=1)


def test_no_device_means_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Partitioner(EngineConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Partitioner(EngineConfig(), device="cuda")


def test_validation_matches_jax_session():
    _, s = churn_pair()
    cfg = EngineConfig(**cfg_kw("sdp"))
    with pytest.raises(ValueError, match="policy"):
        Partitioner.from_stream(s, cfg, policy="nope", device="cpu")
    with pytest.raises(ValueError, match="engine"):
        Partitioner.from_stream(s, cfg, engine="nope", device="cpu")
    with pytest.raises(ValueError, match="window"):
        Partitioner.from_stream(s, cfg, window=0, device="cpu")
    with pytest.raises(ValueError, match="collect_trace"):
        Partitioner.from_stream(s, cfg, engine="windowed", collect_trace=True,
                                device="cpu")
    with pytest.raises(ValueError, match="> 0"):
        Partitioner(cfg, n=0, max_deg=3, device="cpu")
    part = Partitioner(cfg, n=s.n, max_deg=s.max_deg, device="cpu")
    with pytest.raises(RuntimeError, match="collect_trace"):
        part.trace()
    with pytest.raises(TypeError, match="VertexStream"):
        part.feed(42)
    with pytest.raises(ValueError, match="shapes disagree"):
        part.feed((s.etype[:4], s.vertex[:3], s.nbrs[:4]))
    part.feed((s.etype[:0], s.vertex[:0], s.nbrs[:0]))
    assert part.cursor == 0 and part.sync() is part
    assert "device=cpu" in repr(part)
