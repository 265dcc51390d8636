"""The port's window engines (repro_torch.core.windowed) are bit-identical
to the JAX faithful engine: run_stream_windowed with use_kernel=False (the
journal window) and use_kernel=True (on the CPU the kernels' plain
versions: partition_affinity_ref and the fused chooser's slot loop), over
window sizes 8/32/256, and single windows resumed from a state with
deletion holes."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import EngineConfig as JCfg
from repro.core import run_stream as jrun
from repro.core import windowed as jwnd
from repro.graph import stream as jstream
from repro_torch.core import windowed as twnd
from repro_torch.core.config import EngineConfig, POLICIES
from repro_torch.core.geometry import Geometry
from repro_torch.core.state import state_from_numpy
from repro_torch.kernels.fused_chooser.ops import run_window_mixed_fused

from test_torch_engine import assert_same, cfg_kw, churn_pair
from test_torch_engine import release_jax_executables  # noqa: F401


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("window", [8, 32, 256])
def test_windowed_sdp_autoscale(window, use_kernel):
    s_j, s_t = churn_pair()
    kw = cfg_kw("sdp")
    a, _ = jrun(s_j, cfg=JCfg(**kw), seed=2)
    b = twnd.run_stream_windowed(s_t, cfg=EngineConfig(**kw), seed=2,
                                 window=window, use_kernel=use_kernel,
                                 device="cpu")
    assert_same(a, b)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("policy,guard", [(p, "text") for p in POLICIES[1:]]
                         + [("sdp", "alg1")])
def test_windowed_policies(policy, guard, use_kernel):
    s_j, s_t = churn_pair(seed=11)
    kw = cfg_kw(policy, guard)
    a, _ = jrun(s_j, policy=policy, cfg=JCfg(**kw), seed=5)
    b = twnd.run_stream_windowed(s_t, policy=policy, cfg=EngineConfig(**kw),
                                 seed=5, window=32, use_kernel=use_kernel,
                                 device="cpu")
    assert_same(a, b)


def test_windowed_insert_only_and_geometry():
    """Pure-ADD streams ride the ADD-window path only; a larger geometry is
    a semantics no-op."""
    from repro.graph.generators import make_graph as jmake
    from repro_torch.graph.generators import make_graph as tmake
    from repro_torch.graph.stream import build_stream
    s_j = jstream.build_stream(jmake("mesh", 150, 400, seed=1), seed=4)
    s_t = build_stream(tmake("mesh", 150, 400, seed=1), seed=4)
    kw = cfg_kw("sdp")
    kw["max_cap"] = 60
    from repro.core.geometry import Geometry as JGeometry
    a, _ = jrun(s_j, cfg=JCfg(**kw), seed=1, geometry=JGeometry(160, 9))
    for uk in (False, True):
        b = twnd.run_stream_windowed(s_t, cfg=EngineConfig(**kw), seed=1,
                                     window=16, use_kernel=uk,
                                     geometry=Geometry(160, 9), device="cpu")
        assert_same(a, b)


def _mid_state(seed=13):
    """A JAX state halfway through a churn stream — present=False holes
    whose ids survivors' rows still name — carried to the port."""
    s_j, s_t = churn_pair(seed=seed)
    kw = cfg_kw("sdp")
    half = (s_j.num_events // 2 // 32) * 32
    first = jstream.VertexStream(etype=s_j.etype[:half],
                                 vertex=s_j.vertex[:half],
                                 nbrs=s_j.nbrs[:half], n=s_j.n)
    mid, _ = jrun(first, cfg=JCfg(**kw), seed=6)
    assert not bool(np.asarray(mid.present).all()), "no holes to test"
    return s_j, mid, half, kw


@pytest.mark.parametrize("w", [64, 29])
def test_mixed_window_resumes_from_deletion_holes(w):
    s_j, mid, half, kw = _mid_state()
    sl = slice(half, half + w)
    ets, vs, rows = s_j.etype[sl], s_j.vertex[sl], s_j.nbrs[sl]
    want = jwnd.run_window_mixed(mid, jnp.asarray(ets), jnp.asarray(vs),
                                 jnp.asarray(rows), jnp.int32(half),
                                 policy="sdp", cfg=JCfg(**kw))
    leaves = [np.asarray(x) for x in mid]
    for fn in (twnd.run_window_mixed, run_window_mixed_fused):
        got = fn(state_from_numpy(leaves, device="cpu"), torch.from_numpy(ets),
                 torch.from_numpy(vs), torch.from_numpy(rows), half,
                 policy="sdp", cfg=EngineConfig(**kw))
        assert_same(want, got)
        holes = ~got.present
        assert (got.assignment[holes] == -1).all()


def test_committed_scores_and_add_window_from_holes():
    s_j, mid, half, kw = _mid_state(seed=21)
    rows = s_j.nbrs[:40]
    sc_j, deg_j = jwnd.committed_scores(mid, jnp.asarray(rows))
    st = state_from_numpy([np.asarray(x) for x in mid], device="cpu")
    sc_t, deg_t = twnd.committed_scores(st, torch.from_numpy(rows))
    np.testing.assert_array_equal(np.asarray(sc_j), sc_t.numpy())
    np.testing.assert_array_equal(np.asarray(deg_j), deg_t.numpy())
    # an ADD window (with a pad and a duplicate add) from the holed state
    vs = s_j.vertex[:40].copy()
    vs[5] = -1
    vs[9] = vs[3]
    want = jwnd.run_window_adds(mid, jnp.asarray(vs), jnp.asarray(rows),
                                jnp.int32(half), policy="sdp", cfg=JCfg(**kw))
    got = twnd.run_window_adds(st, torch.from_numpy(vs), torch.from_numpy(rows),
                               half, policy="sdp", cfg=EngineConfig(**kw))
    assert_same(want, got)


def test_scatter_last_winner_is_explicit():
    dst = torch.full((6,), -1, dtype=torch.int32)
    idx = torch.tensor([2, 4, 2, 0, 2], dtype=torch.int32)
    vals = torch.tensor([10, 11, 12, 13, 14], dtype=torch.int32)
    mask = torch.tensor([True, True, True, True, False])
    twnd._scatter_last(dst, idx, vals, mask)
    assert dst.tolist() == [13, -1, 12, -1, 11, -1]
