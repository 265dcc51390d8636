"""fig12's from-scratch scale-in baseline (``cut_fn``) in the port against
the JAX package on the CPU: ``transition.scale_in(cut_fn=...)`` on a crafted
state, and ``runtime.sweep.sweep_events(cut_fn=recompute_cut)`` over
churn lanes that all scale in, bit for bit against JAX's ``sweep_events``
with the same recount and against the port's own incremental run. Exact
integer state: no tolerance."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import EngineConfig as JCfg
from repro.core import transition as jtx
from repro.core.state import init_state as jinit
from repro.graph import generators as jgen
from repro.graph import stream as jstream
from repro.runtime import sweep as jsweep
from repro_torch.core import transition as tx
from repro_torch.core.config import EngineConfig
from repro_torch.core.state import PartitionState, init_state
from repro_torch.graph import generators as tgen
from repro_torch.graph import stream as tstream
from repro_torch.runtime import sweep as tsweep

from test_torch_engine import assert_same
from test_torch_engine import release_jax_executables  # noqa: F401

# fig12's churn mix and knobs (benchmarks/fig12_autoscale_churn.py) on a
# 150-vertex graph, with a max_cap small enough that every lane scales in
CHURN = dict(warmup_frac=0.2, del_every=3, edge_del_every=5)
CFG = dict(k_max=6, k_init=1, max_cap=60, tolerance_param=60.0,
           dest_param=5.0, autoscale=True)
SEEDS = (0, 1, 2)
RESUME = 120      # the second chunk's t0: before every lane's first scale-in


def _streams():
    gj = jgen.make_graph("social", 150, 450, seed=0)
    gt = tgen.make_graph("social", 150, 450, seed=0)
    return ([jstream.interleaved_churn(gj, **CHURN, seed=s) for s in SEEDS],
            [tstream.interleaved_churn(gt, **CHURN, seed=s) for s in SEEDS])


def _jax_lanes(streams):
    cfg = JCfg(**CFG)
    T = max(s.num_events for s in streams)
    et, vx, nb, n, max_deg = jsweep._stack_streams(streams, T)
    states = jsweep._stack([jinit(n, max_deg, cfg.k_max, cfg.k_init, s)
                            for s in SEEDS])
    kns = jsweep._stack([jtx.knobs_arrays(cfg, n) for _ in SEEDS])
    pidx = jnp.full((len(SEEDS),), jtx.POLICY_INDEX["sdp"], jnp.int32)
    auto = jnp.ones((len(SEEDS),), bool)
    return states, kns, pidx, auto, et, vx, nb


def _port_lanes(streams):
    cfg = EngineConfig(**CFG)
    T = max(s.num_events for s in streams)
    et, vx, nb, n, max_deg = tsweep._stack_streams(streams, T, "cpu")
    states = tsweep._stack([init_state(n, max_deg, cfg.k_max, cfg.k_init, s,
                                       device="cpu") for s in SEEDS])
    kns = torch.stack([tx.knob_tensor(cfg, n, "cpu") for _ in SEEDS])
    pidx = [tx.POLICY_INDEX["sdp"]] * len(SEEDS)
    auto = [True] * len(SEEDS)
    return states, kns, pidx, auto, et, vx, nb


def _jax_sweep(args, lo, hi, cut_fn):
    states, kns, pidx, auto, et, vx, nb = args
    return jsweep.sweep_events(
        states, kns, pidx, auto, et[:, lo:hi], vx[:, lo:hi], nb[:, lo:hi],
        jnp.int32(lo), balance_guard="text", autoscale_mode="dynamic",
        shared_stream=False, cut_fn=cut_fn)


def _port_sweep(states, args, lo, hi, cut_fn):
    _, kns, pidx, auto, et, vx, nb = args
    return tsweep.sweep_events(   # consumes its states: give it a copy
        type(states)(*(x.clone() for x in states)), kns, pidx, auto,
        et[:, lo:hi], vx[:, lo:hi], nb[:, lo:hi], lo, balance_guard="text", autoscale_mode="dynamic",
        shared_stream=False, cut_fn=cut_fn)


def _scale_ins(trace) -> np.ndarray:
    """Each lane's scale-ins, from its trace: the events after which its
    partition count dropped (a scale-out raises it)."""
    npart = np.asarray(trace.num_partitions)
    return (np.diff(npart, axis=1) < 0).sum(axis=1)


@pytest.fixture(scope="module")
def lanes():
    return _streams()


def test_sweep_recount_matches_jax_and_the_incremental_run(lanes):
    """Events [RESUME, T) resumed from the incremental run's states: the
    port's recount lanes equal JAX's recount lanes and the port's own
    incremental lanes, state and trace, and every lane scales in."""
    js, ts = lanes
    ja, ta = _jax_lanes(js), _port_lanes(ts)
    T = ta[4].shape[1]
    jmid, _ = _jax_sweep(ja, 0, RESUME, None)
    tmid, _ = _port_sweep(ta[0], ta, 0, RESUME, None)
    assert_same(jmid, tmid)
    ja = (jmid,) + ja[1:]
    jre, jtr = _jax_sweep(ja, RESUME, T, jtx.recompute_cut)
    tre, ttr = _port_sweep(tmid, ta, RESUME, T, tx.recompute_cut)
    tin, tintr = _port_sweep(tmid, ta, RESUME, T, None)
    assert_same(jre, tre)
    assert_same(jtr, ttr)
    assert_same(jre, tin)
    assert_same(jtr, tintr)
    ins = _scale_ins(ttr)
    assert (ins >= 1).all(), ins
    np.testing.assert_array_equal(ins, _scale_ins(jtr))


def test_whole_stream_recount_matches_jax(lanes):
    """From event 0, one dispatch: the recount lanes against JAX's."""
    js, ts = lanes
    ja, ta = _jax_lanes(js), _port_lanes(ts)
    T = ta[4].shape[1]
    jre, jtr = _jax_sweep(ja, 0, T, jtx.recompute_cut)
    tre, ttr = _port_sweep(ta[0], ta, 0, T, tx.recompute_cut)
    assert_same(jre, tre)
    assert_same(jtr, ttr)
    assert (_scale_ins(ttr) >= 1).all()


def _to_port(jstate) -> PartitionState:
    return PartitionState(*(torch.from_numpy(np.array(x)) for x in jstate))


@pytest.mark.parametrize("gate", [True, False])
def test_scale_in_recount_on_a_crafted_state(lanes, gate):
    """``scale_in(cut_fn=recompute_cut)`` alone, on a lane's state with a
    deliberately wrong ``cut_edges`` and knobs under which the migrate
    fires: the cut comes from the recount (not the matrix), and the
    state equals JAX's, gated on and off."""
    js, _ = lanes
    ja = _jax_lanes(js)
    jmid, _ = _jax_sweep(ja, 0, RESUME, None)
    j0 = jsweep._unstack(jmid, 0)
    assert int(j0.num_partitions) > 1
    j0 = j0._replace(cut_edges=j0.cut_edges + 1000)
    n = j0.assignment.shape[0]
    cfg = dict(CFG, max_cap=10_000, tolerance_param=100.0, dest_param=0.0)
    jkn = jtx.knobs_arrays(JCfg(**cfg), n)
    tkn = tx.make_knobs(EngineConfig(**cfg), n, "cpu")
    want = jtx.scale_in(j0, jkn, gate=jnp.bool_(gate),
                        cut_fn=jtx.recompute_cut)
    got = tx.scale_in(_to_port(j0), tkn, gate=torch.tensor(gate),
                      cut_fn=tx.recompute_cut)
    assert_same(want, got)
    inc = tx.scale_in(_to_port(j0), tkn, gate=torch.tensor(gate))
    if gate:
        recount = int(jtx.recompute_cut(want.assignment, want.present,
                                        want.adj))
        assert int(got.cut_edges) == recount
        assert int(inc.cut_edges) == recount + 1000
        assert int(got.num_partitions) == int(j0.num_partitions) - 1
    else:
        assert_same(j0, got)
