"""The sweep's kernel lanes on the CPU, where every kernel wrapper runs its
plain version: the chooser's sweep form ``fused_window_choose_lanes``
(lanes of different policies and scale gates in one call) against the
per-lane plain chooser and against the JAX package's traced-policy Pallas
chooser (``fused_window_choose(policy=None)`` vmapped over lanes, in
interpret mode); ``Sweep(...).windowed().kernel()`` against the JAX
package's unsharded ``Sweep`` for every policy × both guards × autoscale
on and off, per-lane and heterogeneous streams, and the shared stream
under ``.sharded()``; and the rebalance lanes (mirrors
tests/test_fused_chooser.py:201-229 and tests/test_rebalance.py:161-188).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import Sweep as JSweep
from repro.kernels.fused_chooser import fused_chooser as jfk
from repro_torch.api import Sweep
from repro_torch.core import transition as tx
from repro_torch.core import windowed as wnd
from repro_torch.core.config import EngineConfig
from repro_torch.core.state import init_state
from repro_torch.kernels.fused_chooser import fused_chooser as fk
from repro_torch.kernels.fused_chooser.ref import (
    fused_window_choose_ref, prepare_window_ref,
)
from repro_torch.kernels.window_rng.ops import window_rng

from test_torch_engine import assert_same
from test_torch_sweep import (
    _assert_lanes, _churn, _heterogeneous, _jax_per_lane, _jax_policy_sweep,
    _pair, _per_lane_fixture, _policy_lanes, _runs,
)
from test_torch_engine import release_jax_executables  # noqa: F401


@pytest.mark.parametrize("autoscale", [True, False])
@pytest.mark.parametrize("guard", ["text", "alg1"])
def test_kernel_policy_lanes_match_jax(guard, autoscale):
    """Every policy in one kernel sweep: one sweep-form chooser call a
    window step, each lane equal to JAX's lane."""
    _, s_t = _churn()
    _, tr = _runs(_policy_lanes(guard, autoscale))
    got = Sweep(s_t, device="cpu").lanes(tr).windowed(64).kernel().run()
    _assert_lanes(_jax_policy_sweep(guard, autoscale), got)


@pytest.mark.parametrize("case", ["per_lane", "heterogeneous"])
def test_kernel_lanes_own_streams_match_jax(case):
    """Per-lane streams of unequal length, and of unequal geometry (the
    union geometry): each kernel lane equals JAX's."""
    if case == "per_lane":
        _, st, _, tr = _per_lane_fixture()
        want = _jax_per_lane()
    else:
        _, st, _, tr, want = _heterogeneous()
    _assert_lanes(want, Sweep(st, device="cpu").lanes(tr).windowed(64)
                  .kernel().run())


def _fc_pair(seed):
    """tests/test_fused_chooser.py's delete-heavy churn stream."""
    return _pair("interleaved_churn", ("social", 120, 360, 0),
                 warmup_frac=0.15, del_every=2, edge_del_every=4,
                 readd_every=6, seed=seed)


def _fc_cfg(policy, **kw):
    kw.setdefault("k_max", 6)
    kw.setdefault("max_cap", 110)
    kw.setdefault("k_init", 1 if policy == "sdp" else 4)
    kw.setdefault("autoscale", policy == "sdp")
    return kw


def test_kernel_lanes_parity_with_jax_windowed():
    """tests/test_fused_chooser.py's kernel lanes: per-lane streams, mixed
    policies and autoscale, windowed(32).kernel() equal to JAX's
    windowed(32) lanes; and its shared stream under ``.sharded()`` (one
    device here) equal to JAX's unsharded lanes."""
    pairs = [_fc_pair(seed=i) for i in range(3)]
    jr, tr = _runs([("sdp", _fc_cfg("sdp"), 0), ("greedy", _fc_cfg("greedy"), 1),
                    ("ldg", _fc_cfg("ldg"), 2)])
    want = JSweep([p[0] for p in pairs]).lanes(jr).windowed(32).run()
    got = (Sweep([p[1] for p in pairs], device="cpu").lanes(tr).windowed(32)
           .kernel().run())
    _assert_lanes(want, got)
    s_j, s_t = _fc_pair(seed=2)
    jr, tr = _runs([("sdp", _fc_cfg("sdp", autoscale=False, k_init=3), i)
                    for i in range(3)])
    _assert_lanes(JSweep(s_j).lanes(jr).windowed(32).run(),
                  Sweep(s_t, device="cpu").lanes(tr).windowed(32).kernel()
                  .sharded().run())


def test_kernel_requires_windowed_engine():
    _, s_t = _fc_pair(seed=2)
    with pytest.raises(ValueError, match="windowed engine"):
        Sweep(s_t, device="cpu").lane(
            "sdp", EngineConfig(**_fc_cfg("sdp"))).kernel().run()


# -- the chooser's sweep form ------------------------------------------------

_LANE_POLICIES = ("sdp", "fennel", "greedy", "sdp", "ldg", "random", "hash")


@functools.lru_cache(maxsize=None)
def _lane_inputs(k_max=6, w=32):
    """One window's chooser inputs for each of seven lanes: lane b's state
    after 64 + 16 b events of the churn stream (the port's plain windowed
    engine, SDP with autoscale), its next window's prep tables and random
    table, counters and knobs — stacked on a leading lane axis."""
    _, s = _fc_pair(seed=5)
    cfg = EngineConfig(**_fc_cfg("sdp", k_max=k_max, max_cap=60))
    et, vx, nb = (torch.from_numpy(np.ascontiguousarray(a))
                  for a in (s.etype, s.vertex, s.nbrs))
    per = []
    for b in range(len(_LANE_POLICIES)):
        st = init_state(s.n, s.max_deg, k_max, 1, seed=b, device="cpu")
        t0 = 64 + 16 * b
        for t in range(0, t0, 16):
            st = wnd.run_window_mixed(st, et[t:t + 16], vx[t:t + 16],
                                      nb[t:t + 16], t, policy="sdp", cfg=cfg)
        sl = slice(t0, t0 + w)
        prep = prepare_window_ref(st, et[sl], vx[sl], nb[sl])
        per.append((prep.ev, prep.src_lbl, prep.touch,
                    window_rng(st.key, t0, w, k_max), *wnd.small_args(st),
                    tx.knob_tensor(cfg, s.n, "cpu")))
    return s.n, tuple(torch.stack(x) for x in zip(*per))


def _flags(gates):
    return torch.tensor([[tx.POLICY_INDEX[p], g]
                         for p, g in zip(_LANE_POLICIES, gates)],
                        dtype=torch.int32)


@pytest.mark.parametrize("dynamic", [True, False])
@pytest.mark.parametrize("guard", ["text", "alg1"])
def test_lanes_wrapper_plain_equals_per_lane_chooser(guard, dynamic):
    """The sweep-form wrapper's plain path, lanes of different policies and
    scale gates in one call: lane b equals ``fused_window_choose_ref`` on
    lane b's inputs under its own policy and ``dynamic and gate``; and on
    the CPU nothing is launched."""
    n, args = _lane_inputs()
    gates = [1, 1, 0, 0, 1, 0, 1]
    before = (fk.fused_window_choose_lanes.launches,
              dict(fk.fused_window_choose_lanes.kernel_launches))
    got = fk.fused_window_choose_lanes(*args, _flags(gates), n=n,
                                       balance_guard=guard, dynamic=dynamic)
    assert before == (fk.fused_window_choose_lanes.launches,
                      fk.fused_window_choose_lanes.kernel_launches)
    for b, (p, g) in enumerate(zip(_LANE_POLICIES, gates)):
        want = fused_window_choose_ref(
            *(x[b] for x in args), n=n, policy=p, balance_guard=guard,
            autoscaling=dynamic and g == 1)
        for x, y in zip(got, want):
            assert torch.equal(x[b], y), (b, p, g)


@pytest.mark.parametrize("bad", [-1, 6])
def test_lanes_wrapper_plain_rejects_unknown_policy_index(bad):
    """A flags row whose index names no policy raises on the CPU (the card
    kernel traps): -1 does not wrap to the last policy, and there are six
    policies, so index 6 names none."""
    n, args = _lane_inputs()
    flags = _flags([1] * len(_LANE_POLICIES))
    flags[2, 0] = bad
    with pytest.raises(ValueError, match="lane 2: policy index"):
        fk.fused_window_choose_lanes(*args, flags, n=n, balance_guard="text",
                                     dynamic=True)


@pytest.mark.parametrize("dynamic", [True, False])
def test_lanes_wrapper_matches_jax_traced_policy_kernel(dynamic):
    """B1 against its TPU kernel: the JAX package's traced-policy
    ``fused_window_choose(policy=None)`` vmapped over the lanes (the
    sweep's form, the Pallas kernel in interpret mode) and the port's
    sweep-form wrapper on the same inputs, bit for bit."""
    n, args = _lane_inputs()
    flags = _flags([1, 0, 1, 1, 0, 1, 0])
    got = fk.fused_window_choose_lanes(*args, flags, n=n,
                                       balance_guard="text", dynamic=dynamic)
    jargs = [jnp.asarray(x.numpy()) for x in args + (flags,)]

    def one(*a):
        return jfk.fused_window_choose(
            *a, n=n, policy=None, balance_guard="text", autoscaling=dynamic,
            dynamic=dynamic, interpret=True)
    want = jax.vmap(one)(*jargs)
    for x, y in zip(want, got):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())


# -- rebalance lanes (tests/test_rebalance.py:161-188) -----------------------

def test_rebalance_lanes_gate_and_parity_match_jax():
    """Rebalance on lane 1 only, windowed(16) plain and kernel lanes and
    the scan: the gated-off lanes equal a sweep that never rebalanced, and
    every lane equals JAX's."""
    s_j, s_t = _pair("interleaved_churn", ("social", 90, 260, 2),
                     warmup_frac=0.2, del_every=3, edge_del_every=5, seed=4)
    kw = dict(k_max=8, k_init=4, autoscale=False)
    jr, tr = _runs([("sdp", kw, 0), ("sdp", kw, 0), ("greedy", kw, 0)])
    reb = dict(every=32, passes=1, lanes=[1])
    plain = Sweep(s_t, device="cpu").lanes(tr[::2]).windowed(16).run()
    want = JSweep(s_j).lanes(jr).windowed(16).rebalance(8, **reb).run()
    for kernel in (False, True):
        got = (Sweep(s_t, device="cpu").lanes(tr).windowed(16)
               .kernel(kernel).rebalance(8, **reb).run())
        _assert_lanes(want, got)
        for a, b in zip(plain, got[::2]):
            assert_same(a.state, b.state)            # gated-off lanes
    scan = (Sweep(s_t, device="cpu").lanes(tr[:2]).scan()
            .rebalance(8, **reb).run())
    # same cadence + same pass: the engines agree on the rebalanced lane
    for a, b in zip(want[:2], scan):
        assert_same(a.state, b.state)
    assert scan[0].trace is not None


def test_rebalance_cadence_skips_window_padding_like_jax():
    """A window-rounded stream end is not a full cadence interval: with
    ``every`` the last window multiple within the stream, the windowed
    lanes agree with JAX's (every lane rebalanced, ``m`` past n)."""
    s_j, s_t = _pair("build_stream", ("mesh", 40, 100, 8), seed=9)
    assert s_t.num_events % 16
    every = 16 * (s_t.num_events // 16)
    jr, tr = _runs([("greedy", dict(k_max=4, k_init=3, autoscale=False), 0),
                    ("sdp", dict(k_max=4, k_init=1, max_cap=60), 1)])
    _assert_lanes(
        JSweep(s_j).lanes(jr).windowed(16)
        .rebalance(10_000, every=every, passes=2).run(),
        Sweep(s_t, device="cpu").lanes(tr).windowed(16).kernel()
        .rebalance(10_000, every=every, passes=2).run())
