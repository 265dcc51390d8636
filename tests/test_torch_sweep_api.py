"""The port's ``Sweep`` API against the JAX package's on the CPU: every
validation rule with JAX's message, the deprecated ``run_sweep`` shim
(warns, and returns ``Sweep``'s lanes: equal to JAX's), ``.sharded()``
on one device, ``.scan()`` after ``.windowed()``, the options of later
slices (vertex-sharded lanes, the ``cut_fn`` step) against JAX's, and
the choosers' policy-or-index form. Mirrors tests/test_api_sweep.py."""
import functools
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import Sweep as JSweep
from repro.core import EngineConfig as JCfg
from repro.core import run_stream as jrun
from repro.core import transition as jtx
from repro.core.state import init_state as jinit
from repro.runtime.sweep import run_sweep as jrun_sweep
from repro_torch.api import Sweep
from repro_torch.core import transition as tx
from repro_torch.core.config import EngineConfig, POLICIES
from repro_torch.core.state import init_state
from repro_torch.runtime import run_sweep

from test_torch_engine import assert_same
from test_torch_sweep import _assert_lanes, _pair, _runs
from test_torch_engine import release_jax_executables  # noqa: F401


def test_shared_stream_sharded_and_shim_match_jax():
    """``.sharded()`` on one device runs the same lanes; the deprecated
    ``run_sweep`` shim warns and returns ``Sweep``'s lanes."""
    s_j, s_t = _pair("build_stream", ("mesh", 60, 150, 8), seed=9)
    jr, tr = _runs([("sdp", dict(k_max=4, k_init=1, max_cap=80), 0),
                    ("ldg", dict(k_max=4, k_init=2, autoscale=False), 1)])
    want = JSweep(s_j).lanes(jr).run()
    _assert_lanes(want, Sweep(s_t, device="cpu").lanes(tr).sharded().run())
    with pytest.warns(DeprecationWarning, match="Sweep"):
        got = run_sweep(s_t, tr, device="cpu")
    _assert_lanes(want, got)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        wantw = jrun_sweep(s_j, jr, engine="windowed", window=32)
    with pytest.warns(DeprecationWarning):
        gotw = run_sweep(s_t, tr, engine="windowed", window=32, device="cpu")
    assert all(r.trace is None for r in gotw)
    _assert_lanes(wantw, gotw)
    # .scan() after .windowed() re-arms the chunked path
    resc = (Sweep(s_t, device="cpu").lanes(tr).windowed(64).scan()
            .chunked(16).run())
    _assert_lanes(want, resc)


# -- Sweep's validation: JAX's rules and messages ---------------------------

def _misuse(cls, stream, cfg):
    """(name, call) pairs of every rule ``Sweep`` enforces, each
    built from the package's own ``Sweep`` class."""
    k4 = cfg(k_max=4)
    return [
        ("windowed_chunk",
         lambda: cls(stream).lane("sdp", k4).windowed(64).chunked(16).run()),
        ("chunk_windowed",
         lambda: cls(stream).lane("sdp", k4).chunked(16).windowed(64).run()),
        ("scan_kernel", lambda: cls(stream).lane("sdp", k4).kernel().run()),
        ("every_zero", lambda: cls(stream).lane("sdp", k4)
         .rebalance(8, every=0).run()),
        ("negative", lambda: cls(stream).lane("sdp", k4)
         .rebalance(-1, passes=1).run()),
        ("empty_pass", lambda: cls(stream).lane("sdp", k4)
         .rebalance(0, passes=0).run()),
        ("not_multiple", lambda: cls(stream).lane("sdp", k4).windowed(16)
         .rebalance(8, every=24).run()),
        ("out_of_range", lambda: cls(stream).lane("sdp", k4)
         .rebalance(8, lanes=[1]).run()),
        ("streams", lambda: cls([stream, stream]).lane("sdp", k4).run()),
        ("k_max", lambda: cls(stream).lane("sdp", k4)
         .lane("sdp", cfg(k_max=8)).run()),
        ("balance_guard", lambda: cls(stream).lane("sdp", k4)
         .lane("sdp", cfg(k_max=4, balance_guard="alg1")).run()),
        ("policy", lambda: cls(stream).lanes([("nope", k4, 0)]).run()),
        ("window_zero", lambda: cls(stream).lane("sdp", k4).windowed(0)),
        ("chunk_zero", lambda: cls(stream).lane("sdp", k4).chunked(0)),
    ]


def test_validation_messages_equal_jax():
    s_j, s_t = _pair("build_stream", ("mesh", 40, 100, 8), seed=9)
    cases_j = _misuse(JSweep, s_j, JCfg)
    cases_t = _misuse(functools.partial(Sweep, device="cpu"), s_t,
                      EngineConfig)
    for (name, fj), (_, ft) in zip(cases_j, cases_t):
        with pytest.raises(ValueError) as ej:
            fj()
        with pytest.raises(ValueError) as et:
            ft()
        assert str(et.value) == str(ej.value), name
    assert Sweep(s_t, device="cpu").run() == []
    with pytest.raises(ValueError, match="engine"), pytest.warns(
            DeprecationWarning):
        run_sweep(s_t, [("sdp", EngineConfig(k_max=4), 0)], engine="nope",
                  device="cpu")


def test_later_options_raise_naming_their_roadmap_items():
    """The options of later slices are ported: ``sharded_vertices()``
    (A16) runs one vertex-sharded session a lane, equal to JAX's
    ``run_stream``, and ``make_masked_step(cut_fn=...)`` (A22) scans a
    churn stream that scales in equal to JAX's step with the same
    recount, bit for bit."""
    s_j, s_t = _pair("build_stream", ("mesh", 40, 100, 8), seed=9)
    (got,) = (Sweep(s_t, device="cpu").lane("sdp").windowed(32)
              .sharded_vertices(devices=["cpu"] * 3).run())
    want, _ = jrun(s_j, cfg=JCfg(), seed=0)
    assert_same(want, got.state)
    Sweep(s_t, device="cpu").sharded_vertices(False)
    s_j, s_t = _pair("interleaved_churn", ("social", 150, 450, 0), seed=0,
                     warmup_frac=0.2, del_every=3, edge_del_every=5)
    kw = dict(k_max=6, k_init=1, max_cap=60, tolerance_param=60.0,
              dest_param=5.0, autoscale=True)
    jst = jinit(s_j.n, s_j.max_deg, 6, 1, 3)
    jstep = jtx.make_masked_step(jtx.knobs_arrays(JCfg(**kw), s_j.n),
                                 s_j.n, balance_guard="text", policy="sdp",
                                 autoscale=True, cut_fn=jtx.recompute_cut)
    want, wtr = jtx.scan_events(jstep, jst, *map(jnp.asarray, (
        s_j.etype, s_j.vertex, s_j.nbrs)), jnp.int32(0))
    tst = init_state(s_t.n, s_t.max_deg, 6, 1, 3, device="cpu")
    tstep = tx.make_masked_step(tx.make_knobs(EngineConfig(**kw), s_t.n,
                                              "cpu"),
                                s_t.n, balance_guard="text", policy="sdp",
                                autoscale=True, cut_fn=tx.recompute_cut)
    got, gtr = tx.scan_events(tstep, tst, *map(torch.from_numpy, (
        s_t.etype, s_t.vertex, s_t.nbrs)), 0)
    assert_same(want, got)
    assert_same(wtr, gtr)
    assert (np.diff(gtr.num_partitions.numpy()) < 0).any()   # scaled in


def test_choosers_take_a_policy_or_its_index():
    for guard in ("text", "alg1"):
        for i, p in enumerate(POLICIES):
            assert tx.make_chooser(guard, policy_idx=i) is \
                tx.make_chooser(guard, p)
            assert tx.make_table_chooser(guard, policy_idx=i) is \
                tx.make_table_chooser(guard, policy=p)
        for bad in (dict(), dict(policy="sdp", policy_idx=0)):
            with pytest.raises(ValueError, match="exactly one"):
                tx.make_chooser(guard, **bad)
            with pytest.raises(ValueError, match="exactly one"):
                tx.make_table_chooser(guard, **bad)
        with pytest.raises(ValueError, match="names no policy"):
            tx.make_chooser(guard, policy_idx=len(POLICIES))
