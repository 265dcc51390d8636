"""window_rng's table axis and the multi-window draws on the CPU, against the
JAX package: the (L, w, K) plain version against JAX's fold_in + randint
for several keys, starts near the uint32 wrap, K = 1, 16, 1,000 and L = 1,
3, 64; ``fused_chooser.ops.WindowTables`` (the rows of one draw are the
one-window tables; a new draw when K, the key or the run's end says so);
kernel sessions fed through many windows with multi-window draws against
JAX's sessions and ``run_stream`` / ``run_stream_windowed`` (grqc's churn
stream at k_max 16 and 200, draw budgets of a few windows, K grown by a
restore between feeds, a rebalance between feeds); and a kernel sweep,
one draw a window step for all of its lanes, lane for lane equal to JAX's
unsharded ``Sweep``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import Partitioner as JPartitioner
from repro.core import EngineConfig as JCfg
from repro.core import run_stream as jrun
from repro.core import windowed as jwnd
from repro.graph import datasets as jdata
from repro.graph import stream as jstream
from repro_torch.api import Partitioner, Sweep
from repro_torch.core import rng
from repro_torch.core import windowed as twnd
from repro_torch.core.config import EngineConfig
from repro_torch.core.state import init_state
from repro_torch.graph import datasets as tdata
from repro_torch.graph import stream as tstream
from repro_torch.kernels.fused_chooser import ops as fops
from repro_torch.kernels.window_rng.ops import window_rng
from repro_torch.kernels.window_rng.ref import window_rng_ref

from test_torch_engine import assert_same
from test_torch_sweep import (
    _assert_lanes, _churn, _jax_policy_sweep, _policy_lanes, _runs,
)
from test_torch_engine import release_jax_executables  # noqa: F401

_JAX_DRAW = jax.jit(jax.vmap(
    lambda key, i, m: jax.vmap(
        lambda mm: jax.random.randint(jax.random.fold_in(key, i), (), 0, mm))
    (m), in_axes=(None, 0, None)))

CHURN = dict(warmup_frac=0.2, del_every=3, edge_del_every=5, seed=0)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread a test (restored after it): the sessions' plain
    window loops issue many tiny ops, and at k_max = 200 several test
    workers each spinning torch's default threads slow a case down more
    than twentyfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _key_words(lanes: int, seed: int) -> np.ndarray:
    """L keys' uint32 words: random, one of them zero."""
    words = np.random.default_rng(seed).integers(0, 2**32, (lanes, 2),
                                                 dtype=np.uint64)
    words[0] = 0
    return words.astype(np.uint32)


@pytest.mark.parametrize("t0", [2**32 - 7, 114_958])
@pytest.mark.parametrize("k", [1, 16, 1000])
@pytest.mark.parametrize("lanes", [1, 3, 64])
def test_table_axis_matches_jax(lanes, k, t0):
    """(L, 2) keys give the (L, w, K) tables: table j is JAX's draw for
    every m in 1..K at events t0 + i (modulo 2^32: the first start wraps
    inside the window) under key j, and equals its one-table draw."""
    w = 6 if lanes == 64 else 20
    words = _key_words(lanes, seed=lanes * 31 + k)
    keys = torch.from_numpy(words.view(np.int32)).view(torch.uint32)
    m = jnp.arange(1, k + 1, dtype=jnp.int32)
    before = window_rng.launches
    got = window_rng(keys, t0, w, k)
    assert window_rng.launches == before     # the CPU: the plain version
    assert got.dtype == torch.int32 and got.shape == (lanes, w, k)
    idx = ((t0 + np.arange(w, dtype=np.uint64)) % 2**32).astype(np.uint32)
    for j in range(lanes):
        want = np.asarray(_JAX_DRAW(jnp.asarray(words[j]), jnp.asarray(idx),
                                    m))
        np.testing.assert_array_equal(want, got[j].numpy())
        assert torch.equal(window_rng(keys[j], t0, w, k), got[j])


def test_windows_per_draw_budget():
    """64 MiB of int32 entries a draw: 4,096 of twitter's (256, 16)
    windows, 6 at K = 9,587, at least one."""
    assert fops.windows_per_draw(256, 16) == 4096
    assert fops.windows_per_draw(256, 9587) == 6
    assert fops.windows_per_draw(256, 1 << 20) == 1
    assert fops.DRAW_BUDGET_BYTES == 64 << 20


@pytest.mark.parametrize("opts,want", [
    (dict(engine="auto", use_kernel=True), [0, 1, 1, 3]),
    (dict(engine="windowed", use_kernel=True), [1, 1, 2, 4]),
    (dict(engine="auto", sharded=True, shard_devices=["cpu"] * 2),
     [0, 0, 0, 0]),
    (dict(engine="scan", use_kernel=True), [0, 0, 0, 0]),
    (dict(engine="auto", use_kernel=True, collect_trace=True), [0, 0, 0, 0]),
    (dict(engine="windowed", use_kernel=False), [0, 0, 0, 0]),
])
def test_windows_drawn_ahead(opts, want):
    """The windows of a feed of T events whose tables a session draws
    ahead, at T = 63, 64, 65, 200 with windows of 64: the full windows
    under "auto", every window under "windowed", none where the feed
    draws a table a window or runs no kernel window."""
    part = Partitioner(EngineConfig(k_max=4, k_init=1), n=16, max_deg=2,
                       window=64, device="cpu", **opts)
    assert [part.windows_drawn_ahead(T) for T in (63, 64, 65, 200)] == want


def test_window_tables_rows_and_redraws(monkeypatch):
    """``take`` gives each window the rows of one draw, equal to its own
    one-window table; it draws again past the draw's last window (never
    past ``end``), for another K, and for another key tensor."""
    draws = []

    def counted(key, t0, w, k):
        draws.append((t0, w, k))
        return window_rng_ref(key, t0, w, k)

    monkeypatch.setattr(fops, "window_rng", counted)
    monkeypatch.setattr(fops, "DRAW_BUDGET_BYTES", 4 * 5 * 8 * 3)  # 3 windows
    st = init_state(10, 2, 5, 1, seed=4, device="cpu")
    w, t0 = 8, 2**32 - 20
    tables = fops.WindowTables(w, t0 + 7 * w)
    for i in range(7):
        got = tables.take(st, t0 + i * w)
        assert torch.equal(got, window_rng_ref(st.key, t0 + i * w, w, 5))
    assert draws == [(t0, 24, 5), (t0 + 24, 24, 5), (t0 + 48, 8, 5)]
    wide = init_state(10, 2, 7, 1, seed=4, device="cpu")
    assert torch.equal(tables.take(wide, t0 + 48),
                       window_rng_ref(wide.key, t0 + 48, w, 7))
    other = st._replace(key=st.key.clone())
    tables.take(other, t0 + 48)
    assert len(draws) == 5


def _grqc(scale=0.05):
    """grqc's churn stream from both packages (the same arrays)."""
    s_j = jstream.interleaved_churn(jdata.load_dataset("grqc", scale=scale),
                                    **CHURN)
    s_t = tstream.interleaved_churn(tdata.load_dataset("grqc", scale=scale),
                                    **CHURN)
    for f in ("etype", "vertex", "nbrs"):
        np.testing.assert_array_equal(getattr(s_j, f), getattr(s_t, f))
    return s_j, s_t


def _cfg_kw(k_max):
    return dict(k_max=k_max, k_init=1, max_cap=60, autoscale=True)


def _count_draws(monkeypatch):
    calls = []

    def counted(key, t0, w, k):
        calls.append((t0, w, k))
        return window_rng_ref(key, t0, w, k)

    monkeypatch.setattr(fops, "window_rng", counted)
    return calls


def _feed(part, s, bounds):
    for a, b in zip(bounds[:-1], bounds[1:]):
        part.feed((s.etype[a:b], s.vertex[a:b], s.nbrs[a:b]))
    return part


@pytest.mark.parametrize("k_max,budget_windows", [(16, None), (200, None),
                                                  (16, 2), (200, 3)])
def test_session_draws_match_jax(monkeypatch, k_max, budget_windows):
    """A kernel session (windows of 64, padded tails) fed in chunks — one
    cut mid-window, one of a single event — draws each feed's tables in
    ceil(windows / windows_per_draw) launches and equals JAX's session fed
    the same chunks; the whole stream in one "auto" feed equals JAX's
    run_stream, and run_stream_windowed equals JAX's."""
    if budget_windows:
        monkeypatch.setattr(fops, "DRAW_BUDGET_BYTES",
                            4 * k_max * 64 * budget_windows)
    draws = _count_draws(monkeypatch)
    s_j, s_t = _grqc()
    kw, T = _cfg_kw(k_max), s_t.num_events
    bounds = [0, 100, 101, 300, T]
    tp = _feed(Partitioner.from_stream(s_t, EngineConfig(**kw), window=64,
                                       engine="windowed", use_kernel=True,
                                       device="cpu"), s_t, bounds)
    jp = _feed(JPartitioner.from_stream(s_j, JCfg(**kw), window=64,
                                        engine="windowed"), s_j, bounds)
    assert_same(jp.state, tp.state)
    per = fops.windows_per_draw(64, k_max)
    want = [-(-(-(-(b - a) // 64)) // per) for a, b in zip(bounds[:-1],
                                                          bounds[1:])]
    assert len(draws) == sum(want) and max(want) >= 1
    assert all(k == k_max for _, _, k in draws)
    if budget_windows:
        assert max(want) > 1          # a feed split over several draws

    del draws[:]
    whole = Partitioner.from_stream(s_t, EngineConfig(**kw), window=64,
                                    use_kernel=True, device="cpu").feed(s_t)
    assert len(draws) == -(-(T // 64) // per)
    assert_same(jrun(s_j, cfg=JCfg(**kw), seed=0)[0], whole.state)
    got = twnd.run_stream_windowed(s_t, cfg=EngineConfig(**kw), window=64,
                                   use_kernel=True, device="cpu")
    assert_same(jwnd.run_stream_windowed(s_j, cfg=JCfg(**kw), window=64),
                got)


def test_k_grown_by_restore_and_a_rebalance_between_feeds(tmp_path,
                                                          monkeypatch):
    """K grown from 8 to 16 by a restore between feeds, then a rebalance
    between two more feeds: each feed draws at its own K, and the session
    equals JAX's through the same steps."""
    draws = _count_draws(monkeypatch)
    s_j, s_t = _grqc()
    T = s_t.num_events
    a, b = 128, 256 + 20

    def steps(P, Cfg, s, directory):
        part = P.from_stream(s, Cfg(**_cfg_kw(8)), window=64,
                             use_kernel=P is Partitioner,
                             **({"device": "cpu"} if P is Partitioner
                                else {}))
        part.feed((s.etype[:a], s.vertex[:a], s.nbrs[:a]))
        part.snapshot(str(directory))
        part.wait()
        kw = {"device": "cpu", "use_kernel": True} if P is Partitioner \
            else {}
        part = P.restore(str(directory), Cfg(**_cfg_kw(16)), window=64, **kw)
        part.feed((s.etype[a:b], s.vertex[a:b], s.nbrs[a:b]))
        part.rebalance(m=16, passes=1)
        part.feed((s.etype[b:], s.vertex[b:], s.nbrs[b:]))
        return part

    tp = steps(Partitioner, EngineConfig, s_t, tmp_path / "t")
    jp = steps(JPartitioner, JCfg, s_j, tmp_path / "j")
    assert tp.state.edge_load.shape[0] == 16
    assert_same(jp.state, tp.state)
    assert [k for _, _, k in draws] == [8, 16, 16]
    assert [t0 for t0, _, _ in draws] == [0, a, b]
    assert sum(w for _, w, _ in draws) == 64 * (a // 64 + (b - a) // 64
                                                + (T - b) // 64)


def test_sweep_one_draw_a_window_step_matches_jax(monkeypatch):
    """A kernel sweep over every policy draws all of its lanes' tables of
    a window step in one window_rng call ((L, 2) keys), and each lane
    equals JAX's unsharded Sweep's."""
    calls = []

    def counted(key, t0, w, k):
        calls.append(tuple(key.shape))
        return window_rng_ref(key, t0, w, k)

    monkeypatch.setattr(fops, "window_rng", counted)
    _, s_t = _churn()
    _, tr = _runs(_policy_lanes("text", True))
    got = Sweep(s_t, device="cpu").lanes(tr).windowed(64).kernel().run()
    assert calls == [(len(tr), 2)] * -(-s_t.num_events // 64)
    _assert_lanes(_jax_policy_sweep("text", True), got)
    keys = torch.stack([rng.prng_key(r.seed, "cpu") for r in tr])
    assert torch.equal(window_rng(keys, 64, 64, 6)[2],
                       window_rng(keys[2], 64, 64, 6))
