"""The window loops' kernel modules against the JAX package on the same
inputs, on the CPU (where every wrapper runs its plain version):
``fused_chooser.ops.run_window_adds_fused`` (partition_affinity, the
window RNG and the pure-ADD fixup) against JAX ``run_window_adds`` with
the Pallas ``scores_for_state`` (interpret mode), a window that adds one
vertex twice, ``window_rng`` against JAX ``fold_in`` + ``randint``, the
prep loop against JAX ``_prepare_window`` at grqc's 2,843-wide rows, and
the session's routing of windows to the kernel pipelines."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import EngineConfig as JCfg
from repro.core import run_stream as jrun
from repro.core import transition as jtx
from repro.core import windowed as jwnd
from repro.core.state import PartitionState as JState
from repro.graph import stream as jstream
from repro.kernels.fused_chooser import ops as jops
from repro.kernels.partition_affinity import ops as jpa_ops
from repro_torch.api import Partitioner
from repro_torch.core import rng, windowed as twnd
from repro_torch.core.config import EngineConfig, POLICIES
from repro_torch.core.state import state_from_numpy, state_to_numpy
from repro_torch.graph import stream as tstream
from repro_torch.kernels.fused_chooser import fused_chooser as tfk
from repro_torch.kernels.fused_chooser import ops as tops
from repro_torch.kernels.fused_chooser import sweep as fsweep
from repro_torch.kernels.fused_chooser.ref import prepare_window_ref
from repro_torch.kernels.fused_chooser.window_prep import window_prep
from repro_torch.kernels.window_rng.ops import window_rng

from test_torch_engine import assert_same, cfg_kw, churn_pair
from test_torch_windowed import _mid_state
from test_torch_engine import release_jax_executables  # noqa: F401


def _adds_case(k_max, policy, guard, autoscale, seed=5, w=32):
    """A JAX state halfway through a churn stream at ``k_max`` partition
    slots, and the pure-ADD window after it: the next w events with every
    deletion turned into a pad, and slot 9 adding slot 3's vertex again."""
    s_j, _ = churn_pair(seed=seed)
    kw = cfg_kw(policy, guard, autoscale)
    kw["k_max"] = k_max
    kw["k_init"] = min(kw["k_init"], k_max)
    half = s_j.num_events // 2
    first = jstream.VertexStream(etype=s_j.etype[:half],
                                 vertex=s_j.vertex[:half],
                                 nbrs=s_j.nbrs[:half], n=s_j.n)
    mid, _ = jrun(first, policy=policy, cfg=JCfg(**kw), seed=6)
    sl = slice(half, half + w)
    vs = np.where(s_j.etype[sl] == 0, s_j.vertex[sl], -1).astype(np.int32)
    vs[9] = vs[3] if vs[3] >= 0 else vs[9]
    return mid, vs, s_j.nbrs[sl], half, kw


def _assert_adds_match(mid, vs, rows, t0, kw, policy):
    want = jwnd.run_window_adds(mid, jnp.asarray(vs), jnp.asarray(rows),
                                jnp.int32(t0), policy=policy, cfg=JCfg(**kw),
                                score_fn=jpa_ops.scores_for_state)
    st = state_from_numpy([np.asarray(x) for x in mid], device="cpu")
    before = tfk.add_window_choose.launches
    got = tops.run_window_adds_fused(st, torch.from_numpy(vs),
                                     torch.from_numpy(rows), t0,
                                     policy=policy, cfg=EngineConfig(**kw))
    assert tfk.add_window_choose.launches == before     # the plain loop ran
    assert_same(want, got)


@pytest.mark.parametrize("guard", ["text", "alg1"])
@pytest.mark.parametrize("policy", POLICIES)
def test_run_window_adds_fused_matches_jax(policy, guard):
    mid, vs, rows, t0, kw = _adds_case(16, policy, guard, None)
    _assert_adds_match(mid, vs, rows, t0, kw, policy)


@pytest.mark.parametrize("autoscale", [True, False])
@pytest.mark.parametrize("k_max", [1, 200])
def test_run_window_adds_fused_matches_jax_any_k(k_max, autoscale):
    mid, vs, rows, t0, kw = _adds_case(k_max, "sdp", "text", autoscale)
    _assert_adds_match(mid, vs, rows, t0, kw, "sdp")


def test_run_window_adds_fused_from_deletion_holes():
    s_j, mid, half, kw = _mid_state(seed=21)
    vs = s_j.vertex[:40].copy()
    vs[5] = -1
    vs[9] = vs[3]
    _assert_adds_match(mid, vs, s_j.nbrs[:40], half, kw, "sdp")


def _dup_add_stream(pkg):
    """8 ADD events in one window; vertices 0 and 1 each added twice."""
    rows = np.full((8, 3), -1, np.int32)
    for i, r in enumerate([[1, 2], [0, 3], [0], [1], [4, 2], [5, 3], [0],
                           [1]]):
        rows[i, :len(r)] = r
    return pkg.VertexStream(etype=np.zeros(8, np.int32),
                            vertex=np.array([0, 1, 2, 3, 0, 1, 4, 5],
                                            np.int32),
                            nbrs=rows, n=6)


def test_duplicate_add_window_matches_jax():
    """A reference fault, pinned rather than fixed: both windowed engines
    take a window's freshness from the window-start presence, so both ADDs
    of a vertex commit (and the last one's row and label win), where the
    faithful per-event engine commits only the first. The port's windowed
    engine — plain and through the kernels' pipeline — equals JAX's
    windowed engine; both differ from the faithful engine (ROADMAP C)."""
    kw = dict(k_max=4, k_init=2, autoscale=False)
    want, _ = jrun(_dup_add_stream(jstream), cfg=JCfg(**kw), seed=0)
    windowed = jwnd.run_stream_windowed(_dup_add_stream(jstream),
                                        cfg=JCfg(**kw), seed=0, window=8)
    # 6 vertices, counted 8 times: vertices 0 and 1 twice each
    assert int(np.asarray(want.vertex_count).sum()) == 6
    assert int(np.asarray(windowed.vertex_count).sum()) == 8
    assert int(windowed.total_edges) != int(want.total_edges)
    for use_kernel in (False, True):
        got = twnd.run_stream_windowed(_dup_add_stream(tstream),
                                       cfg=EngineConfig(**kw), seed=0,
                                       window=8, use_kernel=use_kernel,
                                       device="cpu")
        assert_same(windowed, got)


_JAX_DRAW = jax.jit(jax.vmap(
    lambda key, i, m: jax.vmap(
        lambda mm: jax.random.randint(jax.random.fold_in(key, i), (), 0, mm))
    (m), in_axes=(None, 0, None)))


@pytest.mark.parametrize("k", [1, 16, 1000])
@pytest.mark.parametrize("t0", [0, 114_958, 2**32 - 100])
def test_window_rng_matches_jax(t0, k):
    """The table against fold_in + randint (a traced maxval draws the bits
    of ``rand_index_table``'s static one) over event indices t0 + i taken
    modulo 2^32; at t0 < 2^31 and K <= 16 against ``rand_index_table``
    itself."""
    w = 40
    for seed in (0, 2**31 - 1):
        key = jax.random.PRNGKey(seed)
        idx = ((t0 + np.arange(w, dtype=np.uint64)) % 2**32).astype(np.uint32)
        want = np.asarray(_JAX_DRAW(key, jnp.asarray(idx),
                                    jnp.arange(1, k + 1, dtype=jnp.int32)))
        before = window_rng.launches
        table = window_rng(rng.prng_key(seed, "cpu"), t0, w, k)
        assert window_rng.launches == before
        assert table.dtype == torch.int32
        np.testing.assert_array_equal(want, table.numpy())
        if t0 < 2**31 and k <= 16:
            np.testing.assert_array_equal(
                np.asarray(jtx.rand_index_table(key, t0, w, k)),
                table.numpy())


def test_prepare_window_ref_matches_jax_on_wide_rows():
    """grqc's 2,843-wide rows after one pure-ADD window, then a crafted
    mixed window (``sweep.crafted_window``): pads, a self-loop DEL_EDGE of
    an edge the window added, an edge deleted from both endpoints, a
    vertex added twice, a deleted vertex added again."""
    cpu = torch.device("cpu")
    state, _, _ = fsweep.window_state(cpu, "grqc", 1.0, 0, 2843, 16, 1500,
                                      256, 256, fsweep.CHURN)
    ets, vs, rows = fsweep.crafted_window(state, 48, seed=4)
    assert bool(((ets == 2) & (rows[:, 0] == vs)).any())     # a self-loop
    leaves = state_to_numpy(state)
    want = jops._prepare_window(JState(*(jnp.asarray(x) for x in leaves)),
                                jnp.asarray(ets.numpy()),
                                jnp.asarray(vs.numpy()),
                                jnp.asarray(rows.numpy()))
    assert int(np.asarray(want.ev)[:, 4].sum()) > 0          # existing edges
    got = prepare_window_ref(state, ets, vs, rows)
    for f in want._fields:
        np.testing.assert_array_equal(np.asarray(getattr(want, f)),
                                      getattr(got, f).numpy(), err_msg=f)
    np.testing.assert_array_equal(leaves.present, state.present.numpy())


def test_session_routes_windows_to_the_kernel_pipelines(monkeypatch):
    """use_kernel=True: pure-ADD windows go to run_window_adds_fused and
    mixed ones to run_window_mixed_fused; use_kernel=False: to the plain
    engines. Either way the state equals the faithful engine's."""
    s_j, s_t = churn_pair(seed=3)
    kw = cfg_kw("sdp")
    want, _ = jrun(s_j, cfg=JCfg(**kw), seed=0)
    calls = []

    def counted(module, name):
        fn = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, **k: (
            calls.append(name), fn(*a, **k))[1])

    for module, name in ((tops, "run_window_adds_fused"),
                         (tops, "run_window_mixed_fused"),
                         (twnd, "run_window_adds"),
                         (twnd, "run_window_mixed")):
        counted(module, name)
    adds = sum(bool((s_t.etype[t:t + 8] == 0).all())
               for t in range(0, s_t.num_events, 8))
    for use_kernel, names in ((True, ("run_window_adds_fused",
                                      "run_window_mixed_fused")),
                              (False, ("run_window_adds",
                                       "run_window_mixed"))):
        calls.clear()
        part = Partitioner.from_stream(s_t, EngineConfig(**kw), window=8,
                                       engine="windowed",
                                       use_kernel=use_kernel,
                                       device="cpu").feed(s_t)
        assert_same(want, part.state)
        assert adds > 0 and calls.count(names[0]) == adds
        assert calls.count(names[1]) == len(calls) - adds > 0
        assert set(calls) == set(names)
        m = part.metrics()
        assert (m["add_windows"], m["mixed_windows"]) == (
            adds, len(calls) - adds)


def test_window_kernels_refuse_mixed_devices():
    """A wrapper runs its kernel for CUDA tensors and its plain version for
    CPU ones; tensors on two devices (or another device type) raise."""
    s_j, mid, half, kw = _mid_state(seed=21)
    st = state_from_numpy([np.asarray(x) for x in mid], device="cpu")
    vs = torch.from_numpy(s_j.vertex[:16].copy())
    rows = torch.from_numpy(s_j.nbrs[:16])
    args = fsweep.add_window_args(st, EngineConfig(**kw), vs, rows, half)
    meta = [a.to("meta") if i == 4 else a for i, a in enumerate(args)]
    with pytest.raises(ValueError, match="one CUDA device or all on the CPU"):
        tfk.add_window_choose(*meta, n=st.assignment.shape[0], policy="sdp",
                              balance_guard="text", autoscaling=True)
    ets = torch.from_numpy(s_j.etype[:16])
    with pytest.raises(ValueError, match="one CUDA device or all on the CPU"):
        window_prep(st, ets.to("meta"), vs, rows)
    with pytest.raises(ValueError, match="one CUDA device or all on the CPU"):
        window_rng(st.key.to("meta"), half, 16, 4)
