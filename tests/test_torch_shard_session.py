"""Vertex-sharded sessions of the port (``repro_torch.runtime.shard_session``,
``repro_torch.core.sharded_state``, ``repro_torch.launch.mesh``) against the
JAX package on the CPU, on meshes of 1 to 8 row blocks (``["cpu"] * P``).

The JAX sharded session cannot run here (its ``shard_map`` fails on jax's
``check_rep``), so every state is held, bit for bit, to what the JAX
package's own gate holds it to: the dense ``run_stream`` on the same
seeded stream (``tests/test_shard_session.py:66-75``); on a window that
adds one vertex twice, to JAX's mixed window, which the sharded window
splits by rows (ROADMAP C). The row-block prep's plain version,
summed over the blocks, is held to the dense prep loop by a hypothesis
property."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import EngineConfig as JCfg
from repro.core import run_stream as jrun
from repro.core import windowed as jwnd
from repro.core.state import init_state as jinit
from repro.graph import generators as jgen
from repro.graph import stream as jstream
from repro_torch.api import Partitioner, Sweep, SweepRun
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.config import EngineConfig
from repro_torch.core.sharded_state import (
    gather_state, pad_rows, per_device_state_bytes, shard_state,
    unshard_state,
)
from repro_torch.core.state import init_state
from repro_torch.graph import generators as tgen
from repro_torch.graph import stream as tstream
from repro_torch.kernels.fused_chooser import sweep as fsweep
from repro_torch.kernels.fused_chooser.ref import (
    prepare_rows_ref, prepare_window_ref,
)
from repro_torch.launch.mesh import (
    RowBlocks, make_grid_mesh, make_vertices_mesh,
)
from repro_torch.runtime.recovery import RecoverableSession
from repro_torch.runtime.shard_session import run_stream_sharded
from test_torch_engine import release_jax_executables  # noqa: F401

W = 64  # small window: more windows (and sums) per stream


def cpus(p):
    return ["cpu"] * p


def _pair(n=80, m=240, seed=0):
    """The same ADD / DEL_EDGE / DEL_VERTEX churn stream from each
    package's generators — exercises every round-1 branch."""
    sj = jstream.interleaved_churn(jgen.make_graph("social", n, m, seed=seed),
                                   warmup_frac=0.25, del_every=3,
                                   seed=seed + 1)
    st_ = tstream.interleaved_churn(tgen.make_graph("social", n, m,
                                                    seed=seed),
                                    warmup_frac=0.25, del_every=3,
                                    seed=seed + 1)
    for f in ("etype", "vertex", "nbrs"):
        np.testing.assert_array_equal(np.asarray(getattr(sj, f)),
                                      np.asarray(getattr(st_, f)))
    return sj, st_


def _build_pair(n, m, seed):
    sj = jstream.build_stream(jgen.make_graph("social", n, m, seed=seed),
                              seed=seed)
    st_ = tstream.build_stream(tgen.make_graph("social", n, m, seed=seed),
                               seed=seed)
    np.testing.assert_array_equal(np.asarray(sj.nbrs), np.asarray(st_.nbrs))
    return sj, st_


def _chunks(s, cuts):
    et, vx, nb = (np.asarray(x) for x in (s.etype, s.vertex, s.nbrs))
    return [(et[a:b], vx[a:b], nb[a:b]) for a, b in zip(cuts[:-1], cuts[1:])]


def _assert_states_equal(jax_dense, port, n):
    """``tests/test_shard_session.py``'s ``_assert_states_equal``: every
    field of a JAX dense state against a port state (dense or sharded),
    rows cut to ``n``; a session's wider rows must be -1 padding."""
    if isinstance(port.assignment, RowBlocks):
        port = unshard_state(port)
    for f in jax_dense._fields:
        a = np.asarray(getattr(jax_dense, f))
        b = getattr(port, f).cpu().numpy()
        assert a.dtype == b.dtype, (f, a.dtype, b.dtype)
        if f in ("assignment", "present", "adj"):
            a, b = a[:n], b[:n]
        if f == "adj":
            d = min(a.shape[1], b.shape[1])
            assert (a[:, d:] == -1).all() and (b[:, d:] == -1).all(), \
                "adj width padding leaked real neighbours"
            a, b = a[:, :d], b[:, :d]
        np.testing.assert_array_equal(a, b, err_msg=f"field {f!r} diverged")


_DENSE = {}


def _dense(key, sj, policy, kw, seed):
    if key not in _DENSE:
        _DENSE[key] = jrun(sj, policy=policy, cfg=JCfg(**kw), seed=seed)[0]
    return _DENSE[key]


# -- run_stream_sharded: the bit-identity gate ---------------------------

POLICY_KW = {"sdp": dict(k_max=8, k_init=2, autoscale=True, max_cap=90),
             "ldg": dict(k_max=8, k_init=2, autoscale=False, max_cap=90),
             "fennel": dict(k_max=8, k_init=2, autoscale=False, max_cap=90)}


@pytest.mark.parametrize("width", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("policy", ["sdp", "ldg", "fennel"])
def test_run_stream_sharded_bit_identical(policy, width):
    sj, st_ = _pair()
    kw = POLICY_KW[policy]
    dense = _dense(("pair", policy), sj, policy, kw, 3)
    got = run_stream_sharded(st_, policy=policy, cfg=EngineConfig(**kw),
                             seed=3, window=W, devices=cpus(width))
    _assert_states_equal(dense, got, n=dense.assignment.shape[0])


@pytest.mark.parametrize("width", range(1, 9))
def test_run_stream_sharded_every_mesh_width(width):
    """The same stream over every mesh width 1..8 — each gathered result
    equals the dense run."""
    sj, st_ = _pair(n=60, m=150, seed=7)
    kw = dict(k_max=8, k_init=1, max_cap=60)
    dense = _dense(("width",), sj, "sdp", kw, 0)
    got = run_stream_sharded(st_, policy="sdp", cfg=EngineConfig(**kw),
                             seed=0, window=W,
                             mesh=make_vertices_mesh(devices=cpus(width)))
    _assert_states_equal(dense, got, n=dense.assignment.shape[0])


@pytest.mark.parametrize("width", [2, 4, 8])
def test_heterogeneous_padding_no_phantom_vertices(width):
    """n = 37 never divides a 2/4/8-block mesh: the padded rows stay inert
    — absent, unassigned, and in no counter."""
    sj, st_ = _build_pair(37, 90, 2)
    kw = dict(k_max=8, k_init=2, max_cap=40)
    dense = _dense(("pad",), sj, "sdp", kw, 1)
    mesh = make_vertices_mesh(devices=cpus(width))
    fn_state = shard_state(init_state(37, st_.max_deg, 8, 2, 1,
                                      device="cpu"), mesh)
    assert fn_state.assignment.shape[0] == pad_rows(37, width) > 37
    got = run_stream_sharded(st_, policy="sdp", cfg=EngineConfig(**kw),
                             seed=1, window=W, mesh=mesh)
    _assert_states_equal(dense, got, n=37)
    assert int(got.total_edges) == int(dense.total_edges)
    np.testing.assert_array_equal(got.vertex_count.numpy(),
                                  np.asarray(dense.vertex_count))
    assert int(got.vertex_count.sum()) == int(np.asarray(dense.present).sum())


def _dup_add_streams():
    """``tests/test_torch_window_kernels.py``'s stream: a window of 8 that
    adds vertices 0 and 1 twice each."""
    rows = np.full((8, 3), -1, np.int32)
    rows[1] = [0, -1, -1]
    rows[2] = [0, 1, -1]
    rows[3] = [2, -1, -1]
    rows[4] = [1, 3, -1]
    rows[5] = [2, 3, -1]
    rows[6] = [0, 5, -1]
    rows[7] = [4, -1, -1]
    out = []
    for mod in (jstream, tstream):
        out.append(mod.VertexStream(
            etype=np.zeros(8, np.int32),
            vertex=np.array([0, 1, 2, 3, 0, 1, 4, 5], np.int32),
            nbrs=rows.copy(), n=6))
    return out


@pytest.mark.parametrize("width", [1, 2, 4])
def test_duplicate_add_window_follows_the_mixed_window(width):
    """Two ADDs of one vertex in a window. The reference's pure-ADD window
    takes freshness from the window-start presence and commits both
    (ROADMAP C); its mixed window tracks presence slot by slot and commits
    the first only, as the faithful engine does. The sharded window is the
    mixed window split by rows (in JAX as in the port), so it equals JAX's
    ``run_window_mixed`` and ``run_stream`` here, not
    ``run_stream_windowed``, which routes this pure-ADD window to the
    pure-ADD path."""
    sj, st_ = _dup_add_streams()
    kw = dict(k_max=4, k_init=2, autoscale=False)
    mixed = jwnd.run_window_mixed(
        jinit(6, 3, 4, 2, 0), jnp.asarray(sj.etype), jnp.asarray(sj.vertex),
        jnp.asarray(sj.nbrs), jnp.int32(0), policy="sdp", cfg=JCfg(**kw))
    faithful, _ = jrun(sj, cfg=JCfg(**kw), seed=0)
    windowed = jwnd.run_stream_windowed(sj, cfg=JCfg(**kw), seed=0, window=8)
    assert int(np.asarray(windowed.vertex_count).sum()) == 8
    assert int(np.asarray(mixed.vertex_count).sum()) == 6
    got = run_stream_sharded(st_, cfg=EngineConfig(**kw), seed=0, window=8,
                             devices=cpus(width))
    part = Partitioner(EngineConfig(**kw), sharded=True, window=8,
                       shard_devices=cpus(width)).feed(st_)
    for want in (mixed, faithful):
        _assert_states_equal(want, got, n=6)
        _assert_states_equal(want, part.state, n=6)


# -- the row-block prep against the dense prep ----------------------------

N, D, PW, HOT = 10, 4, 16, 5
_vertex = st.integers(-1, HOT - 1)
_row = st.lists(st.integers(-1, N - 1), min_size=D, max_size=D)


def _assert_blocks_sum_to_dense(state, ets, vs, rows, width):
    """The plain row-block prep of each block, summed over the blocks,
    gives the dense prep's emissions, and the blocks' adjacency after it
    is the dense one's."""
    dense = prepare_window_ref(fsweep.clone_state(state), ets, vs, rows)
    sh = shard_state(state, make_vertices_mesh(devices=cpus(width)))
    n_loc = sh.adj.blocks[0].shape[0]
    preps = [prepare_rows_ref(a, p, ets, vs, rows, b * n_loc)
             for b, (a, p) in enumerate(zip(sh.adj.blocks,
                                            sh.present.blocks))]
    rows_dv = sum(p.rows_dv for p in preps) - 2
    flags = sum(p.flags for p in preps)
    assert int(flags.max()) <= 1, "a vertex has two owners"
    n = state.assignment.shape[0]
    assert torch.equal(sh.adj.gather()[:n], dense.adj)
    ev = dense.ev
    assert torch.equal(flags[:, 0], ev[:, 2]) and torch.equal(flags[:, 1],
                                                               ev[:, 3])
    exists = (ev[:, 0] == 2) & (flags[:, 2] != 0) & (flags[:, 3] != 0)
    assert torch.equal(exists.to(torch.int32), ev[:, 4])
    # a DEL_VERTEX scores its row as it stood at its slot
    dv = ev[:, 0] == 1
    src = torch.where(rows_dv >= 0, dense.label0[rows_dv.clamp(min=0)], -1)
    assert torch.equal(src[dv], dense.src_lbl[dv])


@pytest.mark.parametrize("width", [1, 3, 4])
@pytest.mark.parametrize("seed", range(3))
def test_row_prep_sums_to_dense_prep_on_crafted_windows(seed, width):
    """Pads, self-loops, an edge deleted from both endpoints, a vertex
    added twice, a deleted vertex added again; windows over hot rows."""
    state = fsweep.window_state(torch.device("cpu"),
                                *fsweep.WINDOW_SETUPS["odd"],
                                fsweep.CHURN)[0]
    w = fsweep.WINDOW_SETUPS["odd"][6]
    _assert_blocks_sum_to_dense(state, *fsweep.crafted_window(state, w, seed),
                                width)
    _assert_blocks_sum_to_dense(state, *fsweep.chain_window(state, 100, seed),
                                width)


@settings(max_examples=150, deadline=None)
@given(present=st.lists(st.booleans(), min_size=N, max_size=N),
       assign=st.lists(st.integers(0, 3), min_size=N, max_size=N),
       adj=st.lists(_row, min_size=N, max_size=N),
       slots=st.lists(st.tuples(st.integers(0, 3), _vertex, _row, _vertex),
                      min_size=PW, max_size=PW),
       width=st.integers(1, 6))
def test_row_prep_sums_to_dense_prep_on_few_vertex_windows(
        present, assign, adj, slots, width):
    state = init_state(N, D, 4, 2, seed=0, device="cpu")
    state.present.copy_(torch.tensor(present))
    state.assignment.copy_(torch.tensor(assign, dtype=torch.int32))
    state.adj.copy_(torch.tensor(adj, dtype=torch.int32))
    rows = np.array([r for _, _, r, _ in slots], np.int32)
    ets = np.array([e for e, _, _, _ in slots], np.int32)
    rows[:, 0] = np.where(ets == 2, [u for *_, u in slots], rows[:, 0])
    _assert_blocks_sum_to_dense(
        state, torch.from_numpy(ets),
        torch.tensor([v for _, v, _, _ in slots], dtype=torch.int32),
        torch.from_numpy(rows), width)


# -- placement helpers ----------------------------------------------------

@pytest.mark.parametrize("width", [1, 3, 4, 8])
def test_pad_rows_and_state_bytes(width):
    mesh = make_vertices_mesh(devices=cpus(width))
    assert pad_rows(37, width) % width == 0 and pad_rows(37, width) >= 37
    assert pad_rows(0, width) == width
    ref = init_state(64, 4, 8, 2, 0, device="cpu")
    state = shard_state(ref, mesh)
    assert per_device_state_bytes(state) > 0
    back = unshard_state(state, n=64)
    for f in ref._fields:
        assert torch.equal(getattr(ref, f), getattr(back, f)), f
    host = gather_state(state, n=64)
    assert isinstance(host.assignment, np.ndarray)
    assert host.assignment.shape == (64,)
    # blocks are copies: writing one leaves the dense state untouched
    state.adj.blocks[0].fill_(7)
    assert int(ref.adj.max()) == -1


def test_per_device_bytes_shrink_with_mesh_width():
    """The point of sharding: each entry holds ~1/P of the O(n) state."""
    st1 = init_state(1024, 8, 8, 2, 0, device="cpu")
    b1 = per_device_state_bytes(shard_state(st1, make_vertices_mesh(
        devices=cpus(1))))
    b4 = per_device_state_bytes(shard_state(st1, make_vertices_mesh(
        devices=cpus(4))))
    rows = 1024 * (4 + 1 + 8 * 4)
    assert b1 - b4 == rows - rows // 4


# -- the session: Partitioner(sharded=True) -------------------------------

@pytest.mark.parametrize("width", [1, 3, 4])
def test_sharded_session_chop_and_grow(width):
    """Uneven chunks and on-demand geometry growth: the sharded session
    equals a dense windowed session of the port, and JAX's run_stream."""
    sj, st_ = _pair(n=90, m=260, seed=5)
    kw = dict(k_max=8, k_init=2, max_cap=90)
    cfg = EngineConfig(**kw)
    shard = Partitioner(cfg, policy="sdp", sharded=True, window=W,
                        shard_devices=cpus(width))
    dense = Partitioner(cfg, policy="sdp", engine="windowed", window=W,
                        device="cpu")
    for chunk in _chunks(st_, [0, 17, 130, 131, st_.num_events]):
        shard.feed(chunk)
        dense.feed(chunk)
    shard.sync(), dense.sync()
    n_sem = shard._sem_geom.n
    assert n_sem == dense.n, "sharded session left the dense tier ladder"
    assert shard.n == pad_rows(n_sem, width)
    got = unshard_state(shard.state, n=n_sem)
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(dense.state, f)), f
    ref = _dense(("chop",), sj, "sdp", kw, 0)
    _assert_states_equal(ref, got, n=ref.assignment.shape[0])
    m = shard.metrics()
    assert m["shard_devices"] == width
    assert m["per_device_state_bytes"] > 0
    assert m["mixed_windows"] == m["fallback_windows"] > 0
    assert dense.metrics()["shard_devices"] == 1


def test_sharded_session_compact_rebalance_and_shrink():
    """compact(), rebalance() and maybe_shrink() gather, work dense and
    re-shard: the sharded session follows a dense one through all three."""
    _, st_ = _pair(n=90, m=260, seed=5)
    cfg = EngineConfig(k_max=8, k_init=2, max_cap=90)
    shard = Partitioner(cfg, sharded=True, window=W, shard_devices=cpus(3))
    dense = Partitioner(cfg, engine="windowed", window=W, device="cpu")
    half = st_.num_events // 2
    for p in (shard, dense):
        p.feed(_chunks(st_, [0, half])[0])
        p.grow_to(n=400)
        p.rebalance(m=8, passes=1)
        p.compact()
        p.feed(_chunks(st_, [half, st_.num_events])[0])
        assert p.maybe_shrink(hysteresis=1) in (True, False)
    assert shard.geometry_events == dense.geometry_events
    assert shard.rebalance_events == dense.rebalance_events
    got = unshard_state(shard.state, n=shard._sem_geom.n)
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(dense.state, f)), f


def test_sharded_snapshot_restore_cross_layout(tmp_path):
    """A sharded session's snapshot restores into a dense and a sharded
    session of another width; both resume bit-identically to run_stream."""
    sj, st_ = _pair(n=70, m=200, seed=9)
    kw = dict(k_max=8, k_init=2, max_cap=70)
    cfg = EngineConfig(**kw)
    half = st_.num_events // 2
    first, rest = _chunks(st_, [0, half, st_.num_events])
    ref = _dense(("snap",), sj, "sdp", kw, 0)

    live = Partitioner(cfg, policy="sdp", sharded=True, window=W, seed=0,
                       shard_devices=cpus(3))
    live.feed(first)
    d = str(tmp_path / "ck")
    live.snapshot(d)
    live.feed(rest)

    mgr = CheckpointManager(d, interval=1)
    assert mgr.geometry(mgr.latest()).n == live._sem_geom.n
    restored_dense = Partitioner.restore(d, cfg, policy="sdp",
                                         engine="windowed", window=W,
                                         device="cpu")
    restored_shard = Partitioner.restore(d, cfg, policy="sdp", sharded=True,
                                         window=W, shard_devices=cpus(2))
    for p in (restored_dense, restored_shard):
        assert p.cursor == half
        p.feed(rest)
    n = ref.assignment.shape[0]
    _assert_states_equal(ref, live.state, n=n)
    _assert_states_equal(ref, restored_dense.state, n=n)
    _assert_states_equal(ref, restored_shard.state, n=n)

    # and a dense snapshot restores sharded
    d2 = str(tmp_path / "ck2")
    dense = Partitioner(cfg, engine="windowed", window=W, device="cpu")
    dense.feed(first).snapshot(d2)
    back = Partitioner.restore(d2, cfg, sharded=True, window=W,
                               shard_devices=cpus(4)).feed(rest)
    _assert_states_equal(ref, back.state, n=n)


def test_reshard_and_remesh_mid_session(tmp_path):
    """A mesh-width change mid-stream (gather → re-pad → re-place) is not
    semantics; RecoverableSession.remesh routes sharded sessions to it."""
    sj, st_ = _pair(n=50, m=140, seed=11)
    kw = dict(k_max=8, k_init=2, max_cap=50)
    cfg = EngineConfig(**kw)
    cuts = [0, st_.num_events // 3, 2 * st_.num_events // 3, st_.num_events]
    a, b, c = _chunks(st_, cuts)
    ref = _dense(("remesh",), sj, "sdp", kw, 0)

    part = Partitioner(cfg, policy="sdp", sharded=True, window=W, seed=0,
                       shard_devices=cpus(4))
    sess = RecoverableSession(part, str(tmp_path / "rs"),
                              snapshot_every=10**9)
    sess.feed(a)
    sess.remesh(devices=cpus(1))     # "device loss": down to one block
    assert part.mesh.shape["vertices"] == 1
    sess.feed(b)
    part.reshard(cpus(5))            # and out to five
    assert part.metrics()["shard_devices"] == 5
    sess.feed(c)
    n = ref.assignment.shape[0]
    _assert_states_equal(ref, part.state, n=n)

    # dense sessions still need an explicit target device
    dense = Partitioner(cfg, policy="sdp", window=W, device="cpu")
    ds = RecoverableSession(dense, str(tmp_path / "rs2"),
                            snapshot_every=10**9)
    with pytest.raises(ValueError, match="needs the target device"):
        ds.remesh()


def test_recover_a_sharded_session(tmp_path):
    """A sharded RecoverableSession that died mid-stream recovers (restore
    + journal replay) into a sharded session of another width."""
    sj, st_ = _pair(n=50, m=140, seed=11)
    kw = dict(k_max=8, k_init=2, max_cap=50)
    cfg = EngineConfig(**kw)
    t = st_.num_events
    chunks = _chunks(st_, [0, t // 4, t // 2, 3 * t // 4, t])
    d = str(tmp_path / "rs")
    sess = RecoverableSession(
        Partitioner(cfg, sharded=True, window=W, shard_devices=cpus(2)), d,
        snapshot_every=t // 3)
    for ch in chunks[:3]:
        sess.feed(ch)
    sess.wait()
    back = RecoverableSession.recover(d, cfg, sharded=True, window=W,
                                      shard_devices=cpus(3))
    assert back.cursor == 3 * t // 4 and back.part.sharded
    back.feed(chunks[3])
    ref = _dense(("remesh",), sj, "sdp", kw, 0)
    _assert_states_equal(ref, back.state, n=ref.assignment.shape[0])


def test_service_over_a_sharded_session():
    """PartitionService drives a sharded session like a dense one: the
    coalesced submits land on JAX's whole-stream state, and where_many /
    route answer from the blocks' labels."""
    from repro_torch.api import PartitionService
    sj, st_ = _pair(n=70, m=200, seed=9)
    kw = dict(k_max=8, k_init=2, max_cap=70)
    part = Partitioner(EngineConfig(**kw), sharded=True, window=W,
                       shard_devices=cpus(3))
    with PartitionService(part, max_pending_chunks=4) as svc:
        t = st_.num_events
        for ch in _chunks(st_, list(range(0, t, 23)) + [t]):
            svc.submit(ch)
        svc.flush(timeout=60)
        ref = _dense(("snap",), sj, "sdp", kw, 0)
        _assert_states_equal(ref, svc.partitioner.state,
                             n=ref.assignment.shape[0])
        want = np.asarray(ref.assignment)
        np.testing.assert_array_equal(svc.where_many(np.arange(st_.n)),
                                      want)
        assert svc.where(st_.n + 99) == -1
        r = svc.route([[0, 1], [2, 3]])
        np.testing.assert_array_equal(r.src_part, want[[0, 2]])
        np.testing.assert_array_equal(r.dst_part, want[[1, 3]])


# -- sweep integration ----------------------------------------------------

def test_sweep_sharded_vertices_matches_run_stream():
    sj, st_ = _pair(n=60, m=160, seed=13)
    runs = [("sdp", dict(k_max=8, k_init=1, max_cap=60), 0),
            ("ldg", dict(k_max=8, k_init=3, autoscale=False), 1)]
    results = (Sweep(st_, device="cpu")
               .lanes([SweepRun(p, EngineConfig(**kw), seed)
                       for p, kw, seed in runs])
               .windowed(W).sharded_vertices(devices=cpus(3)).run())
    for r, (p, kw, seed) in zip(results, runs):
        ref, _ = jrun(sj, policy=p, cfg=JCfg(**kw), seed=seed)
        assert r.trace is None
        _assert_states_equal(ref, r.state, n=ref.assignment.shape[0])
    # the deprecated shim, one block on the sweep's device
    from repro_torch.runtime.sweep import run_sweep
    with pytest.warns(DeprecationWarning):
        shim = run_sweep(st_, [SweepRun("sdp", EngineConfig(**runs[0][1]))],
                         engine="windowed", window=W, shard_vertices=True,
                         device="cpu")
    ref, _ = jrun(sj, policy="sdp", cfg=JCfg(**runs[0][1]), seed=0)
    _assert_states_equal(ref, shim[0].state, n=ref.assignment.shape[0])


def test_sweep_sharded_vertices_validation():
    _, s = _pair(n=30, m=60, seed=1)

    def sweep():
        return Sweep(s, device="cpu").lane()

    with pytest.raises(ValueError, match="mutually exclusive"):
        sweep().windowed(W).sharded().sharded_vertices().run()
    with pytest.raises(ValueError, match="windowed engine"):
        sweep().scan().sharded_vertices().run()
    with pytest.raises(ValueError, match="kernel lanes"):
        sweep().windowed(W).kernel().sharded_vertices().run()
    with pytest.raises(ValueError, match="rebalance"):
        (sweep().windowed(W).rebalance(m=4, every=W)
         .sharded_vertices().run())
    with pytest.raises(ValueError, match="window_prep kernel takes"):
        (Sweep(s, device="cuda").lane().windowed(4096)
         .sharded_vertices(devices=["cuda:0"]).run())


def test_sharded_session_validation():
    with pytest.raises(ValueError, match="use_kernel"):
        Partitioner(sharded=True, use_kernel=True, shard_devices=cpus(2))
    with pytest.raises(ValueError, match="scan"):
        Partitioner(sharded=True, engine="scan", shard_devices=cpus(2))
    with pytest.raises(ValueError, match="scan"):
        Partitioner(sharded=True, collect_trace=True, shard_devices=cpus(2))
    p = Partitioner(sharded=True, shard_devices=cpus(2))
    with pytest.raises(ValueError, match="reshard"):
        p.place("cpu")
    dense = Partitioner(device="cpu")
    with pytest.raises(ValueError, match="sharded=True sessions"):
        dense.reshard()
    # a card mesh is checked against the kernels' limits when built, and a
    # CPU session's reshard onto one before it moves
    with pytest.raises(ValueError, match="window_prep kernel takes"):
        Partitioner(sharded=True, window=4096, shard_devices=["cuda:0"])
    with pytest.raises(ValueError, match="k_max"):
        Partitioner(EngineConfig(k_max=20_000), sharded=True,
                    shard_devices=["cuda:0"] * 2)
    big = Partitioner(sharded=True, window=4096, shard_devices=cpus(2))
    with pytest.raises(ValueError, match="window_prep kernel takes"):
        big.reshard(["cuda:0"])
    assert big.mesh.devices == tuple(torch.device("cpu") for _ in range(2))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Partitioner(sharded=True)


@pytest.mark.parametrize("devices", [["cuda:0", "cpu"], ["cpu", "cuda:0"],
                                     ["cpu", "cpu", "cuda:1"]])
def test_mesh_rejects_cpu_and_card_entries(devices):
    """A mesh is all cards or all CPU: a card block's emissions read on the
    host would race their copy, so the builders, a session and a sweep
    refuse the mix before any device is touched."""
    with pytest.raises(ValueError, match="one type"):
        make_vertices_mesh(devices=devices)
    with pytest.raises(ValueError, match="one type"):
        make_grid_mesh(1, len(devices), devices=devices)
    with pytest.raises(ValueError, match="one type"):
        Partitioner(EngineConfig(k_max=4), n=40, max_deg=4, sharded=True,
                    shard_devices=devices)
    part = Partitioner(EngineConfig(k_max=4), n=40, max_deg=4, sharded=True,
                       shard_devices=cpus(2))
    with pytest.raises(ValueError, match="one type"):
        part.reshard(devices)
    assert part.mesh.devices == (torch.device("cpu"),) * 2


def test_mesh_builders_compose_or_raise():
    n_dev = torch.cuda.device_count()
    with pytest.raises((ValueError, RuntimeError),
                       match="local devices|no CUDA device"):
        make_vertices_mesh(n_dev + 1)
    mesh = make_vertices_mesh(devices=cpus(4))
    assert mesh.shape == {"vertices": 4} and mesh.lead == torch.device("cpu")
    grid = make_grid_mesh(2, 3, devices=cpus(6))
    assert grid.shape == {"lanes": 2, "vertices": 3}
    assert len(grid.axis_devices("vertices")) == 3
    with pytest.raises(ValueError, match=r"lanes.*vertices"):
        make_grid_mesh(3, 3, devices=cpus(8))
    with pytest.raises(ValueError, match=">= 1"):
        make_grid_mesh(0, 2, devices=cpus(2))
    with pytest.raises(ValueError, match="at least one device"):
        make_vertices_mesh(devices=[])
