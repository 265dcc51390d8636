"""The port's long-lived session lifecycle against the JAX package's, with
no tolerance: compaction and shrinking (``compact_state``, ``shrink_state``,
``live_extent``, ``compact()``, ``shrink_to()``, ``maybe_shrink()``,
``auto_shrink``) with the external-id map, and snapshot/restore in the JAX
package's checkpoint format in both directions — the hand-written
MessagePack byte-equal to ``msgpack``'s, ``fill_missing``, retention and
chunked staging — and the grqc lifecycle's pinned digest."""
import collections
import os

import msgpack
import numpy as np
import pytest
import torch

from repro.api import Partitioner as JP
from repro.checkpoint import CheckpointManager as JManager
from repro.checkpoint import ckpt as jckpt
from repro.core import EngineConfig as JCfg
from repro.core import run_stream as jrun
from repro.core import state as jstate
from repro.core.geometry import Geometry as JGeom
from repro.graph import csr as jcsr
from repro.graph import datasets as jds
from repro.graph import stream as jstream
from repro_torch.api import Partitioner as TP
from repro_torch.api import scenarios as sc
from repro_torch.checkpoint import CheckpointManager as TManager
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.checkpoint import manager as tmanager
from repro_torch.checkpoint import msgpack as tmsgpack
from repro_torch.core import state as tstate
from repro_torch.core.config import EngineConfig
from repro_torch.core.geometry import Geometry as TGeom
from repro_torch.core.state import state_from_numpy, state_to_numpy

from test_torch_engine import assert_same, cfg_kw, churn_pair

RING_CFG = dict(k_max=4, k_init=2, max_cap=10**6)


def _ring(lo, hi):
    """ADD events forming a cycle over ids [lo, hi) — max_deg 2."""
    ids = np.arange(lo, hi, dtype=np.int32)
    et = np.zeros(len(ids), np.int32)
    nb = np.stack([ids - 1, ids + 1], 1).astype(np.int32)
    nb[0, 0], nb[-1, 1] = hi - 1, lo
    return et, ids, nb


def _dels(ids):
    ids = np.asarray(ids, np.int32)
    return (np.ones(len(ids), np.int32), ids,
            np.full((len(ids), 2), -1, np.int32))


def _cat(*chunks):
    return tuple(np.concatenate(parts) for parts in zip(*chunks))


def _pair(kw=None, **session):
    kw = kw or RING_CFG
    return (JP(JCfg(**kw), **session),
            TP(EngineConfig(**kw), device="cpu", **session))


def _same_session(jp, tp, counters=True):
    """State, cursor, id maps and metrics equal; with ``counters``, also
    the lifecycle trace and counters (a restored session starts its own)."""
    assert_same(jp.state, tp.state)
    assert tp.cursor == jp.cursor
    jm, tm = jp.metrics(), tp.metrics()
    keys = ["n", "max_deg", "state_bytes", "edge_cut", "load_imbalance"]
    if counters:
        assert [(e["cursor"], e["kind"], tuple(e["from"]), tuple(e["to"]))
                for e in tp.geometry_events] == \
            [(e["cursor"], e["kind"], tuple(e["from"]), tuple(e["to"]))
             for e in jp.geometry_events]
        keys += ["regeometries", "shrinks", "compactions", "rebalances",
                 "rebalance_moves", "rebalance_drift_fires"]
    for k in keys:
        assert jm[k] == tm[k], k
    for a, b in ((jp._ext2int, tp._ext2int), (jp._int2ext, tp._int2ext)):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def _churn_state(seed, policy="sdp"):
    s_j, _ = churn_pair(seed=seed, n=150, m=420)
    st, _ = jrun(s_j, policy=policy, cfg=JCfg(**cfg_kw(policy)), seed=seed)
    return st


def _carry(st):
    return state_from_numpy([np.asarray(x) for x in st], device="cpu")


# ---------------------------------------------------------------------------
# compact_state / shrink_state / live_extent
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3, 5])
def test_live_extent_and_compact_state_match_jax(seed):
    st = _churn_state(seed)
    assert [tuple(g) for g in jstate.live_extent(st)] == \
        [tuple(g) for g in tstate.live_extent(_carry(st))]
    packed, _ = jstate.live_extent(st)
    for geom in (None, (packed.n + 9, packed.max_deg + 3),
                 (packed.n, packed.max_deg, st.edge_load.shape[0])):
        j_in = jstate.PartitionState(*(np.asarray(x).copy() for x in st))
        t_in = _carry(st)._replace(adj=_carry(st).adj.clone())
        jg = None if geom is None else JGeom(*geom)
        tg = None if geom is None else TGeom(*geom)
        j_new, j_perm = jstate.compact_state(
            jstate.PartitionState(*map(np.asarray, j_in)), jg)
        t_new, t_perm = tstate.compact_state(t_in, tg)
        assert_same(j_new, t_new)
        assert j_perm.dtype == t_perm.dtype
        np.testing.assert_array_equal(j_perm, t_perm)
        # the repack consumed the input's O(n) tensors (JAX donates them)
        assert t_in.adj.untyped_storage().nbytes() == 0


@pytest.mark.parametrize("seed", [0, 3])
def test_shrink_state_matches_jax(seed):
    st = _churn_state(seed)
    _, prefix = jstate.live_extent(st)
    for geom in ((prefix.n, prefix.max_deg),
                 (min(prefix.n + 5, st.adj.shape[0]), st.adj.shape[1] + 2)):
        j_new = jstate.shrink_state(
            jstate.PartitionState(*(np.asarray(x) for x in st)), JGeom(*geom))
        t_new = tstate.shrink_state(_carry(st), TGeom(*geom))
        assert_same(j_new, t_new)
    with pytest.raises(ValueError, match="compact_state"):
        tstate.shrink_state(_carry(st), TGeom(prefix.n - 1, prefix.max_deg))
    with pytest.raises(ValueError, match="compact_state"):
        tstate.shrink_state(_carry(st), TGeom(prefix.n, prefix.max_deg - 1))
    k = st.edge_load.shape[0]
    for fn in (lambda s: tstate.shrink_state(s, TGeom(prefix.n, 64, k + 1)),
               lambda s: tstate.compact_state(s, TGeom(prefix.n, 64, k + 1))):
        with pytest.raises(ValueError, match="k_max"):
            fn(_carry(st))
    with pytest.raises(ValueError, match="requested geometry"):
        tstate.compact_state(_carry(st), TGeom(2, 64))
    with pytest.raises(ValueError, match="grow"):
        tstate.shrink_state(_carry(st), TGeom(st.adj.shape[0] + 1, 64))


# ---------------------------------------------------------------------------
# session seams: compact / shrink_to / maybe_shrink / auto_shrink, id map
# ---------------------------------------------------------------------------

def test_compact_relabels_and_feeds_original_ids_like_jax():
    """Grow to a 1024 tier, churn most of it away, compact (relabels), keep
    feeding original ids — re-adds of deleted ids, new ids, survivors'
    edges — in both packages."""
    head = _cat(_ring(0, 600), _dels(np.arange(0, 550)))
    jp, tp = _pair(seed=0)
    jp.feed(head)
    tp.feed(head)
    jp.compact()
    tp.compact()
    _same_session(jp, tp)
    assert tp._ext2int is not None and tp.to_internal([599])[0] != 599
    ids = np.arange(-3, 1100)
    np.testing.assert_array_equal(jp.to_internal(ids), tp.to_internal(ids))
    np.testing.assert_array_equal(jp.to_external(ids), tp.to_external(ids))
    for tail in (_ring(540, 560), _ring(900, 1000), _dels([560, 599, 7]),
                 _ring(0, 30)):
        jp.feed(tail)
        tp.feed(tail)
        _same_session(jp, tp)
    jp.compact()
    tp.compact()           # a second relabel folds into the map
    _same_session(jp, tp)
    live = np.flatnonzero(tp.to_internal(np.arange(1100)) >= 0)
    np.testing.assert_array_equal(tp.to_external(tp.to_internal(live)), live)


def test_shrink_to_maybe_shrink_and_auto_shrink_like_jax():
    jp, tp = _pair(seed=0)
    for p in (jp, tp):
        p.feed(_ring(0, 600))
    assert jp.maybe_shrink() is False and tp.maybe_shrink() is False
    for p in (jp, tp):
        p.feed(_dels(np.arange(0, 590)))
    assert jp.maybe_shrink(hysteresis=2) == tp.maybe_shrink(hysteresis=2)
    _same_session(jp, tp)
    jp.shrink_to(max_deg=2)
    tp.shrink_to(max_deg=2)
    _same_session(jp, tp)
    # auto_shrink fires mid-feed at the same cursors
    ja, ta = _pair(seed=0, auto_shrink=True, shrink_every=64)
    for chunk in (_ring(0, 600), _dels(np.arange(0, 590)), _ring(700, 720),
                  _dels(np.arange(590, 595))):
        ja.feed(chunk)
        ta.feed(chunk)
        _same_session(ja, ta)
    assert ta.metrics()["shrinks"] >= 1 and ta.n < 1024


def test_shrink_and_compact_errors_like_jax():
    cfg = EngineConfig(**RING_CFG)
    part = TP(cfg, seed=0, device="cpu").feed(_ring(0, 100))
    with pytest.raises(ValueError, match="grow_to"):
        part.shrink_to(n=4 * part.n)
    with pytest.raises(ValueError, match="cannot hold"):
        part.shrink_to(n=32)
    part.shrink_to(n=128)
    assert part.n == 128
    hashed = TP(cfg, policy="hash", seed=0, device="cpu").feed(_ring(100, 140))
    with pytest.raises(ValueError, match="hash"):
        hashed.shrink_to(n=64)
    tr = TP(cfg, policy="hash", seed=0, device="cpu").feed(_ring(0, 40))
    tr.shrink_to(n=64)
    assert tr.n == 64
    with pytest.raises(ValueError, match="hysteresis"):
        part.feed(_dels(np.arange(0, 99))).maybe_shrink(hysteresis=1)
    with pytest.raises(ValueError, match="shrink_every"):
        TP(cfg, shrink_every=0, device="cpu")


# ---------------------------------------------------------------------------
# MessagePack
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("obj", [
    None, 0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
    2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1,
    -2**63, "", "é" * 40, "x" * 300, "y" * 70000, list(range(15)),
    list(range(16)), list(range(70000)), {str(i): -i for i in range(15)},
    {str(i): [i, None] for i in range(16)},
    {"keys": [".assignment", ".present"], "step": None,
     "geometry": {"n": 100, "max_deg": 7, "k_max": None}, "extras": []},
    {"keys": [], "step": 2**40, "geometry": None,
     "extras": ["drift_base", "ext2int"]},
])
def test_msgpack_byte_equal(obj):
    packed = msgpack.packb(obj)
    assert tmsgpack.packb(obj) == packed
    assert tmsgpack.unpackb(packed) == msgpack.unpackb(packed)


def test_msgpack_refuses_what_it_does_not_write():
    for obj in (b"bytes", True, 2.5, {"a": [False]}):
        with pytest.raises(TypeError):
            tmsgpack.packb(obj)
    with pytest.raises(ValueError, match="extra bytes"):
        tmsgpack.unpackb(msgpack.packb(1) + b"\x00")
    for obj in (b"raw", 2.5, True):
        with pytest.raises(ValueError, match="subset"):
            tmsgpack.unpackb(msgpack.packb(obj))
    with pytest.raises(ValueError, match="not a string"):
        tmsgpack.unpackb(msgpack.packb({1: 2}))
    with pytest.raises(ValueError, match="truncated"):
        tmsgpack.unpackb(msgpack.packb("abc")[:-1])


# ---------------------------------------------------------------------------
# snapshot / restore across the two packages
# ---------------------------------------------------------------------------

def _drifting_pair(**kw):
    """A compacted, rebalanced session with every extra set: the id map,
    both cadence marks and the drift baseline."""
    session = dict(seed=0, auto_shrink=True, shrink_every=64,
                   auto_rebalance=True, rebalance_every=100, rebalance_m=8,
                   rebalance_passes=1, rebalance_drift=0.01, **kw)
    jp, tp = _pair(**session)
    for chunk in (_ring(0, 600), _dels(np.arange(0, 550))):
        jp.feed(chunk)
        tp.feed(chunk)
    jp.compact()
    tp.compact()
    _same_session(jp, tp)
    return jp, tp, session


def test_snapshot_meta_byte_equal_and_extras(tmp_path):
    jp, tp, _ = _drifting_pair()
    jd, td = str(tmp_path / "j"), str(tmp_path / "t")
    assert jp.snapshot(jd) == tp.snapshot(td) == tp.cursor
    name = f"ckpt_{tp.cursor:08d}.npz"
    with open(os.path.join(jd, name + ".meta"), "rb") as f:
        j_meta = f.read()
    with open(os.path.join(td, name + ".meta"), "rb") as f:
        t_meta = f.read()
    assert t_meta == j_meta
    assert msgpack.packb(tmsgpack.unpackb(t_meta)) == t_meta
    meta = msgpack.unpackb(t_meta)
    assert meta["keys"] == [f".{f}" for f in tstate.PartitionState._fields]
    assert meta["extras"] == ["drift_base", "ext2int", "rebalance_mark",
                              "shrink_mark"]
    j_ex = jckpt.checkpoint_extras(os.path.join(jd, name))
    t_ex = tckpt.checkpoint_extras(os.path.join(td, name))
    assert sorted(j_ex) == sorted(t_ex)
    for k in j_ex:
        assert j_ex[k].dtype == t_ex[k].dtype
        np.testing.assert_array_equal(j_ex[k], t_ex[k])
    with np.load(os.path.join(jd, name)) as a, \
            np.load(os.path.join(td, name)) as b:
        assert sorted(a.files) == sorted(b.files)
        for f in a.files:
            assert a[f].dtype == b[f].dtype and a[f].shape == b[f].shape, f
            np.testing.assert_array_equal(a[f], b[f])
    assert tuple(tckpt.checkpoint_geometry(os.path.join(jd, name))) == \
        tuple(jckpt.checkpoint_geometry(os.path.join(td, name)))
    assert tckpt.checkpoint_step(os.path.join(jd, name)) == tp.cursor
    assert tckpt.checkpoint_keys(os.path.join(jd, name)) == meta["keys"]


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_snapshot_restore_across_packages(tmp_path, direction):
    """One package snapshots, the other restores (marks, baseline and id
    map included); both go on feeding and stay equal to the session that
    never stopped."""
    jp, tp, session = _drifting_pair()
    d = str(tmp_path)
    (jp if direction == "jax_to_torch" else tp).snapshot(d)
    kw = {k: v for k, v in session.items() if k != "seed"}
    if direction == "jax_to_torch":
        tp = TP.restore(d, EngineConfig(**RING_CFG), device="cpu", **kw)
        restored = tp
    else:
        jp = JP.restore(d, JCfg(**RING_CFG), **kw)
        restored = jp
    assert [e["kind"] for e in restored.geometry_events] == ["restore"]
    for chunk in (_ring(540, 580), _dels([577, 560]), _ring(1000, 1300),
                  _dels(np.arange(1000, 1250))):
        jp.feed(chunk)
        tp.feed(chunk)
        _same_session(jp, tp, counters=False)
    assert tp.metrics()["rebalances"] >= 1
    assert tp._last_rebalance == jp._last_rebalance
    assert tp._drift_base == jp._drift_base


def test_restore_resizes_like_jax(tmp_path):
    """Larger n / max_deg / k_max grow the restored state, smaller shrink
    it; a smaller k_max than the checkpoint's raises."""
    part = TP(EngineConfig(**RING_CFG), seed=0, device="cpu").feed(
        _cat(_ring(0, 600), _dels(np.arange(0, 560))))
    part.snapshot(str(tmp_path), blocking=False)
    part.wait()
    for kw in (dict(n=2000, max_deg=5), dict(n=128, max_deg=2),
               dict(n=64)):
        cfg = dict(RING_CFG, k_max=6)
        j = JP.restore(str(tmp_path), JCfg(**cfg), **kw)
        t = TP.restore(str(tmp_path), EngineConfig(**cfg), device="cpu", **kw)
        _same_session(j, t)
    with pytest.raises(ValueError, match="k_max"):
        TP.restore(str(tmp_path), EngineConfig(k_max=2, k_init=2),
                   device="cpu")
    with pytest.raises(ValueError, match="cannot hold"):
        TP.restore(str(tmp_path), EngineConfig(**RING_CFG), n=8,
                   device="cpu")
    with pytest.raises(FileNotFoundError):
        TP.restore(str(tmp_path / "none"), EngineConfig(**RING_CFG),
                   device="cpu")


def test_restore_pre_cut_matrix_checkpoint(tmp_path):
    """A state checkpoint without the trailing cut_matrix leaf (the older
    layout), written by either package, restores through fill_missing and
    is healed by the recount; the resumed session equals JAX's."""
    s_j, s_t = churn_pair(seed=2)
    kw = cfg_kw("sdp")
    mid = s_j.num_events // 2
    ref = JP.from_stream(s_j, JCfg(**kw), window=32).feed(
        (s_j.etype[:mid], s_j.vertex[:mid], s_j.nbrs[:mid]))
    legacy_t = collections.namedtuple("Legacy",
                                      tstate.PartitionState._fields[:-1])
    legacy_j = collections.namedtuple("Legacy",
                                      jstate.PartitionState._fields[:-1])
    JManager(str(tmp_path / "j"), interval=1).maybe_save(
        mid, legacy_j(*tuple(ref.state)[:-1]), blocking=True)
    TManager(str(tmp_path / "t"), interval=1).maybe_save(
        mid, legacy_t(*tuple(_carry(ref.state))[:-1]), blocking=True)
    like = tstate.init_state(s_t.n, s_t.max_deg, kw["k_max"], 1, 0, "cpu")
    with pytest.raises(ValueError, match="fill_missing"):
        TManager(str(tmp_path / "t")).restore(like)
    ref.feed((s_j.etype[mid:], s_j.vertex[mid:], s_j.nbrs[mid:]))
    for d in ("j", "t"):
        sess = TP.restore(str(tmp_path / d), EngineConfig(**kw), window=32,
                          device="cpu")
        assert sess.cursor == mid and sess.geometry == (s_t.n, s_t.max_deg,
                                                        kw["k_max"])
        sess.feed((s_t.etype[mid:], s_t.vertex[mid:], s_t.nbrs[mid:]))
        assert_same(ref.state, sess.state)


def test_retention_keep_and_keep_last(tmp_path):
    st = _carry(_churn_state(1))
    m = TManager(str(tmp_path / "a"), interval=2, keep=2)
    for step in range(1, 8):
        m.maybe_save(step, st, blocking=True)
    assert m.latest() == 6 and m._steps() == [4, 6]
    m2 = TManager(str(tmp_path / "b"), interval=1, keep=5, keep_last=1)
    for step in (3, 9, 5):
        m2.save_now(step, st)
    m2.wait()
    assert m2._steps() == [9]
    assert sorted(os.listdir(tmp_path / "b")) == ["ckpt_00000009.npz",
                                                  "ckpt_00000009.npz.meta"]
    with pytest.raises(ValueError, match="keep_last"):
        TManager(str(tmp_path / "c"), keep_last=0)
    # the session's retention, and JAX reading the port's directory
    part = TP(EngineConfig(**RING_CFG), seed=0, device="cpu")
    for i in range(4):
        part.feed(_ring(10 * i, 10 * i + 10))
        part.snapshot(str(tmp_path / "s"), keep=2, blocking=bool(i % 2))
    part.wait()
    assert JManager(str(tmp_path / "s"), interval=1)._steps() == [30, 40]
    # journal and stragglers
    for t in [1.0] * 8:
        m.record_step(0, t)
    assert m.is_straggler(3.5) and not m.is_straggler(2.5)


def test_host_chunk_bytes_staging(tmp_path, monkeypatch):
    st = _carry(_churn_state(4))
    copies = []
    real = tmanager.to_numpy

    def counted(leaf):
        copies.append(tuple(leaf.shape) if hasattr(leaf, "shape") else ())
        return real(leaf)

    monkeypatch.setattr(tmanager, "to_numpy", counted)
    row = st.adj.shape[1] * 4
    host = tmanager._stage_host(st, 3 * row)
    n = st.adj.shape[0]
    assert copies.count((3, st.adj.shape[1])) == n // 3
    for f in st._fields:
        a, b = getattr(host, f), getattr(st, f).numpy()
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="host_chunk_bytes"):
        TManager(str(tmp_path), host_chunk_bytes=0)
    m = TManager(str(tmp_path), interval=1, host_chunk_bytes=64)
    m.save_now(3, st, blocking=True)
    back, step = m.restore(tstate.init_state(n, st.adj.shape[1],
                                             st.edge_load.shape[0], 1, 0,
                                             "cpu"))
    assert step == 3
    assert_same(state_to_numpy(st), back)
    tree = {"b": [torch.arange(5), np.ones(3)], "a": st.key}
    tckpt.save_pytree(str(tmp_path / "tree.npz"), tree, step=1)
    jckpt.save_pytree(str(tmp_path / "jtree.npz"),
                      {"b": [np.arange(5), np.ones(3)],
                       "a": np.asarray(st.key)}, step=1)
    for name in ("tree.npz", "jtree.npz"):
        out = tckpt.restore_pytree(str(tmp_path / name), tree)
        assert tckpt.checkpoint_keys(str(tmp_path / name)) == \
            ["a", "b/0", "b/1"]
        np.testing.assert_array_equal(out["b"][0].numpy(), np.arange(5))
        assert out["a"].dtype == torch.uint32


# ---------------------------------------------------------------------------
# the lifecycle scenario
# ---------------------------------------------------------------------------

def _jax_cfg(name):
    return JCfg(**sc.LIFECYCLE_CFG[name])


def test_lifecycle_matches_jax_at_small_scale(tmp_path):
    """The whole lifecycle (churn, bulk deletes with auto_shrink, compact,
    non-blocking snapshot, restore, the same tail to both) on grqc at a
    tenth of its size: both sessions equal the JAX package's, leaf for
    leaf."""
    g, s = sc.lifecycle_stream("grqc", 0.1)
    jp, jr, surv = sc.run_lifecycle(JP, g, s, _jax_cfg("grqc"),
                                    str(tmp_path / "j"))
    tp, tr, surv_t = sc.run_lifecycle(
        TP, g, s, EngineConfig(**sc.LIFECYCLE_CFG["grqc"]),
        str(tmp_path / "t"), device="cpu", use_kernel=True)
    np.testing.assert_array_equal(surv, surv_t)
    assert_same(jp.state, tp.state)
    assert_same(jr.state, tr.state)
    assert_same(jp.state, tr.state)
    assert tp.metrics()["compactions"] == 1


def test_grqc_lifecycle_digest_is_jax(tmp_path):
    """The JAX package's grqc lifecycle (scale 1.0) recomputed here equals
    the digest that chip_smoke.py holds the port's card run to."""
    g_t, s_t = sc.lifecycle_stream("grqc")
    g_j = jcsr.cap_degree(jds.load_dataset("grqc"), sc.DEG_CAP)
    s_j = jstream.interleaved_churn(g_j, **sc.CHURN_ARGS)
    np.testing.assert_array_equal(s_j.nbrs, s_t.nbrs)
    jp, jr, _ = sc.run_lifecycle(JP, g_t, s_t, _jax_cfg("grqc"),
                                 str(tmp_path))
    assert sc.state_digest(jr.state) == sc.state_digest(jp.state) == \
        sc.GRQC_LIFECYCLE_DIGEST
