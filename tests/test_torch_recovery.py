"""The port's crash-safe sessions (``repro_torch.runtime.recovery``)
against the JAX package's, with no tolerance: journal ordering, pruning
and file names; injected mid-stream crashes and genuinely SIGKILLed
processes recovering to the state the uninterrupted run reaches;
rebalance markers replayed once; journals and snapshots written by one
package recovered by the other; ``Partitioner.place`` / ``remesh``; and
the serving tier over a ``RecoverableSession``, snapshots taken on its
ingest thread restoring to their cursors' states."""
import os
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest
import torch

from repro.api import Partitioner as JP
from repro.core import EngineConfig as JCfg
from repro.core import run_stream as jrun
from repro.graph import generators as jgen
from repro.graph import stream as jstream
from repro.runtime.recovery import CrashError as JCrash
from repro.runtime.recovery import EventJournal as JJournal
from repro.runtime.recovery import RecoverableSession as JRS
from repro_torch.api import Partitioner as TP
from repro_torch.api import PartitionService
from repro_torch.api import scenarios as sc
from repro_torch.checkpoint import manager as tmanager
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.config import EngineConfig
from repro_torch.graph import generators as tgen
from repro_torch.graph import stream as tstream
from repro_torch.runtime import (
    CrashError, EventJournal, JournalEntry, RecoverableSession,
)

from test_torch_engine import assert_same
from test_torch_engine import release_jax_executables  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(k_max=8, k_init=1, max_cap=100)
REBALANCE_CFG = dict(k_max=8, k_init=4, autoscale=False)
WAIT = 60
STREAM = """
g = make_graph("social", 90, 260, seed=2)
s = gstream.interleaved_churn(g, warmup_frac=0.2, del_every=3,
                              edge_del_every=5, seed=4)
"""


def _streams():
    """tests/test_recovery.py's churn fixture from both packages'
    generators (the same events)."""
    kw = dict(warmup_frac=0.2, del_every=3, edge_del_every=5, seed=4)
    return (jstream.interleaved_churn(jgen.make_graph("social", 90, 260,
                                                      seed=2), **kw),
            tstream.interleaved_churn(tgen.make_graph("social", 90, 260,
                                                      seed=2), **kw))


def _jax_ref(s_j, cfg=CFG):
    ref, _ = jrun(s_j, policy="sdp", cfg=JCfg(**cfg), seed=0)
    return ref


def _tp(s, cfg=CFG, **kw):
    kw.setdefault("window", 32)
    return TP.from_stream(s, EngineConfig(**cfg), seed=0, device="cpu", **kw)


def _span(s, a, b):
    return (s.etype[a:b], s.vertex[a:b], s.nbrs[a:b])


def _feed_from(sess, s, step=20, stop=None):
    t, T = sess.cursor, s.num_events if stop is None else stop
    while t < T:
        e = min(t + step, T)
        sess.feed(_span(s, t, e))
        t = e


def _same_modulo_relabel(ref, sess, n):
    """The recovered session equals ``ref`` (a JAX state of the run that
    never crashed) up to the documented compaction relabel: every present
    vertex's label through the id map, the counters and the loads."""
    ai = sess.to_internal(np.arange(n))
    got = np.full(n, -1, np.int64)
    got[ai >= 0] = np.asarray(sess.state.assignment)[ai[ai >= 0]]
    pres = np.asarray(ref.present)
    np.testing.assert_array_equal(np.asarray(ref.assignment)[pres],
                                  got[:len(pres)][pres])
    for f in ("num_partitions", "total_edges", "cut_edges",
              "denied_scaleout", "scale_events"):
        assert int(getattr(ref, f)) == int(getattr(sess.state, f)), f
    np.testing.assert_array_equal(np.asarray(ref.edge_load),
                                  np.asarray(sess.state.edge_load))


def _run_child(code, d):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    return subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code).format(d=d)],
        capture_output=True, text=True, env=env, timeout=600)


# ---------------------------------------------------------------------------
# the journal
# ---------------------------------------------------------------------------

def test_journal_order_reload_and_prune(tmp_path):
    j = EventJournal(str(tmp_path))
    j.append(0, [0, 0], [1, 2], [[2, -1], [1, -1]])
    j.append_marker(2, "compact")        # same cursor as the next chunk...
    j.append(2, [0], [3], [[1, 2]])      # ...but appended later
    es = j.entries()
    assert all(isinstance(e, JournalEntry) for e in es)
    assert [(e.cursor, e.kind) for e in es] == \
        [(0, "events"), (2, "compact"), (2, "events")]
    et, vx, nb = j.load(es[2])
    np.testing.assert_array_equal(vx, [3])
    assert et.dtype == vx.dtype == nb.dtype == np.int32
    # a fresh handle (the recovering process) sees the same order and
    # continues the sequence numbers instead of colliding
    j2 = EventJournal(str(tmp_path))
    assert [(e.cursor, e.kind) for e in j2.entries()] == \
        [(0, "events"), (2, "compact"), (2, "events")]
    j2.append_marker(3, "shrink")
    j2.append_marker(3, "rebalance", {"m": 4, "passes": None, "slack": 0.5})
    assert [e.kind for e in j2.entries()[-2:]] == ["shrink", "rebalance"]
    assert j2.load_marker(j2.entries()[-1]) == \
        {"m": 4, "passes": None, "slack": 0.5}
    assert j2.load_marker(j2.entries()[-2]) == {}
    # prune below cursor 2: the fully-consumed chunk goes, the rest stays
    assert j2.prune_below(2) == 1
    assert [(e.cursor, e.kind) for e in j2.entries()] == \
        [(2, "compact"), (2, "events"), (3, "shrink"), (3, "rebalance")]


def test_journal_ignores_torn_writes(tmp_path):
    j = EventJournal(str(tmp_path))
    j.append(0, [0], [1], [[2, -1]])
    # a crash mid-write leaves only a temp file — never a torn entry
    with open(os.path.join(str(tmp_path), "tmpabc123.tmp"), "wb") as f:
        f.write(b"half a npz")
    assert len(j.entries()) == 1


def test_journal_format_is_jax(tmp_path):
    """Either package's journal reads in the other: the same file names,
    the same npz payloads, the same JSON markers, the same order."""
    for writer, reader in ((EventJournal, JJournal), (JJournal, EventJournal)):
        d = str(tmp_path / writer.__module__.split(".")[0])
        w = writer(d)
        w.append(0, [0, 1], [4, 5], [[5, -1], [-1, -1]])
        w.append_marker(2, "rebalance", {"m": 3, "passes": 1, "slack": None})
        w.append_marker(2, "snap")
        w.append(2, [2], [4], [[5, 6]])
        r = reader(d)
        assert [(e.cursor, e.seq, e.kind, os.path.basename(e.path))
                for e in r.entries()] == \
            [(e.cursor, e.seq, e.kind, os.path.basename(e.path))
             for e in w.entries()]
        names = [os.path.basename(e.path) for e in r.entries()]
        assert names == ["ev_000000000000_00000000.npz",
                         "cp_000000000002_00000001_rebalance.marker",
                         "cp_000000000002_00000002_snap.marker",
                         "ev_000000000002_00000003.npz"]
        for a, b in zip(r.load(r.entries()[0]), w.load(w.entries()[0])):
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)
        assert r.load_marker(r.entries()[1]) == \
            {"m": 3, "passes": 1, "slack": None}


def test_journal_names_equal_jax_for_the_same_session(tmp_path):
    """The same feeds, compaction, rebalance and snapshots through both
    packages' RecoverableSession write the same journal and checkpoint
    file names, and the same journal payloads."""
    s_j, s_t = _streams()
    dj, dt = str(tmp_path / "j"), str(tmp_path / "t")
    jsess = JRS(JP.from_stream(s_j, JCfg(**CFG), seed=0, window=32), dj,
                snapshot_every=45, keep=2)
    tsess = RecoverableSession(_tp(s_t), dt, snapshot_every=45, keep=2)
    for sess, s in ((jsess, s_j), (tsess, s_t)):
        _feed_from(sess, s, step=17, stop=51)
        sess.compact()
        sess.rebalance(m=4, passes=1)
        _feed_from(sess, s, step=17, stop=None)
        sess.maybe_shrink()
        sess.checkpoint(blocking=True)
        sess.wait()
    for sub in ("journal", ""):
        names = [sorted(f for f in os.listdir(os.path.join(d, sub))
                        if not f.endswith(".jsonl")
                        and os.path.isfile(os.path.join(d, sub, f)))
                 for d in (dj, dt)]
        assert names[0] == names[1] and names[0], sub
    for ej, et in zip(jsess.journal.entries(), tsess.journal.entries()):
        if ej.kind == "events":
            for a, b in zip(jsess.journal.load(ej), tsess.journal.load(et)):
                np.testing.assert_array_equal(a, b)
    assert_same(jsess.state, tsess.state)


# ---------------------------------------------------------------------------
# injected crash -> recover -> bit-identical
# ---------------------------------------------------------------------------

def _crash(sess, s, at_compact=40):
    """Feed in chunks of 20, compacting once at ``at_compact``, until the
    injected crash fires."""
    t, T = 0, s.num_events
    with pytest.raises((CrashError, JCrash)):
        while t < T:
            e = min(t + 20, T)
            sess.feed(_span(s, t, e))
            if t == at_compact:
                sess.compact()
            t = e
    sess.wait()


def test_crash_recover_finish_bit_identical(tmp_path):
    """Crash at the worst-ordered point (chunk journaled, not fed), with a
    relabelling compaction earlier in the stream; recover + finish == the
    JAX run that never crashed."""
    s_j, s_t = _streams()
    sess = RecoverableSession(_tp(s_t), str(tmp_path), snapshot_every=40,
                              inject_crash_after=85)
    _crash(sess, s_t)
    sess2 = RecoverableSession.recover(str(tmp_path), EngineConfig(**CFG),
                                       window=32, seed=0, device="cpu")
    assert sess2.cursor > 85, "replay must cover the journaled-unfed chunk"
    _feed_from(sess2, s_t)
    sess2.sync()
    _same_modulo_relabel(_jax_ref(s_j), sess2, s_t.n)
    assert sess2.metrics()["cursor"] == s_t.num_events
    assert sess2.metrics()["last_snapshot_cursor"] > 85


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_crash_in_one_package_recovers_in_the_other(tmp_path, direction):
    """A crashed session's directory (snapshots with the id map, journal
    with a compaction marker) written by one package recovers in the other
    to the state the writer's own recovery reaches, and both finish the
    stream equal."""
    s_j, s_t = _streams()
    d = str(tmp_path)
    if direction == "jax_to_torch":
        w = JRS(JP.from_stream(s_j, JCfg(**CFG), seed=0, window=32), d,
                snapshot_every=40, inject_crash_after=85)
        _crash(w, s_j)
    else:
        w = RecoverableSession(_tp(s_t), d, snapshot_every=40,
                               inject_crash_after=85)
        _crash(w, s_t)
    # the writer's own recovery writes nothing before the recover returns
    jr = JRS.recover(d, JCfg(**CFG), window=32, seed=0)
    tr = RecoverableSession.recover(d, EngineConfig(**CFG), window=32,
                                    seed=0, device="cpu")
    assert tr.cursor == jr.cursor > 85
    assert_same(jr.state, tr.state)
    np.testing.assert_array_equal(jr.to_internal(np.arange(s_t.n)),
                                  tr.to_internal(np.arange(s_t.n)))
    _feed_from(jr.part, s_j)
    _feed_from(tr.part, s_t)
    assert_same(jr.state, tr.state)
    _same_modulo_relabel(_jax_ref(s_j), tr, s_t.n)


def test_recover_without_any_feed_tail(tmp_path):
    """Crash exactly on a snapshot boundary: the journal tail is empty and
    recovery is just the restore."""
    s_j, s_t = _streams()
    sess = RecoverableSession(_tp(s_t), str(tmp_path), snapshot_every=10**9)
    sess.feed(s_t)
    sess.checkpoint(blocking=True)
    sess.journal.prune_below(sess.cursor)
    sess2 = RecoverableSession.recover(str(tmp_path), EngineConfig(**CFG),
                                       window=32, seed=0, device="cpu")
    assert sess2.cursor == s_t.num_events
    assert_same(_jax_ref(s_j), sess2.state)


# ---------------------------------------------------------------------------
# a real dead process: SIGKILL mid-stream, recover in this one
# ---------------------------------------------------------------------------

CHILD_CODE = """
import os, signal
from repro_torch.api import Partitioner
from repro_torch.core.config import EngineConfig
from repro_torch.graph.generators import make_graph
from repro_torch.graph import stream as gstream
from repro_torch.runtime import RecoverableSession
""" + STREAM + """
cfg = EngineConfig(k_max=8, k_init=1, max_cap=100)
part = Partitioner.from_stream(s, cfg, seed=0, window=32, device="cpu")
sess = RecoverableSession(part, {d!r}, snapshot_every=30)
t = 0
while t < 80:
    e = min(t + 20, 80)
    sess.feed((s.etype[t:e], s.vertex[t:e], s.nbrs[t:e]))
    t = e
sess.wait()                       # snapshots on disk, journal written
print("CHILD_FED", sess.cursor, flush=True)
os.kill(os.getpid(), signal.SIGKILL)     # no atexit, no cleanup
"""


def test_sigkilled_process_recovers_bit_identical(tmp_path):
    s_j, s_t = _streams()
    out = _run_child(CHILD_CODE, str(tmp_path))
    assert out.returncode == -9, (out.returncode, out.stderr[-2000:])
    assert "CHILD_FED 80" in out.stdout
    sess = RecoverableSession.recover(str(tmp_path), EngineConfig(**CFG),
                                      window=32, seed=0, device="cpu")
    assert sess.cursor == 80          # snapshot(60) + journal tail replayed
    _feed_from(sess, s_t)
    sess.sync()
    assert_same(_jax_ref(s_j), sess.state)


# ---------------------------------------------------------------------------
# rebalance markers
# ---------------------------------------------------------------------------

def test_recovery_replays_rebalance_marker(tmp_path):
    s_j, s_t = _streams()
    half = s_t.num_events // 2
    sess = RecoverableSession(_tp(s_t, REBALANCE_CFG), str(tmp_path),
                              snapshot_every=10**9)
    sess.checkpoint()     # genesis snapshot; everything after replays
    sess.feed(_span(s_t, 0, half))
    sess.rebalance(m=8, passes=1)
    sess.feed(_span(s_t, half, None))
    got = RecoverableSession.recover(str(tmp_path),
                                     EngineConfig(**REBALANCE_CFG),
                                     device="cpu")
    ref = JP.from_stream(s_j, JCfg(**REBALANCE_CFG), seed=0)
    ref.feed(_span(s_j, 0, half))
    ref.rebalance(m=8, passes=1)
    ref.feed(_span(s_j, half, None))
    assert_same(ref.state, sess.state)
    assert_same(ref.state, got.state)


def test_checkpoint_after_rebalance_not_double_applied(tmp_path):
    s_j, s_t = _streams()
    half = s_t.num_events // 2
    sess = RecoverableSession(_tp(s_t, REBALANCE_CFG), str(tmp_path),
                              snapshot_every=10**9)
    sess.feed(_span(s_t, 0, half))
    sess.rebalance(m=8, passes=1)
    sess.checkpoint()     # the snapshot already holds the rebalanced state
    sess.feed(_span(s_t, half, None))
    got = RecoverableSession.recover(str(tmp_path),
                                     EngineConfig(**REBALANCE_CFG),
                                     device="cpu")
    ref = JP.from_stream(s_j, JCfg(**REBALANCE_CFG), seed=0)
    ref.feed(_span(s_j, 0, half))
    ref.rebalance(m=8, passes=1)
    ref.feed(_span(s_j, half, None))
    assert_same(ref.state, sess.state)
    assert_same(ref.state, got.state)


REBALANCE_CHILD = """
import os, signal
from repro_torch.api import Partitioner
from repro_torch.core.config import EngineConfig
from repro_torch.graph.generators import make_graph
from repro_torch.graph import stream as gstream
from repro_torch.runtime import RecoverableSession
""" + STREAM + """
cfg = EngineConfig(k_max=8, k_init=4, autoscale=False)
part = Partitioner.from_stream(s, cfg, policy="sdp", seed=0, device="cpu")
sess = RecoverableSession(part, {d!r}, snapshot_every=10 ** 9)
sess.checkpoint()
half = s.num_events // 2
sess.feed((s.etype[:half], s.vertex[:half], s.nbrs[:half]))
sess.rebalance(m=8, passes=1)
sess.wait()               # journal + marker durable, next window never fed
print("CHILD_REBALANCED", sess.cursor, flush=True)
os.kill(os.getpid(), signal.SIGKILL)
"""


def test_sigkill_between_rebalance_and_next_window(tmp_path):
    s_j, s_t = _streams()
    half = s_t.num_events // 2
    ref = JP.from_stream(s_j, JCfg(**REBALANCE_CFG), seed=0)
    ref.feed(_span(s_j, 0, half))
    ref.rebalance(m=8, passes=1)
    ref.feed(_span(s_j, half, None))
    out = _run_child(REBALANCE_CHILD, str(tmp_path))
    assert out.returncode == -9, (out.returncode, out.stderr[-2000:])
    assert f"CHILD_REBALANCED {half}" in out.stdout
    sess = RecoverableSession.recover(str(tmp_path),
                                      EngineConfig(**REBALANCE_CFG),
                                      policy="sdp", device="cpu")
    assert sess.cursor == half
    sess.feed(_span(s_t, half, None))
    assert_same(ref.state, sess.state)


# ---------------------------------------------------------------------------
# placement and re-mesh
# ---------------------------------------------------------------------------

def test_remesh_continues_bit_identical(tmp_path):
    s_j, s_t = _streams()
    mid = s_t.num_events // 2
    sess = RecoverableSession(_tp(s_t), str(tmp_path))
    sess.feed(_span(s_t, 0, mid))
    knobs = sess.part._knobs
    assert sess.remesh("cpu") is sess    # "device lost": move to a survivor
    assert sess.device.type == "cpu" and sess.part._knobs is not knobs
    sess.feed(_span(s_t, mid, None))
    assert_same(_jax_ref(s_j), sess.state)
    with pytest.raises(ValueError, match="target"):
        sess.remesh()


def test_place_moves_everything_and_continues_like_jax():
    """place() on a CPU session mid-stream (traces collected) goes on
    bit-identically, state and traces, to the JAX session's place()."""
    s_j, s_t = _streams()
    mid = s_t.num_events // 3
    tp = _tp(s_t, collect_trace=True)
    jp = JP.from_stream(s_j, JCfg(**CFG), seed=0, window=32,
                        collect_trace=True)
    tp.feed(_span(s_t, 0, mid))
    jp.feed(_span(s_j, 0, mid))
    import jax
    assert jp.place(jax.devices()[0]) is jp
    assert tp.place("cpu") is tp and tp.device.type == "cpu"
    tp.feed(_span(s_t, mid, None))
    jp.feed(_span(s_j, mid, None))
    assert_same(jp.state, tp.state)
    assert_same(jp.trace(), tp.trace())


# named when remesh(devices=) raised; the name is kept, what it checks is
# that the sharded remesh goes on equal to JAX's run
def test_remesh_devices_is_a_later_slice(tmp_path):
    """``devices=`` is the vertex-sharded form (ported since): a dense
    session still needs its target device, and ignores ``devices`` beside
    it, as the JAX session does; a sharded one re-meshes over ``devices``
    (or ``[device]``) and goes on equal to JAX's uninterrupted run."""
    s_j, s_t = _streams()
    sess = RecoverableSession(_tp(s_t), str(tmp_path / "dense"))
    jsess = JRS(JP.from_stream(s_j, JCfg(**CFG), seed=0, window=32),
                str(tmp_path / "jax"))
    for s in (sess, jsess):
        with pytest.raises(ValueError, match="needs the target device"):
            s.remesh(devices=["cpu"])
    sess.remesh("cpu", devices=["cpu", "cpu"])
    assert sess.part.device == torch.device("cpu")
    half = s_t.num_events // 2
    sharded = RecoverableSession(
        _tp(s_t, sharded=True, shard_devices=["cpu"] * 3),
        str(tmp_path / "sharded"))
    sharded.feed(_span(s_t, 0, half))
    sharded.remesh(devices=["cpu"] * 2)
    assert sharded.part.metrics()["shard_devices"] == 2
    sharded.remesh("cpu")
    assert sharded.part.metrics()["shard_devices"] == 1
    sharded.feed(_span(s_t, half, None))
    want, _ = jrun(s_j, cfg=JCfg(**CFG), seed=0)
    from repro_torch.core.sharded_state import unshard_state
    assert_same(want, unshard_state(sharded.part.state, n=s_t.n))


# ---------------------------------------------------------------------------
# retention: keep_last prunes snapshots AND the journal follows
# ---------------------------------------------------------------------------

def test_keep_last_prunes_and_latest_restores(tmp_path):
    m = CheckpointManager(str(tmp_path), interval=1, keep_last=2)
    for step in (3, 7, 11, 19):
        m.save_now(step, {"w": torch.full((4,), step)}, blocking=True)
    assert m._steps() == [11, 19]
    assert not os.path.exists(os.path.join(str(tmp_path),
                                           "ckpt_00000003.npz"))
    restored, step = m.restore({"w": torch.zeros(4, dtype=torch.int64)})
    assert step == 19
    np.testing.assert_array_equal(restored["w"].numpy(), np.full(4, 19))
    with pytest.raises(ValueError, match="keep_last"):
        CheckpointManager(str(tmp_path), keep_last=0)


def test_session_snapshots_bound_disk(tmp_path):
    """A long-lived session's periodic snapshots stay bounded: keep=2
    retains two checkpoints and the journal is pruned to what the oldest
    retained one needs; the retained tail still recovers."""
    s_j, s_t = _streams()
    sess = RecoverableSession(_tp(s_t), str(tmp_path), snapshot_every=20,
                              keep=2)
    _feed_from(sess, s_t, step=10)
    sess.checkpoint(blocking=True)
    steps = CheckpointManager(str(tmp_path), interval=1)._steps()
    assert len(steps) <= 2
    for e in sess.journal.entries():
        if e.kind == "events":
            T = int(sess.journal.load(e)[0].shape[0])
            assert e.cursor + T > steps[0]      # nothing stale survived
    sess2 = RecoverableSession.recover(str(tmp_path), EngineConfig(**CFG),
                                       window=32, seed=0, device="cpu")
    assert sess2.cursor == s_t.num_events
    assert_same(_jax_ref(s_j), sess2.state)
    assert sess.metrics()["snapshots"] >= 2


def test_validation(tmp_path):
    _, s_t = _streams()
    with pytest.raises(ValueError, match="snapshot_every"):
        RecoverableSession(_tp(s_t), str(tmp_path), snapshot_every=0)
    assert "RecoverableSession(" in repr(
        RecoverableSession(_tp(s_t), str(tmp_path)))


# ---------------------------------------------------------------------------
# the crash-safe serving tier
# ---------------------------------------------------------------------------

def test_service_snapshots_on_ingest_thread_restore_exactly(tmp_path):
    """A PartitionService over a RecoverableSession that snapshots every
    few events on the service's ingest thread — with a drain_compact in
    the middle, so the id map rides in the snapshots and grows in place
    afterwards — while ingest goes on: every snapshot restores to the
    state, cursor and id map a synchronous session has at its cursor."""
    _, s_t = _streams()
    d = str(tmp_path)
    sess = RecoverableSession(_tp(s_t), d, snapshot_every=9, keep=10**6)
    chunks = [_span(s_t, a, a + 7) for a in range(0, s_t.num_events, 7)]
    half = len(chunks) // 2
    compact_at = min(half * 7, s_t.num_events)
    with PartitionService(sess, max_pending_chunks=4,
                          max_batch_events=7) as svc:
        for c in chunks[:half]:
            svc.submit(c, timeout=WAIT)
        svc.drain_compact(timeout=WAIT)
        for c in chunks[half:]:
            svc.submit(c, timeout=WAIT)
        svc.flush(timeout=WAIT)
    sess.wait()
    steps = CheckpointManager(d, interval=1)._steps()
    assert len(steps) >= 6 and steps[-1] > compact_at
    sync, prev = _tp(s_t), 0
    for step in steps:
        if prev < compact_at <= step:
            sync.feed(_span(s_t, prev, compact_at))
            sync.compact()
            prev = compact_at
        sync.feed(_span(s_t, prev, step))
        prev = step
        got = TP.restore(d, EngineConfig(**CFG), step=step, window=32,
                         device="cpu")
        assert got.cursor == step
        for f in sync.state._fields:
            np.testing.assert_array_equal(getattr(got.state, f).numpy(),
                                          getattr(sync.state, f).numpy(),
                                          err_msg=f"{f} at {step}")
        want = sync._ext2int
        assert (got._ext2int is None) == (want is None), step
        if want is not None:
            np.testing.assert_array_equal(got._ext2int, want)


def test_background_snapshot_holds_the_state_it_was_taken_at(
        tmp_path, monkeypatch):
    """snapshot(blocking=False) copies the state and the id map before it
    returns: in-place updates made while the writer is still busy (what
    the next feed on the ingest thread does) do not reach the file."""
    ids = np.arange(256, dtype=np.int32)
    ring = (np.zeros(256, np.int32), ids,
            np.stack([(ids - 1) % 256, (ids + 1) % 256], 1))
    dels = (np.ones(240, np.int32), ids[:240],
            np.full((240, 2), -1, np.int32))
    cfg = EngineConfig(k_max=4, k_init=2, max_cap=10**6)
    part = TP(cfg, window=32, device="cpu").feed(ring).feed(dels).compact()
    assert part._ext2int is not None          # ids 240.. moved to slots 0..
    gate = threading.Event()
    real = tmanager.save_pytree

    def held(*a, **kw):
        gate.wait(WAIT)
        return real(*a, **kw)

    monkeypatch.setattr(tmanager, "save_pytree", held)
    want = [t.clone() for t in part.state]
    want_map = part._ext2int.copy()
    part.snapshot(str(tmp_path), blocking=False)
    for t in part.state:
        if t.dtype != torch.uint32:
            t.fill_(7)
    part._ext2int[:] = -5
    gate.set()
    part.wait()
    got = TP.restore(str(tmp_path), cfg, window=32, device="cpu")
    for f, w in zip(got.state._fields, want):
        assert torch.equal(getattr(got.state, f), w), f
    np.testing.assert_array_equal(got._ext2int, want_map)


def test_serve_crash_recover_serve_equals_whole_stream(tmp_path):
    """The crash-safe tier: a service over a RecoverableSession serves the
    first half and dies with the process's state (closed, never
    checkpointed by hand); a service over the recovered session serves the
    second half; the end state is the JAX whole-stream state."""
    s_j, s_t = _streams()
    d = str(tmp_path)
    T = s_t.num_events
    half = T // 2
    with PartitionService(RecoverableSession(_tp(s_t), d,
                                             snapshot_every=25)) as svc:
        for a in range(0, half, 6):
            svc.submit(_span(s_t, a, min(a + 6, half)), timeout=WAIT)
        svc.flush(timeout=WAIT)
    svc.partitioner.wait()
    rec = RecoverableSession.recover(d, EngineConfig(**CFG), window=32,
                                     seed=0, device="cpu",
                                     snapshot_every=25)
    assert rec.cursor == half
    with PartitionService(rec) as svc2:
        for a in range(half, T, 6):
            svc2.submit(_span(s_t, a, min(a + 6, T)), timeout=WAIT)
        svc2.flush(timeout=WAIT)
        labels = svc2.where_many(np.arange(s_t.n))
    ref = _jax_ref(s_j)
    assert_same(ref, rec.state)
    np.testing.assert_array_equal(labels, np.asarray(ref.assignment))
    assert svc2.metrics()["snapshots"] >= 1


# ---------------------------------------------------------------------------
# the digest the card's killed-process check is held to
# ---------------------------------------------------------------------------

def test_grqc_session_digest_is_jax():
    """The JAX package's grqc churn session (scale 1.0, degree cap 192,
    window 256) recomputed here equals the digest that chip_smoke.py holds
    the card's SIGKILL-recovered session to; the port's CPU session fed in
    a few chunks reaches the same state."""
    g, s = sc.lifecycle_stream("grqc")
    jp = JP.from_stream(s, JCfg(**sc.LIFECYCLE_CFG["grqc"]), policy="sdp",
                        seed=0, window=256)
    jp.feed((s.etype, s.vertex, s.nbrs))
    assert sc.state_digest(jp.state) == sc.GRQC_SESSION_DIGEST
    tp = TP.from_stream(s, EngineConfig(**sc.LIFECYCLE_CFG["grqc"]),
                        policy="sdp", seed=0, window=256, use_kernel=True,
                        device="cpu")
    for a, b in ((0, 3001), (3001, 3002), (3002, None)):
        tp.feed(_span(s, a, b))
    assert sc.state_digest(tp.state) == sc.GRQC_SESSION_DIGEST
