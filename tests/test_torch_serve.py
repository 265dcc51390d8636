"""The port's serving tier (``repro_torch.api.serve.PartitionService``)
against the JAX package's, with no tolerance: after any sequence of async
submits the state is the JAX package's whole-stream state — under
coalescing, both engines, backpressure (block and drop, with JAX's drop
counts), mid-stream auto-grow, queries racing ingest (each answer the
state at a dispatched batch boundary), idle compaction and idle
rebalancing — and ``metrics()`` carries JAX's keys. Every threaded wait
has its own timeout, so a hang fails a test instead of stalling the
suite."""
import sys
import threading
import time

import numpy as np
import pytest

from repro.api import Partitioner as JP
from repro.api import PartitionService as JService
from repro.core import EngineConfig as JCfg
from repro.core import run_stream as jrun
from repro.graph import generators as jgen
from repro.graph import stream as jstream
from repro_torch.api import Partitioner as TP
from repro_torch.api import PartitionService, PreparedChunk, RouteResult
from repro_torch.core.config import EngineConfig
from repro_torch.graph import generators as tgen
from repro_torch.graph import stream as tstream

from test_torch_engine import assert_same
from test_torch_engine import release_jax_executables  # noqa: F401

CFG = dict(k_max=8, k_init=1, max_cap=100)
WAIT = 60          # seconds: the bound of every flush / join in this file


def _streams():
    """tests/test_api_serve.py's delete-heavy churn fixture from both
    packages' generators (the same events)."""
    kw = dict(warmup_frac=0.2, del_every=3, edge_del_every=5, seed=4)
    s_j = jstream.interleaved_churn(jgen.make_graph("social", 90, 260,
                                                    seed=2), **kw)
    s_t = tstream.interleaved_churn(tgen.make_graph("social", 90, 260,
                                                    seed=2), **kw)
    return s_j, s_t


def _chunks(s, size):
    return [(s.etype[t:t + size], s.vertex[t:t + size], s.nbrs[t:t + size])
            for t in range(0, s.num_events, size)]


def _session(s, **kw):
    kw.setdefault("window", 32)
    return TP.from_stream(s, EngineConfig(**CFG), seed=0, device="cpu", **kw)


def _jsession(s, **kw):
    kw.setdefault("window", 32)
    return JP.from_stream(s, JCfg(**CFG), seed=0, **kw)


def _jax_ref(s_j):
    ref, _ = jrun(s_j, policy="sdp", cfg=JCfg(**CFG), seed=0)
    return ref


class Recording(TP):
    """A port session that records the cursor after each dispatched batch
    (the batch boundaries a query may observe) and the batches fed."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.boundaries = [0]
        self.batches = []

    def feed_prepared(self, chunk):
        super().feed_prepared(chunk)
        self.batches.append(chunk)
        self.boundaries.append(self.cursor)
        return self


def _labels_at(s, cursors, **kw):
    """A synchronous port session's labels at each cursor."""
    part = _session(s, **kw)
    out, prev = {}, 0
    for c in sorted(set(cursors)):
        part.feed((s.etype[prev:c], s.vertex[prev:c], s.nbrs[prev:c]))
        prev = c
        out[c] = part.state.assignment.numpy().copy()
    return out


# -- bit-identity under serving ---------------------------------------------

@pytest.mark.parametrize("engine", ["auto", "windowed"])
@pytest.mark.parametrize("size", [13, 17])
def test_service_state_equals_jax_run_stream(size, engine):
    """N async submits (coalesced however the ingest thread pleases) land
    exactly on the JAX package's whole-stream state."""
    s_j, s_t = _streams()
    with PartitionService(_session(s_t, engine=engine),
                          max_pending_chunks=4) as svc:
        for chunk in _chunks(s_t, size):
            svc.submit(chunk)
        svc.flush(timeout=WAIT)
        assert_same(_jax_ref(s_j), svc.partitioner.state)
        assert svc.partitioner.cursor == s_t.num_events


def test_where_consistency_after_async_feeds():
    """Mid-stream: flush() then where_many == a synchronous JAX session fed
    the same prefix (read-your-submits after the barrier)."""
    s_j, s_t = _streams()
    chunks_j, chunks_t = _chunks(s_j, 13), _chunks(s_t, 13)
    k = len(chunks_t) // 2
    sync = _jsession(s_j)
    for c in chunks_j[:k]:
        sync.feed(c)
    labels = np.asarray(sync.state.assignment)
    with PartitionService(_session(s_t)) as svc:
        for c in chunks_t[:k]:
            svc.submit(c)
        svc.flush(timeout=WAIT)
        got = svc.where_many(np.arange(s_t.n))
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, labels)
        present = np.asarray(sync.state.present)
        assert svc.where(int(np.flatnonzero(present)[0])) >= 0
        # out-of-range ids answer -1, not raise
        assert svc.where(-3) == -1 and svc.where(s_t.n + 99) == -1
        for c in chunks_t[k:]:
            svc.submit(c)
        svc.flush(timeout=WAIT)
        assert_same(_jax_ref(s_j), svc.partitioner.state)


def test_service_survives_midstream_auto_grow():
    """A session born tiny (n=10, max_deg=2) auto-grows under the service's
    coalesced feeds and lands on the JAX session grown synchronously."""
    s_j, s_t = _streams()
    sync = JP(JCfg(**CFG), n=10, max_deg=2, seed=0, window=32).feed(s_j)
    assert sync.regeometries >= 1
    part = TP(EngineConfig(**CFG), n=10, max_deg=2, seed=0, window=32,
              device="cpu")
    with PartitionService(part, max_pending_chunks=4) as svc:
        for chunk in _chunks(s_t, 29):
            svc.submit(chunk)
        svc.flush(timeout=WAIT)
        assert part.regeometries >= 1
        assert (part.n, part.max_deg) == (sync.n, sync.max_deg)
        assert_same(sync.state, part.state)


# -- backpressure -----------------------------------------------------------

def test_drop_policy_sheds_like_jax():
    """queue-full + policy='drop': submit returns False, the chunk is
    counted dropped — the same counts as the JAX package's service — and
    the final state is exactly the admitted prefix."""
    s_j, s_t = _streams()
    counts = []
    for service, sess, s in ((JService, _jsession, s_j),
                             (PartitionService, _session, s_t)):
        chunks = _chunks(s, 11)
        svc = service(sess(s), max_pending_chunks=2, policy="drop",
                      autostart=False)
        admitted = [svc.submit(c) for c in chunks[:4]]
        m = svc.metrics()
        counts.append((admitted, m["chunks_dropped"], m["chunks_submitted"],
                       m["queue_depth"], m["max_queue_depth"]))
        svc.start()
        svc.flush(timeout=WAIT)
        svc.close()
        if service is PartitionService:
            port = svc.partitioner.state
        else:
            jstate = svc.partitioner.state
    assert counts[0] == counts[1]
    assert counts[1][:3] == ([True, True, False, False], 2, 4)
    assert_same(jstate, port)
    sync = _jsession(s_j)
    for c in _chunks(s_j, 11)[:2]:
        sync.feed(c)
    assert_same(sync.state, port)


def test_block_policy_times_out_then_drains():
    """queue-full + policy='block': submit waits; with a timeout it raises
    TimeoutError and the chunk is NOT admitted; once started the queue
    drains and further submits go through."""
    s_j, s_t = _streams()
    chunks = _chunks(s_t, 11)
    svc = PartitionService(_session(s_t), max_pending_chunks=2,
                           policy="block", autostart=False)
    svc.submit(chunks[0])
    svc.submit(chunks[1])
    t0 = time.perf_counter()
    with pytest.raises(TimeoutError, match="queue slot"):
        svc.submit(chunks[2], timeout=0.05)
    assert time.perf_counter() - t0 >= 0.05
    assert svc.metrics()["submit_blocked_s"] > 0
    assert svc.metrics()["chunks_submitted"] == 2
    svc.start()
    for c in chunks[2:]:
        svc.submit(c, timeout=WAIT)
    svc.flush(timeout=WAIT)
    svc.close()
    assert_same(_jax_ref(s_j), svc.partitioner.state)


def test_block_policy_unblocks_when_ingest_drains():
    """A submit blocked on a full queue completes (no timeout) as soon as
    the started ingest thread frees a slot."""
    _, s_t = _streams()
    chunks = _chunks(s_t, 11)
    svc = PartitionService(_session(s_t), max_pending_chunks=1,
                           policy="block", autostart=False)
    svc.submit(chunks[0])
    starter = threading.Timer(0.05, svc.start)
    starter.start()
    t0 = time.perf_counter()
    assert svc.submit(chunks[1]) is True       # blocks until start() drains
    assert time.perf_counter() - t0 >= 0.04
    starter.join(timeout=WAIT)
    svc.flush(timeout=WAIT)
    svc.close()
    assert svc.metrics()["chunks_ingested"] == 2


# -- queries ----------------------------------------------------------------

def test_route_semantics_and_input_forms():
    s_j, s_t = _streams()
    labels_j = np.asarray(_jax_ref(s_j).assignment)
    with PartitionService(_session(s_t)) as svc:
        for c in _chunks(s_t, 40):
            svc.submit(c)
        svc.flush(timeout=WAIT)
        labels = svc.where_many(np.arange(s_t.n, dtype=np.int32))
        np.testing.assert_array_equal(labels, labels_j)
        edges = np.random.default_rng(0).integers(
            0, s_t.n, size=(32, 2)).astype(np.int32)
        r = svc.route(edges)
        assert isinstance(r, RouteResult)
        np.testing.assert_array_equal(r.src_part, labels_j[edges[:, 0]])
        np.testing.assert_array_equal(r.dst_part, labels_j[edges[:, 1]])
        np.testing.assert_array_equal(
            r.cut, (r.src_part != r.dst_part) & (r.src_part >= 0)
            & (r.dst_part >= 0))
        one = svc.route((int(edges[0, 0]), int(edges[0, 1])))
        assert one.src_part.shape == (1,)
        assert one.src_part[0] == r.src_part[0]
        pair = svc.route((edges[:, 0], edges[:, 1]))
        np.testing.assert_array_equal(pair.cut, r.cut)
        with pytest.raises(ValueError, match="route"):
            svc.route(np.zeros((3, 4), np.int32))


def test_queries_racing_ingest_see_batch_boundaries():
    """A reader thread queries while the service ingests: every answer is
    the state at one of the dispatched batch boundaries between the
    cursors read before and after the query."""
    _, s_t = _streams()
    part = Recording.from_stream(s_t, EngineConfig(**CFG), seed=0,
                                 window=16, device="cpu")
    rng = np.random.default_rng(5)
    answers, stop = [], threading.Event()
    svc = PartitionService(part, max_pending_chunks=64)

    def reader():
        while not stop.is_set():
            ids = rng.integers(-2, s_t.n + 2, 48).astype(np.int32)
            lo = part.cursor
            got = svc.where_many(ids)
            answers.append((lo, ids, got, part.cursor))

    th = threading.Thread(target=reader, daemon=True)
    th.start()
    for c in _chunks(s_t, 3):
        svc.submit(c)
        time.sleep(0.0005)
    svc.flush(timeout=WAIT)
    stop.set()
    th.join(timeout=WAIT)
    assert not th.is_alive()
    svc.close()
    assert len(answers) > 0 and part.boundaries[-1] == s_t.num_events
    states = _labels_at(s_t, part.boundaries, window=16)
    for lo, ids, got, hi in answers:
        ok = [c for c in part.boundaries if lo <= c <= hi]
        want = [np.where((ids >= 0) & (ids < s_t.n),
                         states[c][np.clip(ids, 0, s_t.n - 1)], -1)
                for c in ok]
        assert any(np.array_equal(got, w) for w in want), (lo, hi)


def test_metrics_counters_keys_and_lifecycle():
    s_j, s_t = _streams()
    chunks = _chunks(s_t, 13)
    svc = PartitionService(_session(s_t), max_pending_chunks=8)
    for c in chunks:
        svc.submit(c)
    svc.flush(timeout=WAIT)
    m = svc.metrics()
    assert m["chunks_ingested"] == len(chunks)
    assert m["events_ingested"] == s_t.num_events
    assert 1 <= m["batches_dispatched"] <= len(chunks)
    assert m["queue_depth"] == 0 and m["chunks_dropped"] == 0
    assert 0.0 <= m["device_busy_fraction"] <= 1.0
    assert m["feed_p50_ms"] <= m["feed_p99_ms"] + 1e-9
    assert m["events_per_s"] > 0
    assert m["cursor"] == m["events_ingested"] == s_t.num_events
    assert "edge_cut" in m and "regeometries" in m
    assert svc.latencies().shape == (len(chunks),)
    # the keys the service adds are JAX's (the sessions' own differ: the
    # port counts window kinds, JAX reports its shard layout)
    with JService(_jsession(s_j)) as jsvc:
        jsvc.submit(_chunks(s_j, 13)[0])
        jsvc.flush()
        jm = jsvc.metrics()
        assert set(jm) - set(jsvc.partitioner.metrics()) == \
            set(m) - set(svc.partitioner.metrics())
    svc.close()
    svc.close()                                  # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit(chunks[0])
    assert svc.where(0) in (-1, *range(CFG["k_max"]))   # queries outlive it
    assert "closed=True" in repr(svc)


def test_constructor_validation_and_flush_guard():
    _, s_t = _streams()
    part = _session(s_t)
    for kw, what in ((dict(policy="nope"), "policy"),
                     (dict(max_pending_chunks=0), "max_pending_chunks"),
                     (dict(max_batch_events=0), "max_batch_events"),
                     (dict(idle_compact_s=0), "idle_compact_s"),
                     (dict(idle_rebalance_s=-1.0), "idle_rebalance_s")):
        with pytest.raises(ValueError, match=what):
            PartitionService(part, **kw)
    svc = PartitionService(part, autostart=False)
    with pytest.raises(RuntimeError, match="never-started"):
        svc.flush()
    svc.start()
    svc.close()


def test_ingest_error_surfaces_not_hangs():
    """A poison chunk kills the ingest loop; flush() raises the error
    (wrapped), it does not wait forever."""
    _, s_t = _streams()
    svc = PartitionService(_session(s_t), max_pending_chunks=4)
    svc.submit(42)                               # prepare() will TypeError
    with pytest.raises(RuntimeError, match="ingest loop died") as info:
        svc.flush(timeout=WAIT)
    assert isinstance(info.value.__cause__, TypeError)
    svc.close()


def test_max_batch_events_caps_coalescing():
    s_j, s_t = _streams()
    chunks = _chunks(s_t, 10)
    svc = PartitionService(_session(s_t),
                           max_pending_chunks=len(chunks) + 1,
                           max_batch_events=10, autostart=False)
    for c in chunks:
        svc.submit(c)
    svc.start()
    svc.flush(timeout=WAIT)
    m = svc.metrics()
    svc.close()
    assert m["batches_dispatched"] == len(chunks)   # no merge allowed
    assert_same(_jax_ref(s_j), svc.partitioner.state)


class SlowPrepare(Recording):
    """Coercion slower than the submitter, so the queue refills while the
    ingest thread drains it."""

    def prepare(self, events):
        time.sleep(0.002)
        return super().prepare(events)


def test_coalescing_is_bounded_by_the_queue():
    """A blocked submitter refilling the queue during the drain does not
    grow a dispatch past one queue's worth of chunks (max_pending_chunks
    + 1), and the state is still the JAX package's whole-stream state."""
    s_j, s_t = _streams()
    part = SlowPrepare.from_stream(s_t, EngineConfig(**CFG), seed=0,
                                   window=32, device="cpu")
    with PartitionService(part, max_pending_chunks=4) as svc:
        for c in _chunks(s_t, 1):
            svc.submit(c, timeout=WAIT)
        svc.flush(timeout=WAIT)
    sizes = [b.num_events for b in part.batches]
    assert sum(sizes) == s_t.num_events and max(sizes) <= 5
    assert len(sizes) >= s_t.num_events // 5
    assert_same(_jax_ref(s_j), part.state)


# -- idle actions -----------------------------------------------------------

def _ring_then_deletes():
    """256 ADDs forming a ring, then DELs of all but 16 of its vertices —
    a session that qualifies for a shrink once ingested."""
    ids = np.arange(256, dtype=np.int32)
    nb = np.stack([(ids - 1) % 256, (ids + 1) % 256], 1).astype(np.int32)
    dels = ids[16:]
    et = np.concatenate([np.zeros(256, np.int32), np.ones(240, np.int32)])
    vx = np.concatenate([ids, dels])
    nbrs = np.concatenate([nb, np.full((240, 2), -1, np.int32)])
    return [(et[a:a + 31], vx[a:a + 31], nbrs[a:a + 31])
            for a in range(0, len(et), 31)]


def _wait_for(pred, what):
    t0 = time.perf_counter()
    while not pred():
        assert time.perf_counter() - t0 < WAIT, f"timed out waiting: {what}"
        time.sleep(0.01)


def _staged(part, chunks, **kw):
    """A service with every chunk queued before it starts, so one batch
    ingests them all and the idle actions fire at the stream's end."""
    svc = PartitionService(part, max_pending_chunks=len(chunks) + 1,
                           autostart=False, **kw)
    for c in chunks:
        svc.submit(c)
    return svc.start()


def test_idle_compaction_equals_sync_shrink_and_jax():
    """An ingest lull runs one maybe_shrink under the dispatch lock: the
    state equals a synchronous port session and a JAX session that shrink
    at the same cursor, and queries keep answering in original ids."""
    chunks = _ring_then_deletes()
    kw = dict(k_max=4, k_init=2, max_cap=10**6)
    part = TP(EngineConfig(**kw), window=32, device="cpu")
    svc = _staged(part, chunks, idle_compact_s=0.05)
    _wait_for(lambda: svc.metrics()["idle_shrinks"] >= 1, "idle shrink")
    labels = svc.where_many(np.arange(256))
    svc.close()
    sync = TP(EngineConfig(**kw), window=32, device="cpu")
    jsync = JP(JCfg(**kw), window=32)
    for c in chunks:
        sync.feed(c)
        jsync.feed(c)
    assert sync.maybe_shrink() and jsync.maybe_shrink()
    assert part.geometry == sync.geometry
    assert part.n < 256
    for f in part.state._fields:
        np.testing.assert_array_equal(getattr(part.state, f).numpy(),
                                      getattr(sync.state, f).numpy(), f)
    assert_same(jsync.state, part.state)
    internal = jsync.to_internal(np.arange(256))
    want = np.where(internal >= 0, np.asarray(jsync.state.assignment)[
        np.clip(internal, 0, None)], -1)
    np.testing.assert_array_equal(labels, want)
    assert svc.metrics()["idle_shrinks"] == 1


def test_idle_rebalance_equals_sync_rebalance_and_jax():
    """An ingest lull runs one rebalance() with the session's knobs — once
    per ingest progress — equal to the sync port and JAX sessions that
    rebalance at the same cursor."""
    s_j, s_t = _streams()
    knobs = dict(rebalance_m=8, rebalance_passes=1)
    part = _session(s_t, **knobs)
    svc = _staged(part, _chunks(s_t, 19), idle_rebalance_s=0.05)
    _wait_for(lambda: svc.metrics()["idle_rebalances"] >= 1,
              "idle rebalance")
    time.sleep(0.2)                    # more silence, no new events
    m = svc.metrics()
    svc.close()
    assert m["idle_rebalances"] == 1 and m["rebalances"] == 1
    sync = _session(s_t, **knobs).feed(s_t)
    ev = sync.rebalance()
    jsync = _jsession(s_j, **knobs).feed(s_j)
    jev = jsync.rebalance()
    assert part.rebalance_events == [ev] and ev == jev
    assert_same(jsync.state, part.state)


@pytest.mark.parametrize("action", ["drain_compact", "drain_rebalance"])
def test_drain_actions_equal_sync_session(action):
    """drain_compact / drain_rebalance: flush, then the action under the
    dispatch lock — the state a synchronous JAX session reaches."""
    s_j, s_t = _streams()
    knobs = dict(rebalance_m=8, rebalance_passes=1)
    svc = PartitionService(_session(s_t, **knobs))
    for c in _chunks(s_t, 23):
        svc.submit(c)
    out = getattr(svc, action)(timeout=WAIT)
    m = svc.metrics()
    svc.close()
    jsync = _jsession(s_j, **knobs).feed(s_j)
    if action == "drain_compact":
        assert out is svc and m["drain_compacts"] == 1
        jsync.compact()
    else:
        assert out == jsync.rebalance()
    assert_same(jsync.state, svc.partitioner.state)


# -- concurrency stress -----------------------------------------------------

def test_stress_many_submitters_and_readers():
    """More submitting and querying threads than cores, with a shortened
    switch interval: the state equals a synchronous replay of exactly the
    batches the service dispatched, no admitted event is lost, and every
    query answers."""
    _, s_t = _streams()
    part = Recording.from_stream(s_t, EngineConfig(**CFG), seed=0,
                                 window=16, device="cpu")
    chunks = _chunks(s_t, 2)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        svc = PartitionService(part, max_pending_chunks=3)
        stop = threading.Event()
        answered = []

        def submitter(mine):
            for c in mine:
                svc.submit(c, timeout=WAIT)

        def reader():
            while not stop.is_set():
                answered.append(svc.where_many(np.arange(8)).shape)

        subs = [threading.Thread(target=submitter, args=(chunks[i::6],))
                for i in range(6)]
        readers = [threading.Thread(target=reader) for _ in range(4)]
        for th in subs + readers:
            th.start()
        for th in subs:
            th.join(timeout=WAIT)
        svc.flush(timeout=WAIT)
        stop.set()
        for th in readers:
            th.join(timeout=WAIT)
        assert not any(th.is_alive() for th in subs + readers)
        svc.close()
    finally:
        sys.setswitchinterval(old)
    assert part.cursor == s_t.num_events
    assert svc.metrics()["chunks_ingested"] == len(chunks)
    assert answered and set(answered) == {(8,)}
    replay = _session(s_t, window=16)
    for b in part.batches:
        replay.feed_prepared(b)
    for f in part.state._fields:
        np.testing.assert_array_equal(getattr(part.state, f).numpy(),
                                      getattr(replay.state, f).numpy(), f)


# -- host-side seams the service is built from ------------------------------

def test_prepare_feed_prepared_equals_jax_feed():
    s_j, s_t = _streams()
    part = _session(s_t)
    for c in _chunks(s_t, 23):
        p = part.prepare(c)
        assert isinstance(p, PreparedChunk)
        assert p.etype.dtype == np.int32 and p.nbrs.ndim == 2
        assert p.num_events == len(c[0])
        part.feed_prepared(p)
    assert part.sync() is part
    assert_same(_jax_ref(s_j), part.state)
    with pytest.raises(TypeError, match="VertexStream"):
        part.prepare(object())
    with pytest.raises(ValueError, match="shapes disagree"):
        part.prepare((s_t.etype[:4], s_t.vertex[:3], s_t.nbrs[:4]))


def test_poisson_arrivals_generator_like_jax():
    s_j, s_t = _streams()
    bounds, due = tstream.poisson_arrivals(s_t, rate=500.0, mean_batch=8.0,
                                           seed=3)
    jb, jd = jstream.poisson_arrivals(s_j, rate=500.0, mean_batch=8.0,
                                      seed=3)
    np.testing.assert_array_equal(bounds, jb)
    np.testing.assert_array_equal(due, jd)
    sizes = np.diff(bounds)
    assert bounds[0] == 0 and bounds[-1] == s_t.num_events
    assert (sizes >= 1).all() and due.shape == (len(sizes),)
    assert (np.diff(due) >= 0).all() and (due > 0).all()
    assert s_t.num_events / due[-1] == pytest.approx(500.0, rel=0.5)
    with pytest.raises(ValueError, match="rate"):
        tstream.poisson_arrivals(s_t, rate=0.0)
    with pytest.raises(ValueError, match="mean_batch"):
        tstream.poisson_arrivals(s_t, rate=1.0, mean_batch=-1.0)


def test_service_needs_no_card_for_a_cpu_session():
    """A CPU session's service has no stream and no completion events: the
    branch is the session's own device."""
    _, s_t = _streams()
    svc = PartitionService(_session(s_t), autostart=False)
    assert svc._stream is None and svc._token() is None
    svc.start()
    svc.close()
