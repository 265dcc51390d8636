"""Streaming partition *service* (the port's ``repro.api.serve``): a
double-buffered, backpressured ingest loop plus a request/response query
API over a :class:`Partitioner` — or over a
``repro_torch.runtime.RecoverableSession``, which makes the tier
crash-safe.

    part = Partitioner.from_stream(stream, cfg, use_kernel=True)   # the card
    with PartitionService(part, max_pending_chunks=64) as svc:
        for chunk in arriving_chunks:
            svc.submit(chunk)              # cheap enqueue, backpressured
        svc.flush()                        # barrier: queue drained + done
        print(svc.where(17), svc.metrics())

Design
------
* **One stream per session.** A CUDA session's work is ordered on ONE
  stream: the current stream of the session's device when the service is
  built. The ingest thread's dispatches, the query gathers and the idle
  actions all run under ``torch.cuda.stream(that)``, so every kernel
  wrapper launches there; a query can neither race the in-place window
  updates nor read memory the caching allocator handed to another stream.
* **Double-buffered ingest.** A dedicated ingest thread pops arrival
  chunks from a bounded queue, runs the host-side coercion
  (``Partitioner.prepare``) for chunk *t+1* while the card still executes
  batch *t*, and only then waits for batch *t*'s completion token before
  dispatching — at most one batch in flight, one being coerced.
* **Completion tokens are CUDA events**, recorded on the session's stream
  under the dispatch lock right after ``feed_prepared``. The completion
  thread and the ingest thread wait on them (``Event.synchronize``), never
  on the whole device. A CPU session's ``feed_prepared`` returns after its
  work is done, so it needs no token.
* **Continuous batching.** Everything queued when the ingest thread comes
  around is coalesced into ONE ``feed_prepared`` call (bounded by
  ``max_batch_events``, and by one queue's worth of chunks, where the JAX
  package's drain goes on as long as a blocked submitter refills the
  queue). ``feed`` is bit-identical under any chopping, so coalescing
  never changes the result — it turns per-arrival partial windows into
  full ones.
* **Backpressure.** The ingest queue holds at most
  ``max_pending_chunks``; ``policy="block"`` makes ``submit`` wait for a
  slot (optionally bounded by ``timeout``, raising ``TimeoutError``),
  ``policy="drop"`` sheds the chunk and returns ``False``.
* **Queries wait only for their own gather.** ``where``/``where_many``/
  ``route`` build a small gather of the carried state on the session's
  stream under the dispatch lock (a consistent snapshot: every
  *dispatched* batch, in order, nothing partial), copy it without blocking
  into pinned host memory, record an event, release the lock and wait on
  that event alone — not on feeds dispatched after it. Call ``flush()``
  first for read-your-submits semantics.
* **Reclaim and repair in idle windows** (``idle_compact_s``,
  ``idle_rebalance_s``) under the dispatch lock, and the explicit
  ``drain_compact()`` / ``drain_rebalance()``. Queries keep speaking
  original vertex ids across any relabelling.
* **Bit-identity.** The service-fed final state is bit-identical to a
  synchronous whole-stream ``feed`` of the same events in submission
  order (tests/test_torch_serve.py, against the JAX package).

A session whose ``rebalance_drift`` or ``auto_shrink`` knob is set reads
the device inside ``feed_prepared`` (the drift signals, the present
count): those reads wait for the batch and so break the double buffering.
They are semantics, and stay.
"""
from __future__ import annotations

import contextlib
import functools
import queue
import threading
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.api.partitioner import Partitioner, PreparedChunk
from repro_torch.core.geometry import Geometry
from repro_torch.graph.stream import normalize_rows
from repro_torch.launch.mesh import RowBlocks

_POLICIES = ("block", "drop")
_STOP = object()


class RouteResult(NamedTuple):
    """Partition routing for a batch of edges (see ``route``).

    ``src_part``/``dst_part`` are the current labels of each edge's
    endpoints (-1 = unassigned/absent); ``cut`` marks edges whose endpoints
    live in different partitions — the traffic a downstream sharded
    consumer must send cross-shard."""

    src_part: np.ndarray   # (E,) int32
    dst_part: np.ndarray   # (E,) int32
    cut: np.ndarray        # (E,) bool


def _merge_prepared(chunks: list[PreparedChunk]) -> PreparedChunk:
    """Coalesce prepared chunks into one (continuous batching). Feeding the
    merged chunk is bit-identical to feeding them back to back — ``feed``
    is chop-invariant — so this only changes throughput."""
    if len(chunks) == 1:
        return chunks[0]
    width = max(c.nbrs.shape[1] for c in chunks)
    return PreparedChunk(
        np.concatenate([c.etype for c in chunks]),
        np.concatenate([c.vertex for c in chunks]),
        np.concatenate([normalize_rows(c.nbrs, width) for c in chunks]),
        functools.reduce(Geometry.union, (c.required for c in chunks)),
    )


def _wait(token) -> None:
    """Block until a completion token's batch has executed (``None``: a
    CPU batch, done when dispatched)."""
    if token is not None:
        token.synchronize()


class PartitionService:
    """Asynchronous serving loop over a :class:`Partitioner` session (see
    module docstring).

    Args:
      part: the session to serve. The service owns its feed path — do not
        call ``feed`` on it concurrently (queries and ``metrics`` on the
        service are safe from any thread).
      max_pending_chunks: bound of the ingest queue; submits beyond it hit
        the backpressure ``policy``.
      policy: ``"block"`` (submit waits for a queue slot) or ``"drop"``
        (submit sheds the chunk, returns ``False``).
      max_batch_events: cap on how many events one coalesced dispatch may
        contain (None = bounded only by the queue: one dispatch takes at
        most ``max_pending_chunks + 1`` chunks).
      idle_compact_s: seconds of ingest silence after which the loop runs
        one hysteresis-gated ``maybe_shrink`` — reclaim happens in idle
        windows, never while traffic arrives. ``None`` (default) disables
        it; ``drain_compact()`` is the explicit, unconditional counterpart.
      idle_rebalance_s: seconds of ingest silence after which the loop runs
        one ``rebalance()`` (the session's configured knobs) under the
        dispatch lock. At most one per ingest progress: an idle session is
        not re-rebalanced until new events arrive. ``None`` (default)
        disables it; ``drain_rebalance()`` is the explicit counterpart.
        Composes with ``idle_compact_s`` (rebalance first — it changes the
        loads the shrink check sees).
      autostart: start the ingest thread immediately. Tests pass ``False``
        to stage deterministic queue states, then ``start()``.

    ``part`` may also be a ``repro_torch.runtime.RecoverableSession`` —
    anything speaking the ``prepare``/``feed_prepared``/``sync``/
    ``metrics``/``state``/``cursor``/``device``/``to_internal`` protocol
    serves identically.
    """

    def __init__(self, part: Partitioner, *, max_pending_chunks: int = 8,
                 policy: str = "block", max_batch_events: int | None = None,
                 idle_compact_s: float | None = None,
                 idle_rebalance_s: float | None = None,
                 autostart: bool = True):
        if policy not in _POLICIES:
            raise ValueError(
                f"policy={policy!r} is unknown: expected one of {_POLICIES}"
                " ('block' waits for a queue slot, 'drop' sheds the chunk)")
        if max_pending_chunks <= 0:
            raise ValueError(
                f"max_pending_chunks={max_pending_chunks} must be > 0: it "
                "bounds the ingest queue the backpressure policy acts on")
        if max_batch_events is not None and max_batch_events <= 0:
            raise ValueError(
                f"max_batch_events={max_batch_events} must be > 0 (or None "
                "to coalesce everything queued)")
        if idle_compact_s is not None and idle_compact_s <= 0:
            raise ValueError(
                f"idle_compact_s={idle_compact_s} must be > 0 (or None to "
                "disable idle-window compaction)")
        if idle_rebalance_s is not None and idle_rebalance_s <= 0:
            raise ValueError(
                f"idle_rebalance_s={idle_rebalance_s} must be > 0 (or None "
                "to disable idle-window rebalancing)")
        self._part = part
        # the session's stream: every dispatch, gather and idle action of
        # the service is ordered on it (None: a CPU session)
        dev = part.device
        self._stream = (torch.cuda.current_stream(dev)
                        if dev.type == "cuda" else None)
        self.policy = policy
        self.max_pending_chunks = int(max_pending_chunks)
        self.max_batch_events = max_batch_events
        self.idle_compact_s = idle_compact_s
        self.idle_rebalance_s = idle_rebalance_s
        # the queue-get timeout is the earliest idle action; the loop then
        # fires each action once its own threshold is crossed
        idles = [s for s in (idle_compact_s, idle_rebalance_s)
                 if s is not None]
        self._idle_s = min(idles) if idles else None
        self._idle_shrinks = 0
        self._idle_rebalances = 0
        self._last_idle_rebalance_cursor = -1
        self._drain_compacts = 0
        self._queue: queue.Queue = queue.Queue(maxsize=max_pending_chunks)
        # serializes ingest-thread dispatch against query-side gathers and
        # idle actions (held while work is enqueued; never across a wait
        # for the card, except where the session itself reads it)
        self._lock = threading.Lock()
        self._cond = threading.Condition()
        self._accepted = 0           # chunks admitted past backpressure
        self._completed = 0          # chunks whose batch finished
        self._dropped = 0
        self._events_ingested_done = 0   # events in completed batches
        self._batches = 0
        self._max_depth = 0
        self._coercion_s = 0.0
        self._device_wait_s = 0.0
        self._device_busy_s = 0.0
        self._submit_blocked_s = 0.0
        self._latencies: list[float] = []
        self._t_start: float | None = None
        self._t_last_done: float | None = None
        self._error: BaseException | None = None
        self._closed = False
        self._started = False
        self._ingest = threading.Thread(
            target=self._ingest_loop, name="partition-ingest", daemon=True)
        self._completer = threading.Thread(
            target=self._completion_loop, name="partition-complete",
            daemon=True)
        # unbounded: holds (token, dispatch_time, [(arrival, n_events)])
        # per in-flight batch for the completion thread
        self._inflight: queue.Queue = queue.Queue()
        if autostart:
            self.start()

    def _on_stream(self):
        """Context that makes the session's stream current (a no-op for a
        CPU session)."""
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def _token(self):
        """The completion token of the batch just dispatched (call under
        the dispatch lock): an event recorded on the session's stream, or
        ``None`` for a CPU session, whose ``feed_prepared`` returned after
        its work."""
        if self._stream is None:
            return None
        event = torch.cuda.Event()
        event.record(self._stream)
        return event

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "PartitionService":
        """Start the ingest + completion threads (no-op if running)."""
        if not self._started:
            self._started = True
            self._ingest.start()
            self._completer.start()
        return self

    def __enter__(self) -> "PartitionService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        """Stop accepting, drain the queue, wait for the card, and join the
        threads. Idempotent; queries remain valid after."""
        if self._closed:
            return
        self._closed = True
        if self._started:
            while True:
                try:
                    self._queue.put(_STOP, timeout=0.5)
                    break
                except queue.Full:
                    # a dead ingest loop never drains the queue — don't hang
                    # close() on it, the error surfaces below
                    if self._error is not None:
                        break
            self._ingest.join()
            self._inflight.put(_STOP)
            self._completer.join()
        self._part.sync()
        self._raise_pending()

    def _raise_pending(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(
                "the service ingest loop died — the session state is NOT "
                "guaranteed past the last completed batch") from err

    # -- ingest -------------------------------------------------------------

    def submit(self, events, *, arrival: float | None = None,
               timeout: float | None = None) -> bool:
        """Enqueue a chunk of events (``VertexStream`` or ``(etype, vertex,
        nbrs)`` triple — anything ``feed`` takes). Cheap: no coercion
        happens on the caller's thread.

        Returns ``True`` if admitted. Under ``policy="drop"`` a full queue
        sheds the chunk (returns ``False``, counted in
        ``metrics()["chunks_dropped"]``); under ``policy="block"`` the call
        waits for a slot, raising ``TimeoutError`` if ``timeout`` (seconds)
        elapses first. ``arrival`` optionally stamps the chunk's arrival
        time (``time.perf_counter`` clock) for the latency percentiles —
        default: now."""
        if self._closed:
            raise RuntimeError("service is closed — no further submits")
        self._raise_pending()
        item = (events, time.perf_counter() if arrival is None else arrival)
        if self._t_start is None:
            self._t_start = item[1]
        if self.policy == "drop":
            try:
                self._queue.put_nowait(item)
            except queue.Full:
                with self._cond:
                    self._dropped += 1
                return False
        else:
            t0 = time.perf_counter()
            try:
                # poll in short slices so a dead ingest loop (queue never
                # drains) surfaces as its error, not an eternal block
                while True:
                    waited = time.perf_counter() - t0
                    if timeout is not None and waited >= timeout:
                        raise TimeoutError(
                            f"submit timed out after {timeout}s waiting for "
                            f"a queue slot ({self.max_pending_chunks} "
                            "pending chunks; drain with flush(), raise "
                            "max_pending_chunks, or use policy='drop')") \
                            from None
                    slice_ = 0.25 if timeout is None \
                        else min(0.25, timeout - waited)
                    try:
                        self._queue.put(item, timeout=slice_)
                        break
                    except queue.Full:
                        self._raise_pending()
            finally:
                self._submit_blocked_s += time.perf_counter() - t0
        with self._cond:
            self._accepted += 1
            self._max_depth = max(self._max_depth, self._queue.qsize())
        return True

    def flush(self, timeout: float | None = None) -> "PartitionService":
        """Barrier: block until every admitted chunk has been ingested AND
        executed (its completion token is done). After ``flush()`` queries
        reflect every prior ``submit``."""
        self._raise_pending()
        if not self._started:
            raise RuntimeError(
                "flush() on a never-started service would never return — "
                "call start() first (autostart=False is for staging tests)")
        with self._cond:
            ok = self._cond.wait_for(
                lambda: self._completed >= self._accepted
                or self._error is not None,
                timeout=timeout)
        if not ok:
            raise TimeoutError(f"flush timed out after {timeout}s")
        self._raise_pending()
        return self

    def drain_compact(self, timeout: float | None = None) \
            -> "PartitionService":
        """Explicit drain-then-reclaim: ``flush()``, then densely re-pack
        the session to its smallest tier (``compact``) under the dispatch
        lock, on the session's stream. Queries keep answering in original
        ids afterwards (the id map absorbs any relabelling)."""
        self.flush(timeout)
        with self._lock, self._on_stream():
            self._part.compact()
            self._drain_compacts += 1
        return self

    def drain_rebalance(self, timeout: float | None = None) -> dict:
        """Explicit drain-then-repair: ``flush()``, then one ``rebalance()``
        under the dispatch lock, on the session's stream. Returns the
        recorded rebalance event."""
        self.flush(timeout)
        with self._lock, self._on_stream():
            return self._part.rebalance()

    def _ingest_loop(self) -> None:
        try:
            with self._on_stream():
                self._ingest_on_stream()
        except BaseException as e:  # noqa: BLE001 — surfaced to callers
            self._error = e
            with self._cond:
                self._cond.notify_all()

    def _ingest_on_stream(self) -> None:
        prev_token = None
        idle_since: float | None = None
        while True:
            try:
                # no idle action configured ⇒ None blocks forever — the
                # plain path
                item = self._queue.get(timeout=self._idle_s)
            except queue.Empty:
                # idle window: nothing arrived for _idle_s. Let the card
                # finish the last batch, then run whichever idle actions'
                # thresholds the accumulated silence has crossed, under the
                # dispatch lock (queries wait out the repair, never race it)
                now = time.perf_counter()
                if idle_since is None:
                    # the get() above already waited one interval
                    idle_since = now - (self._idle_s or 0.0)
                idle_for = now - idle_since
                _wait(prev_token)
                with self._lock:
                    if (self.idle_rebalance_s is not None
                            and idle_for >= self.idle_rebalance_s):
                        cur = self._part.cursor
                        if cur != self._last_idle_rebalance_cursor:
                            self._part.rebalance()
                            self._last_idle_rebalance_cursor = cur
                            self._idle_rebalances += 1
                    if (self.idle_compact_s is not None
                            and idle_for >= self.idle_compact_s
                            and self._part.maybe_shrink()):
                        self._idle_shrinks += 1
                continue
            idle_since = None
            if item is _STOP:
                break
            # double buffering: coerce the first chunk while the card still
            # executes the previous batch...
            t0 = time.perf_counter()
            p = self._part.prepare(item[0])
            prepared, records = [p], [(item[1], p.num_events)]
            total, stopped = p.num_events, False
            self._coercion_s += time.perf_counter() - t0
            # ...then wait for that batch's completion token — the beat
            # during which further arrivals pile up in the queue...
            if prev_token is not None:
                t0 = time.perf_counter()
                prev_token.synchronize()
                self._device_wait_s += time.perf_counter() - t0
            # ...and only now drain them: everything that accumulated while
            # the card ran coalesces into ONE dispatch (continuous batching,
            # bounded by max_batch_events and by one queue's worth of
            # chunks — a submitter refilling the queue during the drain
            # would otherwise grow the batch, and the latency of every
            # chunk and query behind it, without bound). Draining before
            # the wait would sample the queue at its emptiest and defeat
            # the coalescing.
            t0 = time.perf_counter()
            for _ in range(self.max_pending_chunks):
                if self.max_batch_events is not None \
                        and total >= self.max_batch_events:
                    break
                try:
                    nxt = self._queue.get_nowait()
                except queue.Empty:
                    break
                if nxt is _STOP:
                    stopped = True
                    break
                p = self._part.prepare(nxt[0])
                prepared.append(p)
                records.append((nxt[1], p.num_events))
                total += p.num_events
            batch = _merge_prepared(prepared)
            self._coercion_s += time.perf_counter() - t0
            with self._lock:
                self._part.feed_prepared(batch)
                token = self._token()
            self._inflight.put((token, time.perf_counter(), records))
            prev_token = token
            self._batches += 1
            if stopped:
                break

    def _completion_loop(self) -> None:
        """Waits on each batch's completion token in dispatch order,
        stamping completion times for the latency percentiles and the
        busy accounting. Runs off the ingest path so waiting for batch *t*
        never delays coercion of chunk *t+1*."""
        try:
            last_done = None
            while True:
                item = self._inflight.get()
                if item is _STOP:
                    break
                token, dispatch_t, records = item
                _wait(token)
                now = time.perf_counter()
                busy_from = dispatch_t if last_done is None \
                    else max(dispatch_t, last_done)
                self._device_busy_s += max(now - busy_from, 0.0)
                last_done = now
                self._t_last_done = now
                with self._cond:
                    for arrival, n_ev in records:
                        self._latencies.append(now - arrival)
                        self._completed += 1
                        self._events_ingested_done += n_ev
                    self._cond.notify_all()
        except BaseException as e:  # noqa: BLE001 — surfaced to callers
            self._error = e
            with self._cond:
                self._cond.notify_all()

    # -- queries ------------------------------------------------------------

    def _snapshot_gather(self, build) -> np.ndarray:
        """Enqueue ``build(state)`` against a consistent snapshot of the
        carried state (under the dispatch lock, on the session's stream:
        ordered after every dispatched feed and before the next one), copy
        it into pinned host memory without blocking, and wait for that
        copy alone — ingest continues meanwhile."""
        self._raise_pending()
        done = None
        with self._lock, self._on_stream():
            state = self._part.state
            if isinstance(state.assignment, RowBlocks):
                # a vertex-sharded session: the labels gathered on the
                # lead device, stream-ordered like the gather itself
                state = state._replace(assignment=state.assignment.gather())
            out = build(state)
            if self._stream is not None:
                host = torch.empty(out.shape, dtype=out.dtype,
                                   pin_memory=True)
                host.copy_(out, non_blocking=True)
                done = torch.cuda.Event()
                done.record(self._stream)
            else:
                host = out
        _wait(done)
        return host.numpy().copy()

    def where(self, v: int) -> int:
        """Current partition label of vertex ``v`` (-1 = absent /
        unassigned / outside the session geometry). Reflects every
        dispatched batch and no partial one (see module docstring)."""
        return int(self.where_many([v])[0])

    def where_many(self, vs) -> np.ndarray:
        """Bulk lookup: one gather for a batch of vertex ids — (V,) int32
        labels, -1 for absent/out-of-range ids. Ids are the caller's
        ORIGINAL ids: a relabelling compaction moves vertices to new
        internal slots, and the lookup routes through the session's id map
        (under the same lock as the gather, so the map and the state it
        indexes are the same version)."""
        vs = np.atleast_1d(np.asarray(vs, np.int32))

        def build(state):
            # external -> internal inside the locked region: unknown /
            # never-fed ids come back -1 from the map and stay -1 here
            ids = torch.from_numpy(self._part.to_internal(vs))
            if self._stream is not None:
                ids = ids.pin_memory().to(state.assignment.device,
                                          non_blocking=True)
            n = state.assignment.shape[0]
            lab = state.assignment[ids.clamp(0, n - 1)]
            return torch.where((ids >= 0) & (ids < n), lab,
                               torch.full_like(lab, -1))

        return self._snapshot_gather(build)

    def route(self, edges) -> RouteResult:
        """Partition routing for ``edges`` — an (E, 2) array (or pair of
        (E,) arrays) of vertex ids. Returns each endpoint's label and a
        ``cut`` mask marking edges whose endpoints live in different
        partitions (both assigned). One gather; consistency as ``where``."""
        e = np.asarray(edges, np.int32)
        if e.ndim == 1 and e.shape[0] == 2:        # one (u, v) edge
            e = e[None, :]
        elif e.ndim == 2 and e.shape[1] != 2 and e.shape[0] == 2:
            e = e.T                                # (src_ids, dst_ids) pair
        if e.ndim != 2 or e.shape[1] != 2:
            raise ValueError(
                "route() takes an (E, 2) edge array, one (u, v) edge, or "
                f"a (src, dst) pair of (E,) arrays — got shape {e.shape}")
        labs = self.where_many(e.reshape(-1)).reshape(e.shape)
        src, dst = labs[:, 0], labs[:, 1]
        cut = (src != dst) & (src >= 0) & (dst >= 0)
        return RouteResult(src, dst, cut)

    # -- observation --------------------------------------------------------

    def metrics(self) -> dict:
        """Serving counters + the session's ``metrics()``.

        Keys added by the service: ``queue_depth`` / ``max_queue_depth``,
        ``chunks_submitted`` / ``chunks_dropped`` / ``chunks_ingested``,
        ``events_ingested`` (events in completed batches),
        ``batches_dispatched`` (post-coalescing), ``coercion_s`` (host
        prepare+merge time), ``device_wait_s`` (ingest thread blocked on
        the previous batch), ``submit_blocked_s`` (callers blocked on
        backpressure), ``device_busy_fraction`` (fraction of the serving
        wall with a batch executing, as the completion thread sees it),
        ``events_per_s`` (completed events over the serving wall), and
        ``feed_p50_ms`` / ``feed_p99_ms`` (submit-arrival →
        batch-completion latency percentiles). Reads the session's
        counters on its stream, after the batches dispatched so far."""
        self._raise_pending()
        with self._lock, self._on_stream():
            part_m = self._part.metrics()
        with self._cond:
            lat = np.asarray(self._latencies, np.float64)
            done = self._events_ingested_done
            m = {
                "queue_depth": self._queue.qsize(),
                "max_queue_depth": self._max_depth,
                "chunks_submitted": self._accepted + self._dropped,
                "chunks_dropped": self._dropped,
                "chunks_ingested": self._completed,
                "events_ingested": done,
                "batches_dispatched": self._batches,
                "coercion_s": self._coercion_s,
                "device_wait_s": self._device_wait_s,
                "submit_blocked_s": self._submit_blocked_s,
                "backpressure_policy": self.policy,
                "max_pending_chunks": self.max_pending_chunks,
                "idle_compact_s": self.idle_compact_s,
                "idle_shrinks": self._idle_shrinks,
                "idle_rebalance_s": self.idle_rebalance_s,
                "idle_rebalances": self._idle_rebalances,
                "drain_compacts": self._drain_compacts,
            }
        wall = None
        if self._t_start is not None:
            end = self._t_last_done
            wall = max((end or time.perf_counter()) - self._t_start, 1e-9)
        m["wall_s"] = wall if wall is not None else 0.0
        m["events_per_s"] = (done / wall) if wall else 0.0
        m["device_busy_fraction"] = (
            min(self._device_busy_s / wall, 1.0) if wall else 0.0)
        m["feed_p50_ms"] = float(np.percentile(lat, 50) * 1e3) \
            if lat.size else None
        m["feed_p99_ms"] = float(np.percentile(lat, 99) * 1e3) \
            if lat.size else None
        m.update(part_m)
        return m

    def latencies(self) -> np.ndarray:
        """All completed chunks' arrival→completion latencies (seconds,
        submission order)."""
        with self._cond:
            return np.asarray(self._latencies, np.float64)

    @property
    def partitioner(self) -> Partitioner:
        """The wrapped session (the service owns its feed path — query and
        snapshot it, do not feed it while the service is open)."""
        return self._part

    def __repr__(self) -> str:
        return (f"PartitionService(policy={self.policy!r}, "
                f"max_pending_chunks={self.max_pending_chunks}, "
                f"queued={self._queue.qsize()}, closed={self._closed})")
