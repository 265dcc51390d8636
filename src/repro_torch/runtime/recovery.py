"""Crash-safe long-lived sessions: snapshot + journal + replay recovery
(the port's copy of ``repro.runtime.recovery``, in the same on-disk
format, so a journal either package wrote, the other replays).

* :class:`EventJournal` — an append-only, atomically written log of every
  fed chunk (and every explicit geometry or rebalance action), keyed by
  the session's global event cursor;
* :class:`RecoverableSession` — wraps a :class:`repro_torch.api.Partitioner`,
  journaling each feed and snapshotting every ``snapshot_every`` events
  (on a background writer, retention-bounded by ``keep``);
* :meth:`RecoverableSession.recover` — restore the latest snapshot and
  replay the journaled tail. ``feed`` is chop-invariant and the RNG is
  keyed by the global event cursor, so the recovered state is
  bit-identical to the uninterrupted run (tests/test_torch_recovery.py,
  a SIGKILLed process included).

The journal records **external** vertex ids (exactly what the caller
fed). A relabelling compaction's id map rides in the snapshot's extras,
and replayed feeds re-translate deterministically (fresh slots are
allocated in first-appearance order), so recovery composes with
shrinking and compaction.

``RecoverableSession`` speaks the ``prepare``/``feed_prepared``/``sync``
protocol, so ``repro_torch.api.serve.PartitionService`` serves one
directly: a serving tier whose state survives the machine. Its automatic
snapshots then run on the service's ingest thread; ``Partitioner.
snapshot`` copies the state to the host before it returns, so the next
in-place feed cannot tear a snapshot.

Device loss with the process alive is ``remesh(device)``: the live
session moves to a surviving device through ``Partitioner.place`` (a host
round-trip); a vertex-sharded session rebuilds its mesh over the
surviving devices through ``Partitioner.reshard``. If the process died,
``recover`` rebuilds on whatever device the fresh process names
(``device=`` among its keywords; ``None`` is the card).
"""
from __future__ import annotations

import glob
import io
import json
import os
import re
import tempfile
from typing import NamedTuple

import numpy as np

from repro_torch.api.partitioner import Partitioner, PreparedChunk
from repro_torch.core.config import EngineConfig
from repro_torch.core.geometry import Geometry


class CrashError(RuntimeError):
    """The injected mid-stream failure (``inject_crash_after``) — raised
    after the triggering chunk is journaled but before it is fed, the
    worst-ordered single point a real crash could hit."""


class JournalEntry(NamedTuple):
    cursor: int     # session cursor the entry applies at
    seq: int        # total order within a cursor (append order)
    kind: str       # "events" | "compact" | "shrink" | "rebalance" | "snap"
    path: str


class EventJournal:
    """Append-only on-disk event log, replayable from any cursor.

    Each ``append`` atomically writes one npz chunk named by the cursor it
    applies at plus a monotonic sequence number (a crash mid-write leaves
    only a temp file, never a torn entry). Session actions append a marker
    entry so a replay re-applies them at the same point in the stream."""

    _PAT = re.compile(r"(ev|cp)_(\d+)_(\d+)(?:_(\w+))?\.(?:npz|marker)$")

    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        seqs = [e.seq for e in self.entries()]
        self._seq = (max(seqs) + 1) if seqs else 0

    def entries(self) -> list[JournalEntry]:
        """All journal entries in replay order (cursor, then append
        order)."""
        out = []
        for p in glob.glob(os.path.join(self.dir, "*_*")):
            m = self._PAT.search(os.path.basename(p))
            if not m:
                continue
            kind = "events" if m.group(1) == "ev" else (m.group(4)
                                                        or "compact")
            out.append(JournalEntry(int(m.group(2)), int(m.group(3)),
                                    kind, p))
        return sorted(out, key=lambda e: (e.cursor, e.seq))

    def _write_atomic(self, name: str, payload: bytes) -> str:
        fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=".tmp")
        try:
            os.write(fd, payload)
        finally:
            os.close(fd)
        final = os.path.join(self.dir, name)
        os.replace(tmp, final)
        return final

    def append(self, cursor: int, etype, vertex, nbrs) -> str:
        """Journal one fed chunk (external ids, before translation)
        applying at ``cursor`` (the session cursor before the feed)."""
        buf = io.BytesIO()
        np.savez(buf, etype=np.asarray(etype, np.int32),
                 vertex=np.asarray(vertex, np.int32),
                 nbrs=np.asarray(nbrs, np.int32))
        name = f"ev_{int(cursor):012d}_{self._seq:08d}.npz"
        self._seq += 1
        return self._write_atomic(name, buf.getvalue())

    def append_marker(self, cursor: int, kind: str,
                      payload: dict | None = None) -> str:
        """Journal a session action (``"compact"``, ``"shrink"``,
        ``"rebalance"``, or the ``"snap"`` bookkeeping marker) taken at
        ``cursor``, so replay re-applies it in order. ``payload`` (the
        action's arguments) is stored as JSON in the marker file and comes
        back through :meth:`load_marker`."""
        name = f"cp_{int(cursor):012d}_{self._seq:08d}_{kind}.marker"
        self._seq += 1
        data = json.dumps(payload).encode() if payload is not None else b""
        return self._write_atomic(name, data)

    def load(self, entry: JournalEntry):
        with np.load(entry.path) as data:
            return data["etype"], data["vertex"], data["nbrs"]

    def load_marker(self, entry: JournalEntry) -> dict:
        """The JSON payload of a marker entry ({} for payload-free markers
        like compact/shrink)."""
        with open(entry.path, "rb") as f:
            raw = f.read()
        return json.loads(raw) if raw else {}

    def prune_below(self, cursor: int) -> int:
        """Drop entries fully consumed before ``cursor`` — anything a
        restore from the oldest *retained* checkpoint could never need.
        Returns the number of entries removed."""
        removed = 0
        for e in self.entries():
            if e.kind == "events":
                with np.load(e.path) as data:
                    done = e.cursor + int(data["etype"].shape[0]) <= cursor
            else:
                done = e.cursor < cursor
            if done:
                os.unlink(e.path)
                removed += 1
        return removed


class RecoverableSession:
    """A :class:`Partitioner` that survives the process (see module
    docstring).

    Args:
      part: the live session to protect (or a fresh one).
      directory: snapshot + journal root. Snapshots land as the session's
        normal checkpoints; the journal lives in ``directory/journal``.
      snapshot_every: events between automatic snapshots (written on a
        background thread). Each one copies the state to the host, a read
        of the device — size it so the copy amortizes.
      keep: snapshots retained; the journal is pruned to what the oldest
        retained snapshot needs.
      inject_crash_after: for tests — raise :class:`CrashError` on the
        first feed once the cursor reaches this value, after journaling
        but before feeding (the worst-ordered crash point).
    """

    def __init__(self, part: Partitioner, directory: str, *,
                 snapshot_every: int = 2048, keep: int = 3,
                 inject_crash_after: int | None = None):
        if snapshot_every <= 0:
            raise ValueError(
                f"snapshot_every={snapshot_every} must be > 0: it is the "
                "event spacing of the automatic snapshots")
        self.part = part
        self.dir = directory
        self.snapshot_every = int(snapshot_every)
        self.keep = int(keep)
        self.inject_crash_after = inject_crash_after
        self.journal = EventJournal(os.path.join(directory, "journal"))
        self._last_snapshot = part.cursor
        self._snapshots = 0

    # -- the Partitioner protocol (what PartitionService drives) ------------

    def prepare(self, events) -> PreparedChunk:
        return self.part.prepare(events)

    def feed_prepared(self, chunk: PreparedChunk) -> "RecoverableSession":
        if chunk.num_events:
            self.journal.append(self.part.cursor, chunk.etype,
                                chunk.vertex, chunk.nbrs)
        if self.inject_crash_after is not None \
                and self.part.cursor >= self.inject_crash_after:
            raise CrashError(
                f"injected crash at cursor {self.part.cursor} (chunk "
                "journaled, not fed — recovery must replay it)")
        self.part.feed_prepared(chunk)
        if self.part.cursor - self._last_snapshot >= self.snapshot_every:
            self.checkpoint(blocking=False)
        return self

    def feed(self, events) -> "RecoverableSession":
        return self.feed_prepared(self.prepare(events))

    def sync(self) -> "RecoverableSession":
        self.part.sync()
        return self

    def metrics(self) -> dict:
        m = self.part.metrics()
        m["snapshots"] = self._snapshots
        m["last_snapshot_cursor"] = self._last_snapshot
        return m

    @property
    def state(self):
        return self.part.state

    @property
    def cursor(self) -> int:
        return self.part.cursor

    @property
    def device(self):
        return self.part.device

    @property
    def geometry(self) -> Geometry:
        return self.part.geometry

    def to_internal(self, ids):
        return self.part.to_internal(ids)

    def to_external(self, ids):
        return self.part.to_external(ids)

    # -- geometry actions (journaled so replay reproduces them) -------------

    def compact(self) -> "RecoverableSession":
        # marker BEFORE the action: compact() is unconditional, so a crash
        # between marker and action just replays the compaction
        self.journal.append_marker(self.part.cursor, "compact")
        self.part.compact()
        return self

    def maybe_shrink(self, **kw) -> bool:
        # marker AFTER: the shrink is conditional on live content, and a
        # replayed maybe_shrink at the same cursor decides identically
        did = self.part.maybe_shrink(**kw)
        if did:
            self.journal.append_marker(self.part.cursor, "shrink")
        return did

    def rebalance(self, m: int | None = None, passes: int | None = None,
                  slack: float | None = None) -> dict:
        """Journaled explicit rebalance (see ``Partitioner.rebalance``).
        Marker BEFORE the action, like ``compact()``: the pass is a
        deterministic function of (state, cursor), so a crash between
        marker and action just replays it. ``auto_rebalance`` cadence needs
        no marker — its mark rides the checkpoint extras and the replayed
        feeds re-fire it at the same cursors."""
        self.journal.append_marker(
            self.part.cursor, "rebalance",
            {"m": m, "passes": passes, "slack": slack})
        return self.part.rebalance(m=m, passes=passes, slack=slack)

    def remesh(self, device=None, *, devices=None) -> "RecoverableSession":
        """Re-mesh after a (simulated) device loss with the process alive —
        bit-preserving either way; if the process died too, use
        :meth:`recover`. A single-device session moves onto ``device``
        (``Partitioner.place``, a host round-trip); a vertex-sharded
        session rebuilds its mesh over ``devices`` (or ``[device]``, or
        every CUDA card when neither is given) through
        ``Partitioner.reshard`` — the gather / re-pad round trip, so the
        mesh may change width."""
        if self.part.sharded:
            if devices is None and device is not None:
                devices = [device]
            self.part.reshard(devices)
        else:
            if device is None:
                raise ValueError(
                    "remesh() of a single-device session needs the target "
                    "device (devices= is the vertex-sharded form)")
            self.part.place(device)
        return self

    # -- snapshots ----------------------------------------------------------

    def checkpoint(self, *, blocking: bool = True) -> int:
        """Snapshot now (regardless of ``snapshot_every``); prunes the
        journal entries no retained snapshot could need. Returns the
        snapshotted cursor."""
        # "snap" marker first: it records (by sequence number) that every
        # action marker journaled at this cursor so far is contained in the
        # snapshot about to be written, so recover() does not re-apply
        # them. Written BEFORE the save: a crash between the two leaves a
        # stale marker that an older-snapshot restore ignores (its cursor
        # is ahead), never a double-applied action.
        self.journal.append_marker(self.part.cursor, "snap")
        step = self.part.snapshot(self.dir, keep=self.keep,
                                  blocking=blocking)
        self._last_snapshot = step
        self._snapshots += 1
        steps = self.part._managers[self.dir]._steps()
        if steps:
            self.journal.prune_below(steps[0])
        return step

    def wait(self) -> None:
        """Join pending background snapshot writers (call before exit)."""
        self.part.wait()

    # -- recovery -----------------------------------------------------------

    @classmethod
    def recover(cls, directory: str, cfg: EngineConfig | None = None, *,
                snapshot_every: int = 2048, keep: int = 3,
                **kw) -> "RecoverableSession":
        """Rebuild the session after a crash: restore the latest snapshot
        under ``directory`` (``Partitioner.restore`` — geometry, id map and
        cursor come back with it), then replay the journaled tail in order,
        re-applying action markers at their recorded cursors. The result is
        bit-identical to the run that never crashed. ``**kw`` are the
        session knobs (policy, window, device, …) — they are not
        checkpointed."""
        part = Partitioner.restore(directory, cfg, **kw)
        sess = cls(part, directory, snapshot_every=snapshot_every,
                   keep=keep)
        entries = sess.journal.entries()
        # action markers at the restored cursor journaled at or before the
        # snapshot's own "snap" marker are already in the snapshot —
        # re-applying them would double-apply (harmless for the idempotent
        # compact/shrink, wrong for rebalance). A journal without snap
        # markers (snap_seq == -1) replays every equal-cursor marker.
        snap_seq = max((e.seq for e in entries
                        if e.kind == "snap" and e.cursor == part.cursor),
                       default=-1)
        for e in entries:
            if e.kind == "snap":
                continue
            if e.kind != "events":
                if e.cursor > part.cursor or (e.cursor == part.cursor
                                              and e.seq > snap_seq):
                    if e.kind == "rebalance":
                        part.rebalance(**sess.journal.load_marker(e))
                    else:
                        (part.compact if e.kind == "compact"
                         else part.maybe_shrink)()
                continue
            et, vx, nb = sess.journal.load(e)
            end = e.cursor + int(et.shape[0])
            if end <= part.cursor:
                continue
            off = part.cursor - e.cursor
            part.feed((et[off:], vx[off:], nb[off:]))
        sess._last_snapshot = part.cursor
        return sess

    def __repr__(self) -> str:
        return (f"RecoverableSession(dir={self.dir!r}, "
                f"cursor={self.part.cursor}, "
                f"snapshot_every={self.snapshot_every}, "
                f"snapshots={self._snapshots})")
