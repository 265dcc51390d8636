"""Fault-tolerant training loop wrapper (the port's copy of
``repro.runtime.fault``).

Policies (designed for many nodes, exercised here in one process):
  * periodic checkpoints on a background thread (never blocks the step);
  * crash recovery: any exception inside a step → restore the latest
    checkpoint, skip the poisoned batch, continue;
  * straggler mitigation: steps slower than ``straggler_factor`` × the
    rolling median are journaled; after ``straggler_patience`` consecutive
    slow steps the ``on_straggler`` hook fires (in production: re-shard
    away from the slow host — SDP's scale-in at the resource level);
  * a bounded retry budget, so a step that keeps failing aborts loudly
    instead of spinning.

The loop is training-shaped (state in, batches through a ``step_fn``).
For an open-ended event stream into a ``repro_torch.api.Partitioner`` the
same policies live in ``repro_torch.runtime.recovery`` (journal, snapshot
and bit-identical replay).
"""
from __future__ import annotations

import time
from typing import Callable

from repro_torch.checkpoint.manager import CheckpointManager


class FaultTolerantLoop:
    def __init__(self, ckpt: CheckpointManager, *, max_retries: int = 3,
                 straggler_patience: int = 3,
                 on_straggler: Callable[[int], None] | None = None):
        self.ckpt = ckpt
        self.max_retries = max_retries
        self.straggler_patience = straggler_patience
        self.on_straggler = on_straggler
        self.retries = 0
        self.slow_streak = 0
        self.events: list[dict] = []

    def run(self, state, batches, step_fn, *, start_step: int = 0,
            like=None):
        """``state``: a tree of tensors (``RowBlocks`` leaves too);
        ``step_fn(state, batch)`` → ``(state, metrics)``. Returns ``(state,
        final_step)``. ``like`` is the tree a restore fills (default: the
        state being stepped)."""
        step = start_step
        it = iter(batches)
        while True:
            try:
                batch = next(it)
            except StopIteration:
                break
            t0 = time.monotonic()
            try:
                state, metrics = step_fn(state, batch)
                self.retries = 0
            except Exception as err:  # noqa: BLE001 — node failure analogue
                self.retries += 1
                self.events.append({"step": step, "event": "failure",
                                    "err": repr(err)})
                if self.retries > self.max_retries:
                    raise
                # join any save in flight first: restoring while the
                # background writer is mid-checkpoint can read a payload
                # whose sidecar meta has not landed yet
                self.ckpt.wait()
                restored, rstep = self.ckpt.restore(
                    like if like is not None else state)
                if restored is not None:
                    state, step = restored, rstep
                self.ckpt.record_step(step, 0.0, status="restored")
                continue
            dt = time.monotonic() - t0
            self.ckpt.record_step(step, dt)
            if self.ckpt.is_straggler(dt):
                self.slow_streak += 1
                self.events.append({"step": step, "event": "straggler",
                                    "t": dt})
                if (self.slow_streak >= self.straggler_patience
                        and self.on_straggler is not None):
                    self.on_straggler(step)
                    self.slow_streak = 0
            else:
                self.slow_streak = 0
            step += 1
            self.ckpt.maybe_save(step, state)
        self.ckpt.wait()
        return state, step
