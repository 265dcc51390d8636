"""Crash-safe partitioning sessions (the port's copy of
``repro.runtime.recovery``), the (policy × seed × config × stream) sweep
runtime (``repro_torch.runtime.sweep``), vertex-sharded sessions
(``shard_session``), and the fault-tolerant loop and elastic re-mesh
(``fault``, ``elastic``)."""
from repro_torch.runtime.recovery import (
    CrashError, EventJournal, JournalEntry, RecoverableSession,
)
from repro_torch.runtime.sweep import (
    SweepResult, SweepRun, run_sweep, sweep_events,
)

__all__ = ["CrashError", "EventJournal", "JournalEntry",
           "RecoverableSession", "SweepResult", "SweepRun", "run_sweep",
           "sweep_events"]
