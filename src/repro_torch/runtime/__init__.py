"""Crash-safe partitioning sessions (the port's copy of
``repro.runtime.recovery``) and the (policy × seed × config × stream)
sweep runtime (``repro_torch.runtime.sweep``)."""
from repro_torch.runtime.recovery import (
    CrashError, EventJournal, JournalEntry, RecoverableSession,
)
from repro_torch.runtime.sweep import (
    SweepResult, SweepRun, run_sweep, sweep_events,
)

__all__ = ["CrashError", "EventJournal", "JournalEntry",
           "RecoverableSession", "SweepResult", "SweepRun", "run_sweep",
           "sweep_events"]
