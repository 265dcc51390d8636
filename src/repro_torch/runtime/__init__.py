"""Crash-safe partitioning sessions (the port's copy of
``repro.runtime.recovery``). The vmapped sweep runtime is a later slice
(ROADMAP A13)."""
from repro_torch.runtime.recovery import (
    CrashError, EventJournal, JournalEntry, RecoverableSession,
)

__all__ = ["CrashError", "EventJournal", "JournalEntry",
           "RecoverableSession"]
