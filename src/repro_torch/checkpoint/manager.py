"""Checkpoint manager (the port's copy of ``repro.checkpoint.manager``):
saves on a background thread, retention, resume, and a step journal for
straggler accounting.

* A save stages the tree to the host synchronously (so the caller may go
  on mutating the live state at once) and writes it on a background
  thread (``blocking=False``) or before returning.
* Atomic renames: a crash mid-save never corrupts the latest checkpoint.
* ``latest()`` + ``restore()`` resume after preemption or failure.
* The journal records ``(step, wall_time, status)``; ``is_straggler``
  flags steps slower than ``straggler_factor`` × the recent median.
"""
from __future__ import annotations

import glob
import json
import os
import re
import threading

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import (
    _rebuild, _walk, checkpoint_extras, checkpoint_geometry, checkpoint_keys,
    restore_pytree, save_pytree, to_numpy,
)

# Default device→host staging granularity of save_now (bytes): large
# enough that chunking costs nothing, small enough that each synchronous
# copy is short.
DEFAULT_CHUNK_BYTES = 16 << 20


def _stage_leaf(leaf, chunk_bytes: int) -> np.ndarray:
    """A host copy of one leaf, copied in row chunks of at most
    ``chunk_bytes`` into one preallocated host buffer. Host leaves pass
    through."""
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    nbytes = leaf.numel() * leaf.element_size()
    if leaf.ndim == 0 or nbytes <= chunk_bytes:
        # a CPU leaf's numpy() is a view of the live tensor, which the next
        # feed updates in place: copy it
        host = to_numpy(leaf)
        return host.copy() if leaf.device.type == "cpu" else host
    row_bytes = max(nbytes // leaf.shape[0], 1)
    rows = max(int(chunk_bytes // row_bytes), 1)
    out = np.empty(tuple(leaf.shape), to_numpy(leaf[:0]).dtype)
    for i0 in range(0, leaf.shape[0], rows):
        out[i0:i0 + rows] = to_numpy(leaf[i0:i0 + rows])
    return out


def _stage_host(tree, chunk_bytes: int):
    """Device→host snapshot of ``tree``, each leaf in row chunks of at
    most ``chunk_bytes`` (see ``_stage_leaf``)."""
    pairs: list = []
    _walk(tree, (), pairs)
    return _rebuild(tree, iter([_stage_leaf(v, chunk_bytes)
                                for _, v in pairs]))


class CheckpointManager:
    def __init__(self, directory: str, *, interval: int = 100, keep: int = 3,
                 keep_last: int | None = None, straggler_factor: float = 3.0,
                 host_chunk_bytes: int = DEFAULT_CHUNK_BYTES):
        """``keep`` / ``keep_last`` (synonyms; ``keep_last`` wins when both
        are given) bound the retained checkpoints: every save removes all
        but the newest N. ``host_chunk_bytes`` bounds each synchronous
        device→host copy of ``save_now``."""
        self.dir = directory
        self.interval = interval
        if host_chunk_bytes <= 0:
            raise ValueError(
                f"host_chunk_bytes={host_chunk_bytes} must be > 0: it is "
                "the per-chunk bound on the synchronous device→host "
                "staging copies")
        self.host_chunk_bytes = int(host_chunk_bytes)
        self.keep = int(keep if keep_last is None else keep_last)
        if self.keep < 1:
            raise ValueError(
                f"keep_last={self.keep} must be >= 1: retaining zero "
                "checkpoints would garbage-collect the snapshot that was "
                "just written")
        self.straggler_factor = straggler_factor
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._journal_path = os.path.join(directory, "journal.jsonl")
        self._step_times: list[float] = []

    # -- journal / straggler accounting ------------------------------------
    def record_step(self, step: int, seconds: float, status: str = "ok"):
        self._step_times.append(seconds)
        with open(self._journal_path, "a") as f:
            f.write(json.dumps({"step": step, "t": seconds,
                                "status": status}) + "\n")

    def is_straggler(self, seconds: float) -> bool:
        if len(self._step_times) < 8:
            return False
        med = float(np.median(self._step_times[-64:]))
        return seconds > self.straggler_factor * med

    # -- save/restore -------------------------------------------------------
    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"ckpt_{step:08d}.npz")

    def maybe_save(self, step: int, tree, *, blocking: bool = False,
                   geometry=None, extras=None):
        """Interval-gated save: a no-op (returns False) unless ``step`` is a
        multiple of ``interval``; :meth:`save_now` saves unconditionally."""
        if step % self.interval != 0:
            return False
        self.save_now(step, tree, blocking=blocking, geometry=geometry,
                      extras=extras)
        return True

    def save_now(self, step: int, tree, *, blocking: bool = False,
                 geometry=None, extras=None) -> int:
        """Save ``tree`` at ``step``, staged to the host before the call
        returns. Returns ``step``."""
        host_tree = _stage_host(tree, self.host_chunk_bytes)
        # copies: the session updates its id map in place
        host_extras = ({k: np.array(to_numpy(v)) for k, v in extras.items()}
                       if extras else None)

        def work():
            save_pytree(self._path(step), host_tree, step=step,
                        geometry=geometry, extras=host_extras)
            self._gc()

        if self._thread is not None:
            self._thread.join()
        if blocking:
            work()
            self._thread = None
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        return step

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _steps(self) -> list[int]:
        out = []
        for p in glob.glob(os.path.join(self.dir, "ckpt_*.npz")):
            m = re.search(r"ckpt_(\d+)\.npz$", p)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def _gc(self):
        for s in self._steps()[: -self.keep]:
            for suffix in ("", ".meta"):
                p = self._path(s) + suffix
                if os.path.exists(p):
                    os.unlink(p)

    def latest(self) -> int | None:
        steps = self._steps()
        return steps[-1] if steps else None

    def leaf_keys(self, step: int | None = None) -> list[str] | None:
        """Key paths of the leaves saved at ``step`` (default: latest)."""
        step = step if step is not None else self.latest()
        if step is None:
            return None
        return checkpoint_keys(self._path(step))

    def geometry(self, step: int | None = None):
        """The ``Geometry`` recorded for (or inferred from) the checkpoint
        at ``step`` (default: latest)."""
        step = step if step is not None else self.latest()
        if step is None:
            return None
        return checkpoint_geometry(self._path(step))

    def extras(self, step: int | None = None) -> dict:
        """The ``extras`` arrays saved with the checkpoint at ``step``
        (default: latest; empty when none)."""
        step = step if step is not None else self.latest()
        if step is None:
            return {}
        return checkpoint_extras(self._path(step))

    def restore(self, like, *, step: int | None = None, shardings=None,
                fill_missing: bool = False, device=None):
        """``(tree, step)`` of the checkpoint at ``step`` (default: latest),
        or ``(None, None)`` when there is none; ``shardings`` (a tree of
        ``launch.mesh.Placement``s matching ``like``) places each leaf for
        an elastic re-shard. See ``restore_pytree``."""
        step = step if step is not None else self.latest()
        if step is None:
            return None, None
        return restore_pytree(self._path(step), like, shardings=shardings,
                              fill_missing=fill_missing,
                              device=device), step
