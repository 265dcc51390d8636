"""Plain PyTorch version of the window RNG kernel:
``transition.rand_index_table``, re-exported."""
from __future__ import annotations

from repro_torch.core.transition import rand_index_table

__all__ = ["window_rng_ref"]

window_rng_ref = rand_index_table
