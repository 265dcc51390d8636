"""Plain PyTorch version of the window RNG kernel: one
``transition.rand_index_table`` a table, in a loop over the table axis."""
from __future__ import annotations

import torch

from repro_torch.core.transition import rand_index_table


def window_rng_ref(key: torch.Tensor, t0: int, w: int,
                   k: int) -> torch.Tensor:
    """The draw tables of ``window_rng``: for a (2,) ``key`` the (w, k)
    ``rand_index_table(key, t0, w, k)``; for (L, 2) ``keys`` the (L, w, k)
    stack of ``rand_index_table(keys[j], t0, w, k)``."""
    if key.dim() == 1:
        return rand_index_table(key, int(t0), w, k)
    return torch.stack([rand_index_table(kj, int(t0), w, k) for kj in key])
