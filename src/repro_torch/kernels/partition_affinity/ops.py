"""Wiring of the partition_affinity kernel into the window engine."""
from __future__ import annotations

import torch

from repro_torch.kernels.partition_affinity.partition_affinity import (
    partition_affinity,
)


def gather_labels(assignment: torch.Tensor, present: torch.Tensor,
                  rows: torch.Tensor) -> torch.Tensor:
    """The gather half of the scoring op (stays outside the kernel):
    neighbour labels, -1 for padding and absent neighbours."""
    valid = rows >= 0
    safe = torch.where(valid, rows, 0)
    nb_present = valid & present[safe]
    return torch.where(nb_present, assignment[safe], -1).to(torch.int32)


def scores_for_state(state, rows: torch.Tensor):
    """Drop-in for ``repro_torch.core.windowed.committed_scores`` through
    the kernel. Absent vertices with stale assignment entries (deletion
    holes) score as empty, matching the faithful engine."""
    labels = gather_labels(state.assignment, state.present, rows)
    return partition_affinity(labels, k_max=state.edge_load.shape[0])
