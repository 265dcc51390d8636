"""Plain PyTorch version of the partition_affinity kernel."""
from __future__ import annotations

import torch

from repro_torch.kernels.common import label_histogram


def partition_affinity_ref(labels: torch.Tensor, *, k_max: int):
    """scores[w,k] = #{d: labels[w,d]==k};  deg[w] = #{d: labels[w,d]>=0}."""
    return label_histogram(labels, k_max)
