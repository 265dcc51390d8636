"""Architecture registry of the port: the archs it runs, selectable by
--arch id. The JAX package registers 10 archs; the port runs
``two-tower-retrieval`` so far, and asking for any other raises
``NotImplementedError`` naming the ROADMAP item that ports it."""
from __future__ import annotations

from repro_torch.configs import two_tower_retrieval
from repro_torch.configs.base import ArchDef
from repro_torch.configs.shapes import (GNN_SHAPES, LM_SHAPES, RECSYS_SHAPES,
                                        GNNShape, LMShape, RecSysShape)

ARCHS: dict[str, ArchDef] = {
    m.ARCH.arch_id: m.ARCH for m in (two_tower_retrieval,)
}

# the JAX package's other archs, by family, and the ROADMAP item of each
_PENDING_FAMILY = {
    "gemma2-9b": "lm", "deepseek-coder-33b": "lm", "phi3-mini-3.8b": "lm",
    "moonshot-v1-16b-a3b": "lm", "llama4-scout-17b-a16e": "lm",
    "meshgraphnet": "gnn", "schnet": "gnn", "nequip": "gnn", "pna": "gnn",
}
_PENDING_ITEM = {
    "lm": "ROADMAP A18.4 (the LM slice: models/layers, transformer, moe, "
          "launch/serve's LM path, flash_attention — B5)",
    "gnn": "ROADMAP A18.5 (the GNN slice: models/gnn, segment_spmm — B3)",
}


def get_arch(arch_id: str) -> ArchDef:
    if arch_id in _PENDING_FAMILY:
        family = _PENDING_FAMILY[arch_id]
        raise NotImplementedError(
            f"arch '{arch_id}' ({family}) is not ported yet: "
            f"{_PENDING_ITEM[family]}")
    if arch_id not in ARCHS:
        raise KeyError(
            f"unknown arch '{arch_id}'; available: {sorted(ARCHS)}")
    return ARCHS[arch_id]


__all__ = ["ARCHS", "get_arch", "ArchDef",
           "LM_SHAPES", "GNN_SHAPES", "RECSYS_SHAPES",
           "LMShape", "GNNShape", "RecSysShape"]
