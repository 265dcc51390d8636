"""Architecture registry of the port: the archs it runs, selectable by
--arch id. The JAX package registers 10 archs; the port runs its five LMs
(the dense ``gemma2-9b``, ``phi3-mini-3.8b``, ``deepseek-coder-33b`` and
the MoE ``moonshot-v1-16b-a3b``, ``llama4-scout-17b-a16e``) and
``two-tower-retrieval``, and asking for a GNN arch raises
``NotImplementedError`` naming the ROADMAP item that ports it."""
from __future__ import annotations

from repro_torch.configs import (
    deepseek_coder_33b,
    gemma2_9b,
    llama4_scout_17b_a16e,
    moonshot_v1_16b_a3b,
    phi3_mini_3p8b,
    two_tower_retrieval,
)
from repro_torch.configs.base import ArchDef
from repro_torch.configs.shapes import (GNN_SHAPES, LM_SHAPES, RECSYS_SHAPES,
                                        GNNShape, LMShape, RecSysShape)

ARCHS: dict[str, ArchDef] = {
    m.ARCH.arch_id: m.ARCH
    for m in (gemma2_9b, deepseek_coder_33b, phi3_mini_3p8b,
              moonshot_v1_16b_a3b, llama4_scout_17b_a16e, two_tower_retrieval)
}

# the JAX package's other archs, and the ROADMAP item that ports each
_PENDING = {
    "meshgraphnet": "gnn", "schnet": "gnn", "nequip": "gnn", "pna": "gnn",
}
_PENDING_ITEM = {
    "gnn": "ROADMAP A18.5 (the GNN slice: models/gnn)",
}


def get_arch(arch_id: str) -> ArchDef:
    if arch_id in _PENDING:
        kind = _PENDING[arch_id]
        raise NotImplementedError(
            f"arch '{arch_id}' ({kind}) is not ported yet: "
            f"{_PENDING_ITEM[kind]}")
    if arch_id not in ARCHS:
        raise KeyError(
            f"unknown arch '{arch_id}'; available: {sorted(ARCHS)}")
    return ARCHS[arch_id]


__all__ = ["ARCHS", "get_arch", "ArchDef",
           "LM_SHAPES", "GNN_SHAPES", "RECSYS_SHAPES",
           "LMShape", "GNNShape", "RecSysShape"]
