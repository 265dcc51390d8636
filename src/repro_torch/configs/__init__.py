"""Architecture registry of the port: all 10 of the JAX package's archs,
selectable by --arch id — five LMs (the dense ``gemma2-9b``,
``phi3-mini-3.8b``, ``deepseek-coder-33b`` and the MoE
``moonshot-v1-16b-a3b``, ``llama4-scout-17b-a16e``), four GNNs
(``meshgraphnet``, ``schnet``, ``nequip``, ``pna``) and
``two-tower-retrieval``."""
from __future__ import annotations

from repro_torch.configs import (
    deepseek_coder_33b,
    gemma2_9b,
    llama4_scout_17b_a16e,
    meshgraphnet,
    moonshot_v1_16b_a3b,
    nequip,
    phi3_mini_3p8b,
    pna,
    schnet,
    two_tower_retrieval,
)
from repro_torch.configs.base import ArchDef
from repro_torch.configs.shapes import (GNN_SHAPES, LM_SHAPES, RECSYS_SHAPES,
                                        GNNShape, LMShape, RecSysShape)

ARCHS: dict[str, ArchDef] = {
    m.ARCH.arch_id: m.ARCH
    for m in (
        gemma2_9b, deepseek_coder_33b, phi3_mini_3p8b,
        moonshot_v1_16b_a3b, llama4_scout_17b_a16e,
        meshgraphnet, schnet, nequip, pna,
        two_tower_retrieval,
    )
}


def get_arch(arch_id: str) -> ArchDef:
    if arch_id not in ARCHS:
        raise KeyError(
            f"unknown arch '{arch_id}'; available: {sorted(ARCHS)}")
    return ARCHS[arch_id]


def all_cells() -> list[tuple[str, str]]:
    """Every (arch, shape) cell — 40 total, including skip-marked ones."""
    return [(a, s) for a, arch in ARCHS.items() for s in arch.shapes]


__all__ = ["ARCHS", "get_arch", "all_cells", "ArchDef",
           "LM_SHAPES", "GNN_SHAPES", "RECSYS_SHAPES",
           "LMShape", "GNNShape", "RecSysShape"]
