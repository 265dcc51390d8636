"""Arch registry plumbing: every assigned architecture is an ArchDef (the
port's copy of ``repro.configs.base``)."""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.configs.shapes import GNN_SHAPES, LM_SHAPES, RECSYS_SHAPES


@dataclasses.dataclass(frozen=True)
class ArchDef:
    arch_id: str
    family: str                 # 'lm' | 'gnn' | 'recsys'
    config: Any                 # full-size model config (assigned numbers)
    smoke_config: Any           # reduced same-family config for CPU tests
    source: str                 # public citation tag from the assignment
    gnn_inputs: tuple = ()      # ('feat',) and/or ('pos', 'species')
    skip_shapes: dict = dataclasses.field(default_factory=dict)

    @property
    def shapes(self) -> dict:
        return {"lm": LM_SHAPES, "gnn": GNN_SHAPES,
                "recsys": RECSYS_SHAPES}[self.family]

    def runnable_shapes(self) -> list[str]:
        return [s for s in self.shapes if s not in self.skip_shapes]
