"""Elastic re-meshing: the paper's §4.2.3 scale-out / scale-in at the
runtime level (the port's copy of ``repro.runtime.elastic``).

SDP adds and removes partitions as load changes; the runtime analogue adds
or removes devices between steps. Checkpoints are host-complete
(``repro_torch.checkpoint``), so a re-scale is: build a new mesh from the
surviving device list → derive the placements from the same rules → place
again. The state is preserved bit for bit; only where it lives changes.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

from repro_torch.checkpoint.ckpt import to_numpy
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.launch.mesh import Mesh, place_tree, tree_map


@dataclasses.dataclass
class ElasticState:
    mesh: Mesh
    params: object
    opt_state: object
    step: int


class ElasticRunner:
    """Owns mesh construction and re-scale transitions.

    ``mesh_factory(devices)`` returns a ``launch.mesh.Mesh`` over exactly
    those devices; ``shardings_fn(mesh, tree)`` returns the matching tree
    of ``launch.mesh.Placement``s (whole on the lead device, or row blocks
    along a named axis).
    """

    def __init__(self, mesh_factory: Callable, shardings_fn: Callable,
                 ckpt: CheckpointManager):
        self.mesh_factory = mesh_factory
        self.shardings_fn = shardings_fn
        self.ckpt = ckpt

    def place(self, devices: Sequence, params, opt_state,
              step: int) -> ElasticState:
        mesh = self.mesh_factory(devices)
        params = place_tree(params, self.shardings_fn(mesh, params))
        opt_state = place_tree(opt_state, self.shardings_fn(mesh, opt_state))
        return ElasticState(mesh, params, opt_state, step)

    def rescale(self, state: ElasticState,
                devices: Sequence) -> ElasticState:
        """Scale to a new device set (grown or shrunk), preserving state.

        Mirrors SDP scale-in: checkpoint (migrate), rebuild the mesh
        (machine set), place under the new placements (reassign load)."""
        # unconditional pre-rescale save: maybe_save is interval-gated and
        # could skip this step, leaving the host copy below as the only
        # migration safety net
        self.ckpt.save_now(state.step, {"params": state.params,
                                        "opt": state.opt_state},
                           blocking=True)
        host = {"params": tree_map(to_numpy, state.params),
                "opt": tree_map(to_numpy, state.opt_state)}
        return self.place(devices, host["params"], host["opt"], state.step)

    def recover(self, devices: Sequence, like_params,
                like_opt) -> ElasticState | None:
        """Crash recovery: restore the latest checkpoint onto a fresh
        mesh."""
        restored, step = self.ckpt.restore(
            {"params": like_params, "opt": like_opt})
        if restored is None:
            return None
        return self.place(devices, restored["params"], restored["opt"],
                          step or 0)
