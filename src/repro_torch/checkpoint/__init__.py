"""Checkpoints in the JAX package's format: npz payload, MessagePack
metadata, atomic rename (the port's copy of ``repro.checkpoint``)."""
from repro_torch.checkpoint.ckpt import (
    checkpoint_keys, checkpoint_step, restore_pytree, save_pytree,
)
from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["save_pytree", "restore_pytree", "checkpoint_step",
           "checkpoint_keys", "CheckpointManager"]
