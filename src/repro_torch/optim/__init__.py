"""The port's optimizers (``repro.optim``'s counterpart). The JAX
package's gradient compression (``int8_compress``, ``int8_decompress``,
``compressed_allreduce_grads``, ``init_error_feedback``: a ``psum`` inside
a ``shard_map``) comes with the multi-card training mesh, ROADMAP A18.4."""
from repro_torch.optim.optimizers import (
    Optimizer, adamw, apply_updates, clip_by_global_norm, cosine_schedule,
    linear_warmup_cosine, opt_state_from_jax, sgd_momentum,
)

__all__ = [
    "adamw", "sgd_momentum", "cosine_schedule", "linear_warmup_cosine",
    "clip_by_global_norm", "apply_updates", "Optimizer",
    "opt_state_from_jax",
]
