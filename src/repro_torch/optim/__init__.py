"""The port's optimizers (``repro.optim``'s counterpart), and the int8
gradient compression with error feedback for the data-parallel
all-reduce over a mesh axis (``compression``)."""
from repro_torch.optim.optimizers import (
    Optimizer, adamw, apply_updates, clip_by_global_norm, cosine_schedule,
    linear_warmup_cosine, opt_state_from_jax, sgd_momentum,
)
from repro_torch.optim.compression import (
    compressed_allreduce_grads, init_error_feedback, int8_compress,
    int8_decompress,
)

__all__ = [
    "adamw", "sgd_momentum", "cosine_schedule", "linear_warmup_cosine",
    "clip_by_global_norm", "apply_updates", "Optimizer",
    "opt_state_from_jax",
    "int8_compress", "int8_decompress", "compressed_allreduce_grads",
    "init_error_feedback",
]
