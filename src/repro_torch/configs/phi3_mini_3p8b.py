"""phi3-mini-3.8b [arXiv:2404.14219]: 32L d3072 32H (kv=32 ⇒ MHA) ff8192
v32064, RoPE+SwiGLU. Pure full attention → long_500k skipped. The same
configs as ``repro.configs.phi3_mini_3p8b``."""
from repro_torch.configs.base import ArchDef
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="phi3-mini-3.8b", n_layers=32, d_model=3072, n_heads=32,
    n_kv_heads=32, head_dim=96, d_ff=8192, vocab=32064, act="silu",
    rope_theta=10000.0,
)

SMOKE_CONFIG = LMConfig(
    name="phi3-smoke", n_layers=3, d_model=48, n_heads=4, n_kv_heads=4,
    head_dim=12, d_ff=96, vocab=128, act="silu", dtype="float32",
)

ARCH = ArchDef(
    "phi3-mini-3.8b", "lm", CONFIG, SMOKE_CONFIG,
    source="arXiv:2404.14219; unverified",
    skip_shapes={"long_500k": "pure full attention (no sub-quadratic path); "
                              "skip per assignment rule, see DESIGN.md §4"},
)
