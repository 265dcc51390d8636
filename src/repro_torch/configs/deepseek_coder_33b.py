"""deepseek-coder-33b [arXiv:2401.14196]: llama-arch 62L d7168 56H (GQA
kv=8) ff19200 v32256. Pure full attention → long_500k skipped. The same
configs as ``repro.configs.deepseek_coder_33b``."""
from repro_torch.configs.base import ArchDef
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="deepseek-coder-33b", n_layers=62, d_model=7168, n_heads=56,
    n_kv_heads=8, head_dim=128, d_ff=19200, vocab=32256, act="silu",
    rope_theta=100000.0,
)

SMOKE_CONFIG = LMConfig(
    name="deepseek-smoke", n_layers=3, d_model=56, n_heads=7, n_kv_heads=1,
    head_dim=8, d_ff=96, vocab=256, act="silu", dtype="float32",
)

ARCH = ArchDef(
    "deepseek-coder-33b", "lm", CONFIG, SMOKE_CONFIG,
    source="arXiv:2401.14196; hf",
    skip_shapes={"long_500k": "pure full attention (no sub-quadratic path); "
                              "skip per assignment rule, see DESIGN.md §4"},
)
