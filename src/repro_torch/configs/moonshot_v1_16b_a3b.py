"""moonshot-v1-16b-a3b [hf:moonshotai/Moonlight-16B-A3B]: 48L d2048 16H
(kv=16) v163840, MoE 64 experts top-6, expert ff 1408. Pure full attention
→ long_500k skipped. The same configs as
``repro.configs.moonshot_v1_16b_a3b``; ``CONFIG`` (bf16, 28,057,995,264
params = 56.12 GB) fits one 80 GB card."""
from repro_torch.configs.base import ArchDef
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="moonshot-v1-16b-a3b", n_layers=48, d_model=2048, n_heads=16,
    n_kv_heads=16, head_dim=128, d_ff=1408, vocab=163840, act="silu",
    rope_theta=50000.0,
    moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408),
)

SMOKE_CONFIG = LMConfig(
    name="moonshot-smoke", n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
    head_dim=16, d_ff=64, vocab=256, act="silu", dtype="float32",
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=64),
)

ARCH = ArchDef(
    "moonshot-v1-16b-a3b", "lm", CONFIG, SMOKE_CONFIG,
    source="hf:moonshotai/Moonlight-16B-A3B; hf",
    skip_shapes={"long_500k": "pure full attention (no sub-quadratic path); "
                              "skip per assignment rule, see DESIGN.md §4"},
)
