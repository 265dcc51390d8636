"""llama4-scout-17b-a16e [hf:meta-llama/Llama-4-Scout-17B-16E]: 48L d5120
40H (GQA kv=8) v202048, MoE 16 experts top-1, expert ff 8192. Chunked local
attention (8192) with every 4th layer global (iRoPE-style) → runs
long_500k. Multimodal early fusion: the vision frontend is a stub per the
assignment ([vlm] rule); this is the text backbone. The same configs as
``repro.configs.llama4_scout_17b_a16e``; ``CONFIG`` (bf16, 203.5 GB of
params) does not fit one 80 GB card: ``launch.serve`` and
``launch.train`` refuse it with ``--full``."""
from repro_torch.configs.base import ArchDef
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="llama4-scout-17b-a16e", n_layers=48, d_model=5120, n_heads=40,
    n_kv_heads=8, head_dim=128, d_ff=8192, vocab=202048, act="silu",
    rope_theta=500000.0, window_pattern=(8192, 8192, 8192, 0),
    moe=MoEConfig(n_experts=16, top_k=1, d_ff_expert=8192),
)

SMOKE_CONFIG = LMConfig(
    name="llama4-smoke", n_layers=4, d_model=40, n_heads=5, n_kv_heads=1,
    head_dim=8, d_ff=64, vocab=128, act="silu", dtype="float32",
    window_pattern=(8, 8, 8, 0),
    moe=MoEConfig(n_experts=4, top_k=1, d_ff_expert=64),
)

ARCH = ArchDef("llama4-scout-17b-a16e", "lm", CONFIG, SMOKE_CONFIG,
               source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified")
