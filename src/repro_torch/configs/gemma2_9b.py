"""gemma2-9b [arXiv:2408.00118]: 42L d3584 16H (GQA kv=8) ff14336 v256000,
alternating local(4096)/global attention, attn softcap 50, final softcap 30,
GeGLU, tied embeddings. The same configs as ``repro.configs.gemma2_9b``;
``CONFIG`` (bf16, 9,241,404,928 params = 18.48 GB) fits one 80 GB card."""
from repro_torch.configs.base import ArchDef
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="gemma2-9b", n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8,
    head_dim=256, d_ff=14336, vocab=256000, act="gelu",
    attn_softcap=50.0, final_softcap=30.0, window_pattern=(4096, 0),
    tie_embeddings=True, rope_theta=10000.0,
)

SMOKE_CONFIG = LMConfig(
    name="gemma2-smoke", n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
    head_dim=16, d_ff=128, vocab=512, act="gelu",
    attn_softcap=50.0, final_softcap=30.0, window_pattern=(8, 0),
    tie_embeddings=True, dtype="float32",
)

ARCH = ArchDef("gemma2-9b", "lm", CONFIG, SMOKE_CONFIG,
               source="arXiv:2408.00118; hf")
