"""two-tower-retrieval [Yi et al., RecSys'19 (YouTube)]: embed_dim 256,
tower MLPs 1024-512-256, dot interaction, sampled softmax with logQ
correction. The same configs as ``repro.configs.two_tower_retrieval``;
the port serves ``CONFIG`` on one card with bf16 tables
(``repro_torch.launch.serve.serving_config``)."""
from repro_torch.configs.base import ArchDef
from repro_torch.models.recsys import TwoTowerConfig

CONFIG = TwoTowerConfig(
    embed_dim=256, tower_mlp=(1024, 512, 256),
    user_vocab=50_331_648, item_vocab=50_331_648,
    user_fields=8, item_fields=4, field_slots=8,
)

SMOKE_CONFIG = TwoTowerConfig(
    embed_dim=16, tower_mlp=(32, 16),
    user_vocab=4096, item_vocab=4096,
    user_fields=4, item_fields=2, field_slots=4,
)

ARCH = ArchDef("two-tower-retrieval", "recsys", CONFIG, SMOKE_CONFIG,
               source="RecSys'19 (YouTube); unverified")
