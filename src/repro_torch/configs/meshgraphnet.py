"""meshgraphnet [arXiv:2010.03409]: 15 layers, hidden 128, sum aggregation,
2-hidden-layer MLPs. SDP applicability: DIRECT — node partitioning + halo
exchange drive the distributed full-graph layout (DESIGN.md §3).
The same configs as ``repro.configs.meshgraphnet``."""
from repro_torch.configs.base import ArchDef
from repro_torch.models.gnn.meshgraphnet import MGNConfig

CONFIG = MGNConfig(n_layers=15, d_hidden=128, mlp_layers=2, aggregator="sum")

SMOKE_CONFIG = MGNConfig(n_layers=2, d_hidden=16, mlp_layers=2,
                         aggregator="sum", remat=False)

ARCH = ArchDef("meshgraphnet", "gnn", CONFIG, SMOKE_CONFIG,
               source="arXiv:2010.03409; unverified",
               gnn_inputs=("feat", "pos"))
