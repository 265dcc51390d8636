"""schnet [arXiv:1706.08566]: 3 interactions, hidden 64, 300 gaussian RBFs,
cutoff 10. Molecular graphs carry positions+species; the large citation/
product graphs use synthetic positions (documented in DESIGN.md §4).
The same configs as ``repro.configs.schnet``."""
from repro_torch.configs.base import ArchDef
from repro_torch.models.gnn.schnet import SchNetConfig

CONFIG = SchNetConfig(n_interactions=3, d_hidden=64, n_rbf=300, cutoff=10.0)

SMOKE_CONFIG = SchNetConfig(n_interactions=2, d_hidden=16, n_rbf=16,
                            cutoff=10.0)

ARCH = ArchDef("schnet", "gnn", CONFIG, SMOKE_CONFIG,
               source="arXiv:1706.08566; paper",
               gnn_inputs=("pos", "species"))
