"""nequip [arXiv:2101.03164]: 5 layers, 32 channels, l_max=2, 8 bessel RBFs,
cutoff 5, E(3)-equivariant tensor products (repro_torch.models.gnn.so3 — CG
coefficients derived from first principles, equivariance property-tested).
The same configs as ``repro.configs.nequip``."""
from repro_torch.configs.base import ArchDef
from repro_torch.models.gnn.nequip import NequIPConfig

CONFIG = NequIPConfig(n_layers=5, channels=32, l_max=2, n_rbf=8, cutoff=5.0)

SMOKE_CONFIG = NequIPConfig(n_layers=2, channels=8, l_max=2, n_rbf=4,
                            cutoff=5.0)

ARCH = ArchDef("nequip", "gnn", CONFIG, SMOKE_CONFIG,
               source="arXiv:2101.03164; paper",
               gnn_inputs=("pos", "species"))
