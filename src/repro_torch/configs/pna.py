"""pna [arXiv:2004.05718]: 4 layers, hidden 75, aggregators
mean/max/min/std, scalers identity/amplification/attenuation.
The same configs as ``repro.configs.pna``."""
from repro_torch.configs.base import ArchDef
from repro_torch.models.gnn.pna import PNAConfig

CONFIG = PNAConfig(n_layers=4, d_hidden=75,
                   aggregators=("mean", "max", "min", "std"),
                   scalers=("identity", "amplification", "attenuation"))

SMOKE_CONFIG = PNAConfig(n_layers=2, d_hidden=16,
                         aggregators=("mean", "max", "min", "std"),
                         scalers=("identity", "amplification", "attenuation"))

ARCH = ArchDef("pna", "gnn", CONFIG, SMOKE_CONFIG,
               source="arXiv:2004.05718; paper",
               gnn_inputs=("feat",))
