"""Online rebalancing between ingest windows: greedy vertex migration and
LPA refinement (the port's copy of ``repro.rebalance``; the per-vertex
label histograms run on the ``partition_affinity`` kernel)."""
from repro_torch.rebalance.passes import (
    RebalanceStats, lpa_pass, migration_pass, rebalance_state,
)

__all__ = ["RebalanceStats", "lpa_pass", "migration_pass",
           "rebalance_state"]
