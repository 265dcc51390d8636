"""Public surface of the port: the streaming session, its serving tier
and multi-lane sweeps."""
from repro_torch.api.partitioner import Partitioner, PreparedChunk
from repro_torch.api.serve import PartitionService, RouteResult
from repro_torch.api.sweep import Sweep
from repro_torch.runtime.sweep import SweepResult, SweepRun

__all__ = ["Partitioner", "PartitionService", "PreparedChunk",
           "RouteResult", "Sweep", "SweepResult", "SweepRun"]
