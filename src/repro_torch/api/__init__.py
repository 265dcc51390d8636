"""Public surface of the port: the streaming session and its serving
tier."""
from repro_torch.api.partitioner import Partitioner, PreparedChunk
from repro_torch.api.serve import PartitionService, RouteResult

__all__ = ["Partitioner", "PartitionService", "PreparedChunk",
           "RouteResult"]
