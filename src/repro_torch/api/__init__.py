"""Public surface of the port: the streaming session."""
from repro_torch.api.partitioner import Partitioner, PreparedChunk

__all__ = ["Partitioner", "PreparedChunk"]
