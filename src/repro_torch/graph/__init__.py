"""Graph substrate of the port: numpy graphs, synthetic datasets, streams,
the fanout sampler and the blocked GNN layout (``halo``) — copies of the
JAX package's, byte-identical for the same seed."""
