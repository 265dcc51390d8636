"""Graph substrate of the port: numpy graphs, synthetic datasets, streams
(copies of the JAX package's, byte-identical for the same seed)."""
