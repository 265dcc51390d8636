"""EmbeddingBag: gather + bag reduce over a (V, D) table."""
