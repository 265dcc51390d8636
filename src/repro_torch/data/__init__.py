from repro_torch.data.pipeline import (
    graph_full_batch, graph_minibatches, lm_batch, recsys_batches,
    token_batches,
)

__all__ = ["token_batches", "lm_batch", "graph_full_batch",
           "graph_minibatches", "recsys_batches"]
