"""Models of the port: the two-tower recsys model, the dense and MoE
transformer LMs, and the GNNs (``gnn``)."""
