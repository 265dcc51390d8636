"""Segment SpMM: ELL-padded sparse aggregation (GNN message passing)."""
