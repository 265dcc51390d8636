"""Batched partition-affinity histogram (paper Eq. 1)."""
