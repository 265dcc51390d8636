"""Models of the port (the recsys two-tower model so far)."""
