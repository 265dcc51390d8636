"""Launch entry points of the port (recsys serving so far)."""
