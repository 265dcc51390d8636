"""Launch entry points of the port: serving (LM and recsys) and recsys
training."""
