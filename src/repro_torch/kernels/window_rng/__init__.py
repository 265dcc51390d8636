"""Windows' random draw tables, many tables in one kernel launch."""
