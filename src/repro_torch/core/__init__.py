"""Core of the port: config, geometry, RNG, state, transitions, engines."""
