"""Core of the port: config, geometry, RNG, state, transitions, engines,
and the dict/set oracle of Algorithm 1 (``run_reference``)."""
from repro_torch.core.ref import run_reference

__all__ = ["run_reference"]
