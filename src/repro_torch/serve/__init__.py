"""Serving substrate of the port.

* ``engine`` — continuous-batching LM inference (slot management, prefill /
  decode scheduling, sampling) over ``repro_torch.models``.

The factorized training service of the JAX package (``FactorizedService``,
its runtime and fault harness) is not ported yet (ROADMAP queue 1, item 8).
"""

from . import engine
from .engine import Engine, Request, Result, ServeConfig

__all__ = ["Engine", "Request", "Result", "ServeConfig", "engine"]
