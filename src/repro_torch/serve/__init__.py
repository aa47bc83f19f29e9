"""Serving substrate of the port.

Engines and their runtime live here:

* ``engine`` — continuous-batching LM inference (slot management, prefill /
  decode scheduling, sampling) over ``repro_torch.models``;
* ``factorized`` — the multi-tenant factorized *training* service: queued
  train/score/cofactor/aggregate requests from many tenants against one
  shared ``Store``, coalesced into shared traversals on the card and
  served from immutable catalog snapshots (see
  ``repro_torch.serve.factorized``);
* ``runtime`` — the concurrent front-end for the factorized service
  (drain worker + background fold thread, typed failures, retry
  policies);
* ``faults`` — the deterministic seeded fault-injection harness
  (``FaultInjector``) the robustness suite drives the service with.
"""

from . import engine, factorized, faults, runtime
from .engine import Engine, Request, Result, ServeConfig
from .factorized import (
    FactorizedService,
    ScoreResult,
    TenantStats,
    Ticket,
    TrainResult,
)
from .faults import FaultInjector, InjectedFault, TransientInjectedFault
from .runtime import (
    RetryPolicy,
    RuntimeConfig,
    ServiceError,
    ServiceOverloaded,
    ServiceRuntime,
    ServiceStopped,
    ServiceTimeout,
    TransientFault,
)

__all__ = [
    "Engine",
    "FactorizedService",
    "FaultInjector",
    "InjectedFault",
    "Request",
    "Result",
    "RetryPolicy",
    "RuntimeConfig",
    "ScoreResult",
    "ServeConfig",
    "ServiceError",
    "ServiceOverloaded",
    "ServiceRuntime",
    "ServiceStopped",
    "ServiceTimeout",
    "TenantStats",
    "Ticket",
    "TrainResult",
    "TransientFault",
    "TransientInjectedFault",
    "engine",
    "factorized",
    "faults",
    "runtime",
]
