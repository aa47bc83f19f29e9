"""Concurrency contract checking for the factorized-learning runtime.

Two prongs over one declared contract set (:mod:`repro_torch.analysis.contracts`):

* **Static** — :mod:`repro_torch.analysis.lockcheck` (lock-order / guarded-by /
  condition discipline) and :mod:`repro_torch.analysis.cow` (copy-on-write lint),
  shipped as ``python -m repro_torch.analysis`` with a committed ratchet baseline
  (``analysis_baseline_torch.json``).  Stdlib-only: runs in CI without the
  numeric stack installed.
* **Dynamic** — :mod:`repro_torch.analysis.sanitizer`, an Eraser-style lockset
  race detector plus runtime lock-order assertions, installed into a live
  ``Store``/``FactorizedService`` via the same seam pattern as
  ``FaultInjector`` and wired into the threaded stress tests behind the
  ``sanitize`` pytest marker.
"""

from . import contracts, cow, lockcheck
from .cli import collect, main
from .contracts import Contracts, DEFAULT_CONTRACTS
from .lockcheck import Finding
from .sanitizer import LockSanitizer

__all__ = [
    "Contracts",
    "DEFAULT_CONTRACTS",
    "Finding",
    "LockSanitizer",
    "collect",
    "contracts",
    "cow",
    "lockcheck",
    "main",
]
