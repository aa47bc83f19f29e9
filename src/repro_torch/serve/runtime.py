"""Concurrent runtime for :class:`repro_torch.serve.factorized.FactorizedService`.

The service's scheduler is a synchronous ``drain()`` loop; this module
supplies the threads and the failure vocabulary that turn it into a
long-running server:

* :class:`ServiceRuntime` — ``service.start()`` spawns it: a **drain
  worker** that serves queued requests as they arrive (woken by
  submissions, with a polling fallback), and a **low-priority fold
  thread** that services the store's pending-delta debt
  (``DeltaLog.debt``) only in idle windows, so sustained writers get
  warm caches without ever stealing a foreground traversal's cycle.
  ``service.stop()`` runs the clean-shutdown protocol: stop admission,
  optionally drain what's queued within a budget, fail every leftover
  ticket with :class:`ServiceStopped`, join both threads.  No ticket is
  ever left unresolved.

* Typed failures — :class:`ServiceTimeout` (deadline / ``result``
  timeout), :class:`ServiceOverloaded` (bounded-queue backpressure),
  :class:`ServiceStopped` (shutdown), :class:`TransientFault` (the base
  class retry policies act on).  All derive from :class:`ServiceError`.

* :class:`RetryPolicy` — bounded retry with exponential backoff for
  transient faults.  The service requeues a failed request with a
  ``not_before`` stamp instead of sleeping, so retries never block the
  drain worker.

Both threads treat ANY exception escaping a cycle as a runtime bug to
record (``ServiceRuntime.errors``), never as a reason to die: a wedged
worker would strand every future ticket, which is the one invariant this
layer exists to protect.

This module deliberately does not import the service (no cycle): the
runtime drives it through the narrow ``pending()`` / ``drain()`` /
``fold_debt_rows()`` / ``flush()`` surface.  It imports only the standard
library.  With the torch backend the drain worker launches the CUDA
kernels from its own thread, on that thread's current stream.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Optional, Tuple, Type

__all__ = [
    "RetryPolicy",
    "RuntimeConfig",
    "ServiceError",
    "ServiceOverloaded",
    "ServiceRuntime",
    "ServiceStopped",
    "ServiceTimeout",
    "TransientFault",
]


class ServiceError(RuntimeError):
    """Base class of every failure the serving layer itself raises."""


class ServiceTimeout(ServiceError, TimeoutError):
    """A request deadline expired, or ``Ticket.result(timeout=)`` ran out
    of patience before the request was served."""


class ServiceOverloaded(ServiceError):
    """The bounded admission queue rejected or shed a request."""


class ServiceStopped(ServiceError):
    """The service was stopped before (or while) the request was queued."""


class TransientFault(ServiceError):
    """A fault worth retrying: the same request may succeed on a fresh
    attempt (I/O hiccup, poisoned fold already quarantined, injected
    test fault).  Retry policies match on this type by default."""


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry with exponential backoff for transient read faults.

    ``max_attempts`` counts total tries (1 = never retry).  Attempt ``n``
    (1-based retry index) is deferred by ``backoff * multiplier**(n-1)``
    seconds, capped at ``max_backoff``.  Only exceptions matching
    ``retry_on`` are retried; anything else fails the ticket at once.
    """

    max_attempts: int = 3
    backoff: float = 0.01
    multiplier: float = 2.0
    max_backoff: float = 1.0
    retry_on: Tuple[Type[BaseException], ...] = (TransientFault,)

    def delay(self, attempt: int) -> float:
        """Backoff before retry ``attempt`` (1-based)."""
        return min(
            self.backoff * self.multiplier ** max(attempt - 1, 0),
            self.max_backoff,
        )


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Knobs of the threaded front-end.

    ``poll_interval``   drain-worker wake granularity when no submission
                        signal arrives (submissions wake it immediately).
    ``fold_interval``   cadence of the background fold thread's idle
                        probe — NOT a fold rate cap; the thread folds at
                        most once per probe and only when the service has
                        no queued work.
    ``fold_min_rows``   minimum pending delta rows worth a background
                        fold (tiny debts are cheaper to fold at the next
                        read barrier).
    ``drain_timeout``   default budget of ``stop(drain=True)``.
    """

    poll_interval: float = 0.02
    fold_interval: float = 0.05
    fold_min_rows: int = 1
    drain_timeout: float = 30.0


class ServiceRuntime:
    """Drain-worker + background-fold threads around one service."""

    def __init__(self, service, config: Optional[RuntimeConfig] = None):
        self.service = service
        self.config = config or RuntimeConfig()
        self._stop_event = threading.Event()
        self._wake = threading.Event()
        self._drain_thread = threading.Thread(
            target=self._drain_loop, name="factorized-drain", daemon=True
        )
        self._fold_thread = threading.Thread(
            target=self._fold_loop, name="factorized-fold", daemon=True
        )
        #: runtime bugs recorded instead of killing a worker (bounded)
        self.errors: "deque" = deque(maxlen=32)

    def start(self) -> None:
        self._drain_thread.start()
        self._fold_thread.start()

    def notify(self) -> None:
        """Wake the drain worker now (called on every submission)."""
        self._wake.set()

    def _drain_loop(self) -> None:
        svc = self.service
        while not self._stop_event.is_set():
            self._wake.wait(self.config.poll_interval)
            self._wake.clear()
            try:
                while svc.pending() and not self._stop_event.is_set():
                    if svc.drain() == 0:
                        # only deferred retries remain — back off until
                        # their not_before stamps pass
                        break
            except Exception as err:  # pragma: no cover - runtime bug trap
                self.errors.append(err)

    def _fold_loop(self) -> None:
        svc = self.service
        while not self._stop_event.wait(self.config.fold_interval):
            try:
                if svc.pending():
                    continue  # low priority: foreground work goes first
                if svc.fold_debt_rows() >= self.config.fold_min_rows:
                    svc.flush()
            except Exception as err:  # pragma: no cover - runtime bug trap
                self.errors.append(err)

    def stop(self, drain: bool = True, timeout: Optional[float] = None):
        """Shutdown: optionally help drain queued work within the budget,
        then stop and join both threads.  The *service* fails whatever is
        left afterwards — by the time this returns no thread is running,
        so that sweep cannot race a cycle."""
        budget = self.config.drain_timeout if timeout is None else timeout
        if drain:
            deadline = time.monotonic() + budget
            while self.service.pending() and time.monotonic() < deadline:
                # compete with the worker for cycles (drain() serializes
                # internally) so shutdown needn't wait for its poll tick
                if self.service.drain() == 0:
                    time.sleep(0.002)  # deferred retries pending
        self._stop_event.set()
        self._wake.set()
        join_by = time.monotonic() + max(budget, 1.0)
        for t in (self._drain_thread, self._fold_thread):
            if t.is_alive():
                t.join(timeout=max(join_by - time.monotonic(), 0.1))
