"""Multi-tenant factorized training service: one shared store, coalesced
aggregate traversals, snapshot-isolated reads.

The paper's 100x comes from sharing aggregate work *within* one training
run; AC/DC (Abo Khamis et al. 2018) shares it within one optimization
batch.  This layer shares it across **concurrent tenants**: requests
(train / score / cofactor / aggregate) from different clients against one
:class:`repro_torch.core.store.Store` queue up, and each drain cycle

1. groups queued reads by (variable-order signature, backend, dtype,
   device),
2. coalesces every group with :func:`repro_torch.core.factorize.merge_batches` —
   feature lists union, same-GROUP-BY queries dedupe at the max degree —
   into ONE ``run_batch`` traversal per group,
3. scatters the shared blocks back per request
   (:func:`repro_torch.core.factorize.scatter_results`: pure slicing, Prop. 4.1
   projection commutativity), then finishes each request's own
   post-processing (closed-form solve for train, SSE quadratic form for
   score),
4. applies queued ``append`` writes and publishes a fresh
   :class:`repro_torch.core.store.StoreSnapshot` for the next cycle,
5. optionally folds the store's pending-delta log during the idle window
   (``flush_policy``), so the next cycle's readers find warm caches.

Streaming ingest: under the store's default lazy maintenance, step 4 is
O(delta) per write — appends push onto the pending-delta log and return,
bounding write latency regardless of cache population.  The folding work
moves to step 5 (``flush_policy="idle"``, the default: fold when no reads
remain queued; ``"always"``: fold every cycle; ``"never"``: leave folding
to the next reader's engine-construction barrier) and is charged to the
tenants whose writes queued the deltas.

Isolation: every read in a cycle runs against the cycle's frozen snapshot
— the store's copy-on-write mutation discipline means a write landing
between (or during) cycles can never change what an admitted reader
observes.  Reads admitted in the same cycle as a write therefore see the
pre-write catalog; the write is visible from the next cycle on (snapshot
isolation with writes serialized between read windows).  Draining pending
deltas folds caches without changing data, so it never invalidates the
published snapshot.

Accounting: shared traversals are attributed back to tenants with an exact
integer fair-split (first-come remainder), so per-tenant ``passes`` /
``node_visits`` / view-cache counters in :meth:`FactorizedService.cache_info`
**sum to the store-level totals exactly** — the audit the multi-tenant
story is held to in tests.  Reads are charged the *store-level* counter
deltas of their group (traversal plus any read-barrier fold their engine
triggered); idle-window folds are charged to the writers.

Device: the service's reads run on the torch engine on ``device``
(``"cuda"`` unless the caller asks for ``device="cpu"``) unless the service
or the request names ``backend="numpy"``, the float64 host oracle.  A
service whose reads would run on a CUDA device that is not there raises
when it is constructed, not at its first read (where the engine's error
would be caught by the window bisection and become a failed ticket).
Nothing moves a read onto the host behind the caller's back, and a
non-transient error (a CUDA error among them) is never retried.

Fault tolerance (see also ``repro_torch.serve.runtime``):

* **Threaded front-end** — :meth:`FactorizedService.start` spawns a drain
  worker plus a low-priority background fold thread;
  :meth:`FactorizedService.stop` resolves or fails every in-flight
  ticket before returning.  Two locks split the scheduler: ``_lock``
  guards the admission queues (held briefly by submitters and the
  cycle's pop), ``_cycle_lock`` serializes whole drain cycles / flushes
  / introspection (lock order: cycle before queue, never the reverse).
* **Deadlines & backpressure** — requests carry optional deadlines
  (expired ones fail with ``ServiceTimeout`` at admission to a cycle,
  without touching the rest of their window); ``max_queue`` bounds
  admission with ``block`` / ``reject`` / ``shed_oldest`` policies.
* **Graceful degradation** — when a merged traversal raises, the window
  is bisected until the poisoned request is isolated: it alone fails
  (and is quarantined in ``cache_info()['quarantined']``), every other
  rider re-runs and gets its answer.  With a ``RetryPolicy``, transient
  faults requeue the lone request with a backoff stamp instead of
  failing it.
* **Fold failures** — an idle-window fold that raises is absorbed (the
  store's drain exception safety already invalidated the covered
  entries and cleared the logs); readers recompute from the merged
  catalog, which mutates only at append time and is never corrupted by
  a failed fold.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.factorize import (
    AggregateBlock,
    AggregateQuery,
    BatchPart,
    Cofactors,
    FactorizedEngine,
    merge_batches,
    scatter_results,
)
from ..core.gd import solve_cofactor
from ..core.relation import Relation
from ..core.scaling import compute_scale_factors, rescale_theta
from ..core.store import Store, StoreSnapshot
from ..core.variable_order import VariableOrder
from .runtime import (
    RetryPolicy,
    RuntimeConfig,
    ServiceOverloaded,
    ServiceRuntime,
    ServiceStopped,
    ServiceTimeout,
)

__all__ = [
    "FactorizedService",
    "ScoreResult",
    "TenantStats",
    "Ticket",
    "TrainResult",
]


@dataclasses.dataclass
class TenantStats:
    """Per-tenant share of the store's cumulative counters.

    Shared coalesced traversals are split across the participating
    requests with an exact integer fair-split, so summing any field over
    all tenants reproduces the store-level total for that field.
    """

    requests: int = 0  # read requests served
    appends: int = 0  # writes applied
    batches: int = 0  # coalesced traversals this tenant rode in
    failures: int = 0  # tickets failed (fault, deadline, shutdown, shed)
    retries: int = 0  # transient-fault requeues under the retry policy
    passes: int = 0
    node_visits: int = 0
    vc_hits: int = 0
    vc_misses: int = 0
    vc_bytes: int = 0  # net view-cache byte growth attributed


@dataclasses.dataclass
class TrainResult:
    """Closed-form ridge fit from coalesced cofactors (θ in original
    units, ordered [intercept, features..., −1 on the label])."""

    theta: np.ndarray
    theta_conv: np.ndarray
    features: List[str]
    label: str

    def predict(self, x: np.ndarray) -> np.ndarray:
        return self.theta[0] + x @ self.theta[1 : 1 + x.shape[1]]


@dataclasses.dataclass
class ScoreResult:
    """SSE of a θ vector over the (factorized) join, via the quadratic
    form aᵀCa with a = [θ₀, θ_feats..., −1] — no data rescan."""

    sse: float
    count: float

    @property
    def mse(self) -> float:
        return self.sse / self.count if self.count else float("nan")

    @property
    def rmse(self) -> float:
        return float(np.sqrt(self.mse))


class Ticket:
    """Handle for a queued request: resolved by a drain cycle.

    ``result(timeout=None)`` semantics:

    * resolved → return the value (or raise the recorded error);
    * ``timeout`` given → wait up to that many seconds, then raise
      :class:`~repro_torch.serve.runtime.ServiceTimeout`;
    * no timeout, service running threaded → wait until resolved (the
      runtime's shutdown protocol guarantees resolution — no ticket is
      ever wedged);
    * no timeout, synchronous service → raise ``RuntimeError``
      immediately (waiting would deadlock: nothing else will drain).
    """

    __slots__ = ("_done", "_value", "_error", "_event", "_blocking")

    def __init__(self) -> None:
        self._done = False
        self._value = None
        self._error: Optional[BaseException] = None
        self._event = threading.Event()
        self._blocking = False  # True once a runtime thread owns draining

    @property
    def done(self) -> bool:
        return self._done

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until resolved (or ``timeout`` elapses); True if done."""
        return self._event.wait(timeout)

    def result(self, timeout: Optional[float] = None):
        if not self._done:
            if timeout is not None:
                if not self._event.wait(timeout):
                    raise ServiceTimeout(
                        f"request not served within {timeout:g}s"
                    )
            elif self._blocking:
                self._event.wait()
            else:
                raise RuntimeError(
                    "request not served yet — call FactorizedService."
                    "drain() or run()"
                )
        if self._error is not None:
            raise self._error
        return self._value

    def _resolve(self, value) -> None:
        if self._done:
            return
        self._value = value
        self._done = True
        self._event.set()

    def _fail(self, err: BaseException) -> None:
        if self._done:
            return
        self._error = err
        self._done = True
        self._event.set()


@dataclasses.dataclass
class _Read:
    tenant: str
    kind: str  # "cofactors" | "aggregates" | "train" | "score"
    vorder: VariableOrder
    features: Tuple[str, ...]  # the tenant's requested feature order
    queries: Tuple[AggregateQuery, ...]
    backend: str
    ticket: Ticket
    seq: int  # admission order, the BatchPart rid
    label: Optional[str] = None
    theta: Optional[np.ndarray] = None
    ridge: float = 0.006
    dtype: Optional[object] = None
    device: Optional[str] = None  # the torch engine's device (None: numpy)
    deadline: Optional[float] = None  # absolute time.monotonic()
    not_before: float = 0.0  # retry backoff stamp (monotonic)
    attempts: int = 0  # failed attempts so far


@dataclasses.dataclass
class _Write:
    tenant: str
    name: str
    delta: Relation
    ticket: Ticket
    seq: int


def _dtype_name(dtype) -> Optional[str]:
    """A torch or numpy dtype's name (``"float32"``), None for the default."""
    if dtype is None:
        return None
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


def _fair_split(total: int, k: int) -> List[int]:
    """Split an integer across k shares exactly: earlier shares absorb the
    remainder, sum(result) == total (negatives split symmetrically)."""
    if k <= 0:
        return []
    if total < 0:
        return [-s for s in _fair_split(-total, k)]
    base, rem = divmod(total, k)
    return [base + (1 if i < rem else 0) for i in range(k)]


class FactorizedService:
    """Queue-and-drain scheduler over one shared :class:`Store`.

    ``coalesce=False`` runs the same admission/snapshot machinery but
    gives every request its own engine and traversal — the fair baseline
    the coalescing win is measured against.
    ``window`` caps how many queued reads one drain cycle admits
    (``None`` = drain everything queued at entry).  ``flush_policy``
    schedules the store's pending-delta folds: ``"idle"`` (default) folds
    at the end of a cycle that leaves no reads queued, ``"always"`` folds
    every cycle that applied writes, ``"never"`` leaves folding to the
    read barrier of the next engine construction.

    ``backend`` / ``device`` name the engine reads run on by default:
    the torch engine (float32 unless a request names a ``dtype``) on
    ``"cuda"``; ``device="cpu"`` runs it on the host, and
    ``backend="numpy"`` is the float64 host oracle.  A request may name its
    own ``backend``; a torch request runs on the service's ``device``.

    Robustness knobs (all optional; defaults preserve the synchronous
    behavior):

    ``max_queue`` bounds total queued requests; when full, admission
    follows ``backpressure``: ``"block"`` waits for capacity (up to
    ``admission_timeout`` seconds, then ``ServiceOverloaded``; ``None``
    waits forever — only sensible with the threaded runtime),
    ``"reject"`` raises ``ServiceOverloaded`` at submit, and
    ``"shed_oldest"`` fails the oldest queued *read*'s ticket to make
    room (queued writes are never shed — data loss is worse than
    latency).  ``retry`` is a :class:`~repro_torch.serve.runtime.RetryPolicy`
    applied to transient read faults.  ``default_deadline`` (seconds)
    applies to reads submitted without an explicit deadline.

    ``start()`` / ``stop()`` attach the threaded runtime
    (:class:`~repro_torch.serve.runtime.ServiceRuntime`): a drain worker plus
    a background fold thread; ``stop()`` resolves or fails every
    in-flight ticket — no ticket is ever left unresolved.
    """

    def __init__(
        self,
        store: Store,
        coalesce: bool = True,
        backend: str = "torch",
        window: Optional[int] = None,
        flush_policy: str = "idle",
        max_queue: Optional[int] = None,
        backpressure: str = "block",
        admission_timeout: Optional[float] = 30.0,
        retry: Optional[RetryPolicy] = None,
        default_deadline: Optional[float] = None,
        device="cuda",
    ) -> None:
        if backend not in ("torch", "numpy"):
            raise ValueError(f"unknown backend {backend!r}")
        device = torch.device(device)
        if (
            backend == "torch"
            and device.type == "cuda"
            and not torch.cuda.is_available()
        ):
            raise RuntimeError(
                "FactorizedService runs on device='cuda' by default and no "
                "CUDA device is available; pass device='cpu' or "
                "backend='numpy' to serve from the host"
            )
        if flush_policy not in ("idle", "always", "never"):
            raise ValueError(f"unknown flush_policy {flush_policy!r}")
        if backpressure not in ("block", "reject", "shed_oldest"):
            raise ValueError(f"unknown backpressure {backpressure!r}")
        self.store = store
        self.coalesce = coalesce
        self.backend = backend
        self.device = device
        self.window = window
        self.flush_policy = flush_policy
        self.max_queue = max_queue
        self.backpressure = backpressure
        self.admission_timeout = admission_timeout
        self.retry = retry
        self.default_deadline = default_deadline
        self._snapshot: StoreSnapshot = store.snapshot()
        self._reads: Deque[_Read] = deque()
        self._writes: Deque[_Write] = deque()
        self._tenants: Dict[str, TenantStats] = {}
        self._seq = 0
        self._batches = 0  # coalesced traversals run
        self._coalesced_requests = 0  # reads that shared a traversal
        self._writers_since_flush: List[str] = []  # fold-cost attribution
        # queue lock: admission queues + seq + runtime handle.  Held for
        # O(1) critical sections only; condition variable for "block".
        self._lock = threading.Lock()
        self._not_full = threading.Condition(self._lock)
        # cycle lock: serializes drain cycles, flushes, shutdown sweeps,
        # and cache_info() snapshots.  Held across traversals.  Lock
        # order is ALWAYS cycle -> queue.
        self._cycle_lock = threading.RLock()
        # leaf lock for per-tenant counter mutation: taken by drain-side
        # charging AND submitter-side shed accounting; nothing else is
        # ever acquired while holding it.
        self._stats_lock = threading.RLock()
        self._runtime: Optional[ServiceRuntime] = None
        self._accepting = True
        self._quarantined: Deque[Dict[str, object]] = deque(maxlen=64)
        self._retries = 0  # transient-fault requeues (service-wide)
        self._shed = 0  # tickets failed by shed_oldest backpressure
        self._fold_failures = 0  # idle-window folds that raised
        # sanitizer seam (see Store.access_hook): when set, called as
        # hook("FactorizedService._reads", kind) at queue/stats touches.
        self.access_hook: Optional[Callable[[str, str], None]] = None

    # -- request submission ----------------------------------------------------
    def cofactors(
        self,
        tenant: str,
        vorder: VariableOrder,
        features: Sequence[str],
        backend: Optional[str] = None,
        dtype=None,
        deadline: Optional[float] = None,
    ) -> Ticket:
        """Queue an unscaled-cofactors request → ``Cofactors``.
        ``deadline`` (here and on every read submitter) is seconds from
        now; a request still queued when it expires fails with
        ``ServiceTimeout`` instead of running."""
        return self._submit_read(
            tenant,
            "cofactors",
            vorder,
            tuple(features),
            (AggregateQuery("cof", (), 2),),
            backend,
            deadline,
            dtype=dtype,
        )

    def aggregates(
        self,
        tenant: str,
        vorder: VariableOrder,
        features: Sequence[str],
        queries: Sequence[AggregateQuery],
        backend: Optional[str] = None,
        dtype=None,
        deadline: Optional[float] = None,
    ) -> Ticket:
        """Queue a raw aggregate batch → ``{name: AggregateBlock}``."""
        return self._submit_read(
            tenant,
            "aggregates",
            vorder,
            tuple(features),
            tuple(queries),
            backend,
            deadline,
            dtype=dtype,
        )

    def train(
        self,
        tenant: str,
        vorder: VariableOrder,
        features: Sequence[str],
        label: str,
        ridge: float = 0.006,
        backend: Optional[str] = None,
        deadline: Optional[float] = None,
    ) -> Ticket:
        """Queue a closed-form ridge train → ``TrainResult`` (semantics of
        ``linear_regression(..., VERSIONS['closed'], use_cache=True)``:
        unscaled cofactors, lazy §4.2 rescale, exact θ₀ recovery)."""
        return self._submit_read(
            tenant,
            "train",
            vorder,
            tuple(features) + (label,),
            (AggregateQuery("cof", (), 2),),
            backend,
            deadline,
            label=label,
            ridge=ridge,
        )

    def score(
        self,
        tenant: str,
        vorder: VariableOrder,
        features: Sequence[str],
        label: str,
        theta: np.ndarray,
        backend: Optional[str] = None,
        deadline: Optional[float] = None,
    ) -> Ticket:
        """Queue an SSE evaluation of ``theta`` (original units, as
        returned by :meth:`train`) → ``ScoreResult``."""
        return self._submit_read(
            tenant,
            "score",
            vorder,
            tuple(features) + (label,),
            (AggregateQuery("cof", (), 2),),
            backend,
            deadline,
            label=label,
            theta=np.asarray(theta, dtype=np.float64),
        )

    def append(self, tenant: str, name: str, delta: Relation) -> Ticket:
        """Queue a row append, applied after the current read window →
        the merged ``Relation``.  Visible to reads from the next cycle."""
        with self._lock:
            self._admit()
            self._access("FactorizedService._writes", "write")
            ticket = Ticket()
            ticket._blocking = self._runtime is not None
            self._writes.append(
                _Write(tenant, name, delta, ticket, self._next_seq())
            )
        self._notify()
        return ticket

    def _submit_read(
        self,
        tenant: str,
        kind: str,
        vorder: VariableOrder,
        features: Tuple[str, ...],
        queries: Tuple[AggregateQuery, ...],
        backend: Optional[str],
        deadline: Optional[float],
        **extra,
    ) -> Ticket:
        if deadline is None:
            deadline = self.default_deadline
        abs_deadline = (
            time.monotonic() + deadline if deadline is not None else None
        )
        backend = backend or self.backend
        device = str(self.device) if backend == "torch" else None
        with self._lock:
            self._admit()
            self._access("FactorizedService._reads", "write")
            ticket = Ticket()
            ticket._blocking = self._runtime is not None
            self._reads.append(
                _Read(
                    tenant=tenant,
                    kind=kind,
                    vorder=vorder,
                    features=features,
                    queries=queries,
                    backend=backend,
                    ticket=ticket,
                    seq=self._next_seq(),
                    deadline=abs_deadline,
                    device=device,
                    **extra,
                )
            )
        self._notify()
        return ticket

    def _admit(self) -> None:
        """Admission control (``self._lock`` held): refuse after stop,
        then apply the backpressure policy while the queue is full."""
        if not self._accepting:
            raise ServiceStopped(
                "service stopped — not accepting new requests"
            )
        if self.max_queue is None:
            return
        start = time.monotonic()
        while len(self._reads) + len(self._writes) >= self.max_queue:
            if self.backpressure == "reject":
                raise ServiceOverloaded(
                    f"admission queue full ({self.max_queue})"
                )
            if self.backpressure == "shed_oldest":
                if not self._reads:
                    # only writes queued: never shed data — refuse instead
                    raise ServiceOverloaded(
                        f"admission queue full ({self.max_queue}) with "
                        "writes only — refusing to shed"
                    )
                self._access("FactorizedService._reads", "write")
                victim = self._reads.popleft()
                victim.ticket._fail(
                    ServiceOverloaded("shed under backpressure")
                )
                self._shed += 1
                with self._stats_lock:
                    self._stats(victim.tenant).failures += 1
                continue
            # "block": wait for a cycle to pop the queues
            remaining = None
            if self.admission_timeout is not None:
                remaining = self.admission_timeout - (
                    time.monotonic() - start
                )
                if remaining <= 0:
                    raise ServiceOverloaded(
                        "admission blocked longer than "
                        f"{self.admission_timeout:g}s"
                    )
            self._not_full.wait(remaining)
            if not self._accepting:
                raise ServiceStopped(
                    "service stopped — not accepting new requests"
                )

    def _notify(self) -> None:
        # lockcheck: lock-free pointer read of _runtime is the design —
        # stop() nulls it under the lock, a stale non-None wakes an already
        # stopping runtime harmlessly.
        rt = self._runtime
        if rt is not None:
            rt.notify()

    def _access(self, field: str, kind: str) -> None:
        """Sanitizer seam twin of ``Store._access`` (no-op uninstalled)."""
        hook = self.access_hook
        if hook is not None:
            hook(field, kind)

    def _next_seq(self) -> int:
        self._access("FactorizedService._seq", "write")
        self._seq += 1
        return self._seq

    def _stats(self, tenant: str) -> TenantStats:
        with self._stats_lock:
            self._access("FactorizedService._tenants", "write")
            st = self._tenants.get(tenant)
            if st is None:
                st = self._tenants[tenant] = TenantStats()
            return st

    # -- drain cycle -----------------------------------------------------------
    def drain(self) -> int:
        """Serve one cycle: a window of queued reads against the current
        snapshot (coalesced per engine group), then all queued writes,
        then publish a fresh snapshot.  Returns requests completed.
        Thread-safe: cycles are serialized, the queue lock is held only
        while popping the window."""
        with self._cycle_lock:
            return self._drain_cycle()

    def _drain_cycle(self) -> int:
        now = time.monotonic()
        expired: List[_Read] = []
        reads: List[_Read] = []
        with self._lock:
            self._access("FactorizedService._reads", "write")
            self._access("FactorizedService._writes", "write")
            take = len(self._reads) if self.window is None else self.window
            deferred: List[_Read] = []
            while self._reads and len(reads) < take:
                r = self._reads.popleft()
                if r.deadline is not None and now >= r.deadline:
                    expired.append(r)
                elif r.not_before > now:
                    deferred.append(r)  # retry backoff not elapsed yet
                else:
                    reads.append(r)
            # deferred retries keep their queue position, in order
            for r in reversed(deferred):
                self._reads.appendleft(r)
            writes = list(self._writes)
            self._writes.clear()
            self._not_full.notify_all()

        done = 0
        # an expired deadline fails ITS ticket only — the rest of the
        # window runs untouched
        for r in expired:
            self._fail_read(
                r,
                ServiceTimeout(
                    f"deadline expired before service (tenant {r.tenant!r})"
                ),
                quarantine=False,
            )
            done += 1
        # engine group = everything one traversal can legally share
        groups: Dict[tuple, List[_Read]] = {}
        for r in reads:
            gkey = (
                r.vorder.signature(), r.backend, _dtype_name(r.dtype), r.device
            )
            groups.setdefault(gkey, []).append(r)
        for members in groups.values():
            batches = (
                [members] if self.coalesce else [[r] for r in members]
            )
            for batch in batches:
                done += self._run_batch_group(batch)

        for w in writes:
            self._apply_write(w)
            done += 1
        if writes:
            self._access("FactorizedService._snapshot", "write")
            self._snapshot = self.store.snapshot()
        with self._lock:
            idle = not self._reads
        if self._writers_since_flush and (
            self.flush_policy == "always"
            or (self.flush_policy == "idle" and idle)
        ):
            self._flush_pending()
        return done

    def pending(self) -> int:
        """Queued (unserved) requests right now — reads plus writes."""
        with self._lock:
            return len(self._reads) + len(self._writes)

    def fold_debt_rows(self) -> int:
        """Pending delta rows in the store's log — the background fold
        thread's should-I-run probe (0 for stores without a log)."""
        log = getattr(self.store, "_delta_log", None)
        return log.debt()[1] if log is not None else 0

    def run(self) -> int:
        """Drain until both queues are empty; returns requests completed.
        Waits out retry backoffs (a cycle that completes nothing while
        work is queued means every queued read is a deferred retry)."""
        total = 0
        while self.pending():
            n = self.drain()
            total += n
            if n == 0:
                time.sleep(0.001)
        return total

    def flush(self) -> Dict[str, int]:
        """Fold the store's pending-delta log NOW (between drain cycles) —
        the explicit idle-window pass, also what the background fold
        thread calls.  Returns the store's drain stats; fold cost is
        charged to the writers whose appends queued the deltas."""
        with self._cycle_lock:
            return self._flush_pending()

    # -- threaded runtime ------------------------------------------------------
    def start(
        self, config: Optional[RuntimeConfig] = None
    ) -> "FactorizedService":
        """Attach the threaded runtime: a drain worker serving queued
        requests as they arrive plus a low-priority fold thread servicing
        delta-log debt in idle windows.  Returns ``self`` (chainable)."""
        with self._lock:
            if self._runtime is not None:
                raise RuntimeError("service already started")
            self._accepting = True
            rt = self._runtime = ServiceRuntime(self, config)
        rt.start()
        return self

    def stop(self, drain: bool = True, timeout: Optional[float] = None):
        """Clean shutdown.  Stops admission immediately; with
        ``drain=True`` (default) serves what is already queued within
        ``timeout`` seconds (runtime default 30).  ANY request still
        queued afterwards — drain disabled, budget exhausted, or retries
        still deferred — fails with ``ServiceStopped``.  Every ticket
        ever admitted is resolved or failed when this returns.  Safe to
        call on a never-started service (drains synchronously)."""
        with self._lock:
            self._accepting = False
            rt = self._runtime
            self._runtime = None
            # unblock submitters parked on backpressure so they see the
            # stop instead of waiting out their admission timeout
            self._not_full.notify_all()
        if rt is not None:
            rt.stop(drain=drain, timeout=timeout)
            if rt.errors:
                # Under the cycle lock like every other quarantine write: a
                # drain cycle the runtime failed to join could still be
                # appending bisection results.
                with self._cycle_lock:
                    for err in rt.errors:
                        self._quarantined.append(
                            {"kind": "runtime", "error": repr(err)}
                        )
        elif drain:
            self.run()
        self._fail_pending(
            ServiceStopped("service stopped before the request was served")
        )

    @property
    def running(self) -> bool:
        return self._runtime is not None

    def _fail_pending(self, err: Exception) -> None:
        """Fail every queued request (shutdown sweep).  Takes the cycle
        lock so it cannot race an in-flight cycle's window."""
        with self._cycle_lock:
            with self._lock:
                self._access("FactorizedService._reads", "write")
                self._access("FactorizedService._writes", "write")
                items = list(self._reads) + list(self._writes)
                self._reads.clear()
                self._writes.clear()
                self._not_full.notify_all()
            for it in items:
                it.ticket._fail(err)
                with self._stats_lock:
                    self._stats(it.tenant).failures += 1

    # -- internals -------------------------------------------------------------
    def _run_batch_group(self, batch: List[_Read]) -> int:
        parts = [
            BatchPart(rid=r.seq, features=r.features, queries=r.queries)
            for r in batch
        ]
        # charge by store-level counter deltas, captured BEFORE engine
        # construction: the engine's init is the lazy read barrier and may
        # fold pending deltas, work that lands in store counters only.
        store = self.store
        vc = store.view_cache
        before = (store.passes, store.node_visits, vc.hits, vc.misses, vc.bytes)
        tenants = [r.tenant for r in batch]
        self._access("FactorizedService._snapshot", "read")
        try:
            merged = merge_batches(parts)
            first = batch[0]
            engine = FactorizedEngine(
                self._snapshot,
                first.vorder,
                merged.features,
                backend=first.backend,
                dtype=first.dtype,
                device=first.device or "cpu",  # numpy engines ignore it
            )
            results = engine.run_batch(merged.queries)
            per_rid = scatter_results(merged, parts, results)
        except Exception as err:
            # whatever partial work happened is still real store work —
            # charge it to this sub-batch before degrading
            self._charge_store_delta(tenants, before)
            if len(batch) > 1:
                # graceful degradation: bisect the window to isolate the
                # poisoned request — its co-riders must still get answers
                mid = len(batch) // 2
                return self._run_batch_group(
                    batch[:mid]
                ) + self._run_batch_group(batch[mid:])
            return self._fail_or_retry(batch[0], err)
        self._charge_store_delta(tenants, before)
        if len(batch) > 1:
            self._batches += 1
            self._coalesced_requests += len(batch)
        for r in batch:
            with self._stats_lock:
                st = self._stats(r.tenant)
                st.requests += 1
                st.batches += 1
            try:
                r.ticket._resolve(self._finish(r, per_rid[r.seq]))
            except Exception as err:
                # per-request post-processing (solve/score) failed: the
                # traversal was healthy, so no bisect/retry — just fail
                self._fail_read(r, err, quarantine=False)
        return len(batch)

    def _fail_or_retry(self, r: _Read, err: BaseException) -> int:
        """A single isolated request failed.  Transient fault + retry
        policy + deadline headroom → requeue with a backoff stamp (counts
        as 0 completed); otherwise fail + quarantine the request."""
        policy = self.retry
        now = time.monotonic()
        if (
            policy is not None
            and isinstance(err, policy.retry_on)
            and r.attempts + 1 < policy.max_attempts
            and (r.deadline is None or now < r.deadline)
        ):
            r.attempts += 1
            r.not_before = now + policy.delay(r.attempts)
            with self._stats_lock:
                self._stats(r.tenant).retries += 1
            self._retries += 1
            with self._lock:
                self._reads.append(r)
            self._notify()
            return 0
        self._fail_read(r, err, quarantine=True)
        return 1

    def _fail_read(
        self, r: _Read, err: BaseException, quarantine: bool
    ) -> None:
        r.ticket._fail(err)
        with self._stats_lock:
            self._stats(r.tenant).failures += 1
        if quarantine:
            self._quarantined.append(
                {
                    "kind": r.kind,
                    "tenant": r.tenant,
                    "seq": r.seq,
                    "attempts": r.attempts + 1,
                    "error": repr(err),
                }
            )

    def _flush_pending(self) -> Dict[str, int]:
        """Fold pending deltas, charging the fold across the writers that
        queued them (all known tenants as fallback).  Runs under the
        cycle lock — called from inside a cycle or the public
        :meth:`flush`.

        A fold that raises is absorbed here: the store's drain exception
        safety has already invalidated the covered entries and cleared
        the logs, so the catalog stays correct and the next reader
        recomputes cold.  The failure is surfaced via
        ``cache_info()['fold_failures']`` and the quarantine log."""
        store = self.store
        flush = getattr(store, "flush", None)
        if not callable(flush):
            self._writers_since_flush.clear()
            return {"relations": 0, "rows": 0, "appends": 0}
        payers = list(self._writers_since_flush)
        if not payers:
            with self._stats_lock:  # _tenants is stats-lock state
                payers = sorted(self._tenants)
        vc = store.view_cache
        before = (store.passes, store.node_visits, vc.hits, vc.misses, vc.bytes)
        try:
            stats = flush()
        except Exception as err:
            self._fold_failures += 1
            self._quarantined.append(
                {"kind": "fold", "tenants": payers, "error": repr(err)}
            )
            stats = {"relations": 0, "rows": 0, "appends": 0}
        if payers:
            self._charge_store_delta(payers, before)
        self._writers_since_flush.clear()
        return stats

    def _charge_store_delta(
        self, tenants: List[str], before: Tuple[int, int, int, int, int]
    ) -> None:
        """Fair-split the store-level counter growth since ``before``
        across ``tenants``."""
        store = self.store
        vc = store.view_cache
        self._charge(
            tenants,
            passes=store.passes - before[0],
            node_visits=store.node_visits - before[1],
            vc_hits=vc.hits - before[2],
            vc_misses=vc.misses - before[3],
            vc_bytes=vc.bytes - before[4],
        )

    def _charge(self, tenants: List[str], **counters: int) -> None:
        """Attribute one shared traversal's counters across its riders —
        exact integer fair-split in admission order, so per-tenant sums
        equal the store-level deltas to the unit."""
        k = len(tenants)
        with self._stats_lock:
            for field, total in counters.items():
                for tenant, share in zip(tenants, _fair_split(int(total), k)):
                    st = self._stats(tenant)
                    setattr(st, field, getattr(st, field) + share)

    def _finish(self, r: _Read, blocks: Dict[str, AggregateBlock]):
        if r.kind == "aggregates":
            return blocks
        blk = blocks["cof"]
        if blk.num_groups != 1:
            raise AssertionError(
                f"root view must have exactly one row, got {blk.num_groups}"
            )
        cof = Cofactors(
            count=float(blk.count[0]),
            lin=np.asarray(blk.lin[0], dtype=np.float64),
            quad=np.asarray(blk.quad[0], dtype=np.float64),
            features=list(r.features),
        )
        if r.kind == "cofactors":
            return cof
        feats = [f for f in r.features if f != r.label]
        if r.kind == "score":
            a = r.theta
            if a.shape[0] != len(r.features) + 1:
                raise ValueError(
                    f"theta has {a.shape[0]} entries, expected "
                    f"{len(r.features) + 1} ([intercept] + features + label)"
                )
            mat = cof.matrix()
            return ScoreResult(sse=float(a @ mat @ a), count=cof.count)
        # train: the warm-retrain semantics of linear_regression(
        # VERSIONS["closed"], use_cache=True) — unscaled cofactors +
        # lazy rescale + closed-form solve + exact θ₀ recovery.
        factors = compute_scale_factors(self._snapshot, feats, r.label)
        theta_conv = solve_cofactor(
            cof.rescale(factors).matrix(), ridge=r.ridge
        )
        theta = rescale_theta(theta_conv, factors, mode="exact")
        return TrainResult(
            theta=theta,
            theta_conv=theta_conv,
            features=feats,
            label=r.label,
        )

    def _apply_write(self, w: _Write) -> None:
        store = self.store
        vc = store.view_cache
        before = (store.passes, store.node_visits, vc.hits, vc.misses, vc.bytes)
        failed = None
        try:
            merged = store.append(w.name, w.delta)
        except Exception as err:
            failed = err
            w.ticket._fail(err)
        else:
            w.ticket._resolve(merged)
            # lazy maintenance: this tenant's delta may now be pending —
            # remember who to charge when the idle-window fold runs
            self._writers_since_flush.append(w.tenant)
        with self._stats_lock:
            st = self._stats(w.tenant)
            st.appends += 1
            if failed is not None:
                st.failures += 1
            # delta maintenance ran on the writer's behalf — attribute it
            # whole
            st.passes += store.passes - before[0]
            st.node_visits += store.node_visits - before[1]
            st.vc_hits += vc.hits - before[2]
            st.vc_misses += vc.misses - before[3]
            st.vc_bytes += vc.bytes - before[4]

    # -- introspection ---------------------------------------------------------
    def cache_info(self) -> Dict[str, object]:
        """Store-level ``cache_info`` plus the service's per-tenant shares
        (``tenants[name]`` sums to the store totals), coalescing counters,
        and robustness counters.  Snapshot-under-lock: taken between
        cycles (cycle lock), so store totals and per-tenant shares are
        mutually consistent even while worker threads run."""
        with self._cycle_lock:
            info: Dict[str, object] = dict(self.store.cache_info())
            with self._stats_lock:
                info["tenants"] = {
                    name: dataclasses.asdict(st)
                    for name, st in sorted(self._tenants.items())
                }
            info["coalesced_batches"] = self._batches
            info["coalesced_requests"] = self._coalesced_requests
            with self._lock:
                self._access("FactorizedService._reads", "read")
                info["queued_reads"] = len(self._reads)
                info["queued_writes"] = len(self._writes)
            info["running"] = self.running
            info["retries"] = self._retries
            info["shed"] = self._shed
            info["fold_failures"] = self._fold_failures
            info["quarantined"] = len(self._quarantined)
            return info

    def quarantined(self) -> List[Dict[str, object]]:
        """Recent quarantine records (poisoned requests isolated by the
        window bisection, failed folds, runtime errors) — newest last."""
        with self._cycle_lock:
            return list(self._quarantined)
