"""Eraser-style lockset race sanitizer + runtime lock-order assertions.

Dynamic counterpart of the static checker, sharing the declared contracts
(:mod:`repro_torch.analysis.contracts`).  ``LockSanitizer.install(store=...,
service=...)`` rewires a live ``Store``/``FactorizedService`` pair the same
way ``FaultInjector`` does — by swapping seam attributes, no subclassing:

* every declared lock is replaced with a :class:`SanitizedLock` wrapper
  that keeps a per-thread stack of held locks, asserts the declared
  acquisition order (via the transitive closure of ``contracts.ORDER``) on
  every acquire, and flags re-acquisition of non-reentrant locks;
* the service's backpressure ``Condition`` is rebuilt as a
  :class:`SanitizedCondition` over the wrapped queue lock, recording any
  ``wait()`` entered while the thread holds locks other than the
  condition's own base lock;
* with ``load_lock=True``, the module-level ``_load_lock`` of
  ``repro_torch.kernels._build`` (first build and load of a CUDA library)
  is wrapped too.  It is module state that outlives any store, so
  :meth:`LockSanitizer.uninstall` puts the original back;
* the ``access_hook`` seams on Store / FactorizedService / ViewCache feed a
  simplified Eraser lockset algorithm: for each shared field the sanitizer
  intersects the set of locks held across accesses; once a field has been
  touched by two threads, an empty intersection means no single lock
  consistently protects it — a candidate race.  Fields declared with the
  ``"write"`` policy (copy-on-write / monotonic) only track writes, because
  their lock-free readers are the design, not a bug.

Violations are *recorded*, not raised, so a stress run completes and the
test asserts ``report()`` is empty at the end (raising inside ``acquire``
would itself perturb the schedule under test).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Optional, Tuple

from .contracts import Contracts, DEFAULT_CONTRACTS


@dataclass
class OrderViolation:
    thread: str
    held: Tuple[str, ...]
    acquired: str

    def __str__(self) -> str:
        return (f"[{self.thread}] acquired {self.acquired} while holding "
                f"{', '.join(self.held)}")


@dataclass
class WaitViolation:
    thread: str
    condition: str
    held: Tuple[str, ...]

    def __str__(self) -> str:
        return (f"[{self.thread}] waited on {self.condition} while holding "
                f"{', '.join(self.held)}")


@dataclass
class LocksetReport:
    field: str
    kind: str
    thread: str
    held: Tuple[str, ...]

    def __str__(self) -> str:
        locks = ", ".join(self.held) if self.held else "<none>"
        return (f"{self.field}: lockset went empty on {self.kind} in "
                f"[{self.thread}] (held: {locks})")


@dataclass
class _FieldState:
    """Per-field Eraser state: Virgin -> Exclusive(first thread) -> Shared."""

    first_thread: Optional[int] = None
    shared: bool = False
    lockset: Optional[FrozenSet[str]] = None
    reported: bool = False
    reads: int = 0
    writes: int = 0


class _Held(threading.local):
    def __init__(self) -> None:
        self.stack: List[str] = []


class SanitizedLock:
    """Wraps a ``threading.Lock``/``RLock`` with order + reentrancy checks.

    Only ``acquire``/``release``/``__enter__``/``__exit__`` are defined —
    deliberately **no** ``_release_save``/``_acquire_restore``/``_is_owned``
    — so a ``threading.Condition`` built over the wrapper falls back to its
    portable default implementations, which route through ``acquire`` and
    ``release`` and keep the held-stack bookkeeping correct across
    ``wait()``.
    """

    def __init__(self, sanitizer: "LockSanitizer", name: str,
                 inner) -> None:
        self._san = sanitizer
        self._name = name
        self._inner = inner

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._san._on_acquire(self._name)
        return ok

    def release(self) -> None:
        self._san._on_release(self._name)
        self._inner.release()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<SanitizedLock {self._name} over {self._inner!r}>"


class SanitizedCondition(threading.Condition):
    """``Condition`` over a :class:`SanitizedLock` that audits ``wait()``.

    Waiting releases only the condition's base lock; entering a wait while
    holding anything else wedges every other would-be holder of that lock
    for the full wait.  The base Condition machinery itself works unmodified
    because the wrapped lock exposes only the portable subset (see
    :class:`SanitizedLock`).
    """

    def __init__(self, sanitizer: "LockSanitizer", name: str,
                 lock: SanitizedLock) -> None:
        super().__init__(lock)
        self._san = sanitizer
        self._cond_name = name
        self._base_name = lock._name

    def wait(self, timeout: Optional[float] = None) -> bool:
        held = [h for h in self._san._held.stack if h != self._base_name]
        if held:
            self._san._record_wait(self._cond_name, tuple(held))
        return super().wait(timeout)


class LockSanitizer:
    """Installable lockset race detector for Store + FactorizedService."""

    def __init__(self, contracts: Contracts = DEFAULT_CONTRACTS) -> None:
        self.c = contracts
        self.closure = contracts.closure()
        self._policies: Dict[str, str] = {
            f"{owner}.{g.attr}": g.policy
            for g in contracts.guards for owner in g.owners
        }
        self._held = _Held()
        self._meta = threading.Lock()  # guards everything below
        self._fields: Dict[str, _FieldState] = {}
        self.order_violations: List[OrderViolation] = []
        self.wait_violations: List[WaitViolation] = []
        self.empty_locksets: List[LocksetReport] = []
        self.acquisitions: Dict[str, int] = {}
        self.accesses: int = 0
        self._build = None  # the kernels' build module while wrapped
        self._load_lock = None  # its original lock, put back by uninstall

    # -- installation ------------------------------------------------------

    def install(self, store=None, service=None,
                load_lock: bool = False) -> "LockSanitizer":
        """Swap sanitized wrappers into a live store/service pair.

        Must be called before any worker threads start (the swap itself is
        not atomic).  Wrapping the service also wraps its store unless a
        different one is passed explicitly.  ``load_lock=True`` also wraps
        ``repro_torch.kernels._build._load_lock`` until :meth:`uninstall`.
        """
        if service is not None and store is None:
            store = service.store
        if store is not None:
            self._install_store(store)
        if service is not None:
            self._install_service(service)
        if load_lock and self._build is None:
            from ..kernels import _build

            self._build, self._load_lock = _build, _build._load_lock
            _build._load_lock = SanitizedLock(
                self, "kernels._build._load_lock", _build._load_lock)
        return self

    def uninstall(self) -> None:
        """Put back the module-level state :meth:`install` wrapped (the
        kernels' ``_load_lock``).  A store's or service's wrappers die with
        the object and stay."""
        if self._build is not None:
            self._build._load_lock = self._load_lock
            self._build = self._load_lock = None

    def _install_store(self, store) -> None:
        store._mutate_lock = SanitizedLock(
            self, "Store._mutate_lock", store._mutate_lock)
        store.access_hook = self._access
        vc = getattr(store, "view_cache", None)
        if vc is not None:
            vc._mu = SanitizedLock(self, "ViewCache._mu", vc._mu)
            vc.access_hook = self._access
        # Attribute dictionaries are created lazily on first categorical
        # touch; force them into existence now so their extend locks can be
        # wrapped before threads race on them.
        for rel in store.relations():
            for attr in rel.attributes:
                try:
                    store.attr_encoding(rel.name, attr)
                except (KeyError, TypeError, ValueError):
                    continue  # non-encodable column; no dict to wrap
        for d in store._dicts.values():
            d._mu = SanitizedLock(self, "_AttrDict._mu", d._mu)

    def _install_service(self, service) -> None:
        service._cycle_lock = SanitizedLock(
            self, "FactorizedService._cycle_lock", service._cycle_lock)
        service._stats_lock = SanitizedLock(
            self, "FactorizedService._stats_lock", service._stats_lock)
        service._lock = SanitizedLock(
            self, "FactorizedService._lock", service._lock)
        # Rebuild the backpressure condition over the wrapped queue lock so
        # notify/wait and admission all see one lock identity.
        service._not_full = SanitizedCondition(
            self, "FactorizedService._not_full", service._lock)
        service.access_hook = self._access

    # -- lock bookkeeping --------------------------------------------------

    def _on_acquire(self, name: str) -> None:
        stack = self._held.stack
        reentry = name in stack
        with self._meta:
            self.acquisitions[name] = self.acquisitions.get(name, 0) + 1
            if reentry and not self.c.reentrant(name):
                # A plain Lock would already have deadlocked by now (the
                # inner acquire blocks), so in practice this records the
                # wrapper-level evidence for non-blocking acquires.
                self.order_violations.append(OrderViolation(
                    threading.current_thread().name,
                    tuple(stack), name))
            elif not reentry:
                bad = [h for h in stack
                       if name not in self.closure.get(h, frozenset())]
                if bad:
                    self.order_violations.append(OrderViolation(
                        threading.current_thread().name,
                        tuple(stack), name))
        stack.append(name)

    def _on_release(self, name: str) -> None:
        stack = self._held.stack
        # Release innermost matching entry (reentrant locks stack).
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == name:
                del stack[i]
                break

    def _record_wait(self, cond_name: str, held: Tuple[str, ...]) -> None:
        with self._meta:
            self.wait_violations.append(WaitViolation(
                threading.current_thread().name, cond_name, held))

    # -- Eraser lockset ----------------------------------------------------

    def _access(self, field_name: str, kind: str) -> None:
        """Field-access probe (the ``access_hook`` seam target).

        ``field_name`` is the canonical ``Class.attr`` name; ``kind`` is
        ``"read"`` or ``"write"``.
        """
        policy = self._policy(field_name)
        if policy == "memo":
            return  # idempotent lock-free memo map: empty lockset is design
        if policy == "write" and kind == "read":
            return  # lock-free reads are the declared design for COW fields
        held = frozenset(self._held.stack)
        tid = threading.get_ident()
        with self._meta:
            self.accesses += 1
            st = self._fields.setdefault(field_name, _FieldState())
            if kind == "read":
                st.reads += 1
            else:
                st.writes += 1
            if st.first_thread is None:
                st.first_thread = tid
                st.lockset = held
                return
            if not st.shared and tid == st.first_thread:
                # Still exclusive to the first thread: refresh, don't narrow.
                st.lockset = held
                return
            st.shared = True
            assert st.lockset is not None
            st.lockset = st.lockset & held
            if not st.lockset and not st.reported:
                st.reported = True
                self.empty_locksets.append(LocksetReport(
                    field_name, kind, threading.current_thread().name,
                    tuple(sorted(held))))

    def _policy(self, field_name: str) -> str:
        return self._policies.get(field_name, "full")

    # -- reporting ---------------------------------------------------------

    def report(self) -> List[str]:
        with self._meta:
            return ([str(v) for v in self.order_violations]
                    + [str(v) for v in self.wait_violations]
                    + [str(v) for v in self.empty_locksets])

    def assert_clean(self) -> None:
        problems = self.report()
        if problems:
            raise AssertionError(
                "lock sanitizer found {} problem(s):\n  {}".format(
                    len(problems), "\n  ".join(problems)))

    def field_stats(self) -> Dict[str, Tuple[int, int]]:
        """field -> (reads, writes) seen by the probes (test sanity hook)."""
        with self._meta:
            return {name: (st.reads, st.writes)
                    for name, st in self._fields.items()}
