"""Deterministic seeded fault injection over the ``StoreReads`` surface.

:class:`FaultInjector` wraps a :class:`repro_torch.core.store.Store` and
is handed to :class:`~repro_torch.serve.factorized.FactorizedService` in
the store's place.  It delegates everything, with three seams armed on
demand:

* **Node-visit faults** — the engine attributes every traversal node to
  the store by incrementing ``node_visits`` (through the snapshot's
  counter-forwarding properties, which is why :meth:`snapshot` wraps the
  injector itself).  The injector's ``node_visits`` setter forwards the
  increment FIRST — counter audits stay exact even for aborted
  traversals — then fires any armed trap: an explicit "raise at the Nth
  visit from now" (:meth:`fail_at_node_visit`) or a seeded per-visit
  hazard with geometrically-distributed gaps
  (:meth:`arm_random_node_faults`, the bench sweep's fault-rate knob).
  The engine increments *before* computing the node's view, so an
  aborted traversal never publishes a partial view.

* **Fold poison** — ``Store.fault_hook`` is called at the top of every
  delta fold (``Store._fold_relation``): :meth:`fail_next_fold` makes
  the Nth upcoming fold raise, exercising the store's drain exception
  safety (covered entries invalidated, logs cleared, error surfaces to
  the reader) on both the lazy drain and eager append paths.

* **Eviction storms** — :meth:`arm_eviction_storms` evicts the ENTIRE
  view cache every Nth snapshot (``ViewCache.evict_all``), forcing cold
  recomputes mid-workload to prove results never depend on cache
  residency.

Faults raise :class:`InjectedFault`; ``transient=True`` (the default)
raises the :class:`TransientInjectedFault` subtype, which derives from
:class:`repro_torch.serve.runtime.TransientFault` so service retry policies
engage.  Every firing is recorded in :attr:`FaultInjector.fired` for
test assertions.  All randomness flows from one seeded generator —
identical arming on an identical workload replays identical faults.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..core.store import Store, StoreSnapshot
from .runtime import TransientFault

__all__ = ["FaultInjector", "InjectedFault", "TransientInjectedFault"]


class InjectedFault(RuntimeError):
    """A fault raised by :class:`FaultInjector` (terminal by default)."""


class TransientInjectedFault(InjectedFault, TransientFault):
    """An injected fault that retry policies are allowed to retry."""


def _raise(transient: bool, msg: str):
    if transient:
        raise TransientInjectedFault(msg)
    raise InjectedFault(msg)


class FaultInjector:
    """Transparent ``StoreReads`` wrapper with armable, seeded faults.

    Use it exactly like the store it wraps::

        store = Store(relations)
        inj = FaultInjector(store, seed=7)
        svc = FactorizedService(inj, retry=RetryPolicy())
        inj.fail_at_node_visit(3)          # third visit from now raises
        inj.arm_random_node_faults(0.01)   # plus a 1% per-visit hazard

    The injector is also valid as a bare engine data source — every
    ``StoreReads`` method resolves via delegation, and ``isinstance(inj,
    StoreReads)`` holds (the protocol is runtime-checkable by method
    presence).
    """

    def __init__(self, store: Store, seed: int = 0) -> None:
        self._store = store
        self._rng = np.random.default_rng(seed)
        self._visit_count = 0
        # explicit one-shot traps: absolute visit thresholds, sorted
        self._visit_traps: List[Tuple[int, bool]] = []
        # seeded hazard: per-visit fault probability + next firing visit
        self._hazard = 0.0
        self._hazard_transient = True
        self._next_hazard_visit: Optional[int] = None
        # fold traps: [countdown, transient], consumed in arming order
        self._fold_traps: List[List[object]] = []
        self._storm_every = 0
        self._snapshots = 0
        #: log of (kind, detail) tuples, one per fired fault
        self.fired: List[Tuple[str, object]] = []
        store.fault_hook = self._fold_hook

    # -- delegation ------------------------------------------------------------
    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, "_store"), name)

    @property
    def store(self) -> Store:
        """The wrapped store (for assertions on the real object)."""
        return self._store

    # -- counter forwarding (the node-visit seam) ------------------------------
    # Explicit data descriptors: plain attribute *assignment* on the
    # injector would otherwise land in the injector's __dict__ instead of
    # the store's, silently forking the counters.
    @property
    def passes(self) -> int:
        return self._store.passes

    @passes.setter
    def passes(self, v: int) -> None:
        self._store.passes = v

    @property
    def cat_passes(self) -> int:
        return self._store.cat_passes

    @cat_passes.setter
    def cat_passes(self, v: int) -> None:
        self._store.cat_passes = v

    @property
    def cat_node_visits(self) -> int:
        return self._store.cat_node_visits

    @cat_node_visits.setter
    def cat_node_visits(self, v: int) -> None:
        self._store.cat_node_visits = v

    @property
    def node_visits(self) -> int:
        return self._store.node_visits

    @node_visits.setter
    def node_visits(self, v: int) -> None:
        delta = v - self._store.node_visits
        self._store.node_visits = v  # forward FIRST: audits stay exact
        if delta > 0:
            self._visit_count += delta
            self._check_visit_traps()

    def _check_visit_traps(self) -> None:
        n = self._visit_count
        if self._visit_traps and n >= self._visit_traps[0][0]:
            _, transient = self._visit_traps.pop(0)
            self.fired.append(("node_visit", n))
            _raise(transient, f"injected node-visit fault at visit {n}")
        if self._next_hazard_visit is not None and n >= self._next_hazard_visit:
            self._schedule_hazard()
            self.fired.append(("node_visit_random", n))
            _raise(
                self._hazard_transient,
                f"injected random node-visit fault at visit {n}",
            )

    def _schedule_hazard(self) -> None:
        if self._hazard > 0.0:
            gap = int(self._rng.geometric(self._hazard))
            self._next_hazard_visit = self._visit_count + gap
        else:
            self._next_hazard_visit = None

    # -- arming ----------------------------------------------------------------
    def fail_at_node_visit(self, n: int, transient: bool = True) -> None:
        """Arm a one-shot fault at the ``n``-th node visit from now."""
        if n < 1:
            raise ValueError("n must be >= 1")
        self._visit_traps.append((self._visit_count + n, transient))
        self._visit_traps.sort()

    def arm_random_node_faults(
        self, rate: float, transient: bool = True
    ) -> None:
        """Arm a seeded per-visit fault hazard (``rate`` in [0, 1)); the
        gaps between firings are geometric, so a replay with the same
        seed and workload faults at the same visits.  ``rate=0``
        disarms."""
        if not 0.0 <= rate < 1.0:
            raise ValueError("rate must be in [0, 1)")
        self._hazard = rate
        self._hazard_transient = transient
        self._schedule_hazard()

    def fail_next_fold(self, nth: int = 1, transient: bool = True) -> None:
        """Arm a fault in the ``nth`` upcoming delta fold (any relation,
        lazy drain or eager append path)."""
        if nth < 1:
            raise ValueError("nth must be >= 1")
        self._fold_traps.append([nth, transient])

    def arm_eviction_storms(self, every_snapshots: int = 1) -> None:
        """Evict the entire view cache every ``every_snapshots``-th
        snapshot (0 disarms) — the cache-pressure fault class."""
        self._storm_every = int(every_snapshots)

    def disarm(self) -> None:
        """Drop every armed fault (the log of fired faults is kept)."""
        self._visit_traps.clear()
        self._hazard = 0.0
        self._next_hazard_visit = None
        self._fold_traps.clear()
        self._storm_every = 0

    # -- seams -----------------------------------------------------------------
    def _fold_hook(self, kind: str, name: str) -> None:
        if not self._fold_traps:
            return
        trap = self._fold_traps[0]
        trap[0] -= 1  # type: ignore[operator]
        if trap[0] <= 0:  # type: ignore[operator]
            self._fold_traps.pop(0)
            self.fired.append(("fold", name))
            _raise(bool(trap[1]), f"injected fold fault on {name!r}")

    def snapshot(self) -> StoreSnapshot:
        """A snapshot whose counter writes route back through the
        injector — this is what puts the node-visit seam on the engine's
        path (engines read/write counters via their snapshot)."""
        self._snapshots += 1
        if self._storm_every and self._snapshots % self._storm_every == 0:
            n = self._store.view_cache.evict_all()
            self.fired.append(("evict_storm", n))
        return StoreSnapshot(self)

    def evict_storm(self) -> int:
        """Evict the whole view cache NOW; returns entries evicted."""
        n = self._store.view_cache.evict_all()
        self.fired.append(("evict_storm", n))
        return n
