"""Declared concurrency contracts for ``src/repro_torch``.

This module is the single source of truth shared by the static checker
(`repro_torch.analysis.lockcheck`, `repro_torch.analysis.cow`) and the dynamic lockset
sanitizer (`repro_torch.analysis.sanitizer`).  It declares:

* the **lock hierarchy** — which locks exist, whether they are reentrant,
  and the partial order in which they may be nested;
* the **guarded-by map** — which attributes are protected by which lock,
  and whether the protection covers writes only (copy-on-write fields whose
  readers are deliberately lock-free) or reads *and* writes;
* the **COW discipline** — which catalog maps are strictly replace-only
  (never mutated in place) and which dataclass types are replace-only
  (fields never reassigned after construction);
* **entry contracts** — helper methods that are only ever called with a
  lock already held, so the checker can reason intraprocedurally.

Everything here is plain data (stdlib only): the static checker must run in
a bare-Python CI job with no numpy/torch installed.

The port's own lock
-------------------
Besides the six locks of the service and the store, the port has one
module-level lock: ``kernels/_build.py``'s ``_load_lock``, taken by
``_build.function`` around the first build and load of a CUDA library.  A
kernel's first use can happen on the service's drain worker inside a cycle,
with ``FactorizedService._cycle_lock`` and ``Store._mutate_lock`` held, so
both may nest it.  It is a leaf: ``function`` takes nothing under it (it
runs ``nvcc`` and ``ctypes.CDLL`` only).  ``ViewCache._mu`` never nests it:
the view cache stores and drops views and launches no kernel.  A bare
``with _load_lock:`` resolves to this lock because its attribute name is
unique among the declared locks.  The map it guards, ``_build._libs``, is
a module global, which the attribute-based guard map cannot name: it is
written only under the lock and read without it first (double-checked;
a dict read is atomic under the GIL, and a library once in the map stays).

Launch counters
---------------
Each kernel wrapper counts its launches with ``launches[kernel] += 1`` on a
module dict (``kernels/segment_view.py``, ``segment_gram.py``,
``moments.py``, ``gram.py``, ``flash.py``).  The static pass sees only
attribute accesses, so these counts are not in ``GUARDS``.  Within a
``FactorizedService`` every launch happens under
``FactorizedService._cycle_lock``: reads run in ``drain`` and folds in
``flush`` (both take it), and ``submit_*`` only queues.  So the counts of
a service run are exact.  A caller that drives engines or the store from
several threads of its own holds no declared lock around a launch: the
``+=`` is a read-modify-write that can lose a count there.  The counters
are diagnostics (the smoke test zeroes and reads them around one
single-driver run) and never feed a result.

Differences from the reference's declarations
---------------------------------------------
Each name below is checked against the port's classes by the tests.  The
reference declares three names that exist in neither package; the port
declares what the code has instead:

* ``GuardSpec("_fds", ...)`` lists ``StoreSnapshot`` as an owner, but a
  snapshot holds the FD map as ``_fds_map`` and never writes it after
  ``__init__``: the port's owners are ``("Store",)``.
* ``METHOD_ACQUIRES`` names ``ViewCache.invalidate`` and
  ``ViewCache.delta_update``.  The view cache's methods are
  ``invalidate_relation`` (the ``put`` rule) and ``replace`` (the delta
  fold's in-place swap); both take ``ViewCache._mu``.

Suppressions
------------
A source line (or the line directly above it) containing the tag
``lockcheck:`` suppresses all findings anchored to that line.  The text
after the tag is the human-readable justification; suppressions without a
reason are themselves reported.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Mapping, Tuple

SUPPRESS_TAG = "lockcheck:"


# --------------------------------------------------------------------------
# Locks
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class LockSpec:
    """One named lock in the hierarchy.

    ``name`` is the canonical ``Class.attr`` identifier used everywhere
    (contracts, findings, sanitizer reports).  ``reentrant`` distinguishes
    ``RLock`` (self-nesting allowed) from plain ``Lock``/``Condition`` base
    locks (self-nesting is a guaranteed deadlock and is reported).
    """

    name: str
    owner: str
    attr: str
    reentrant: bool
    doc: str = ""


LOCKS: Tuple[LockSpec, ...] = (
    LockSpec(
        "FactorizedService._cycle_lock",
        "FactorizedService",
        "_cycle_lock",
        reentrant=True,
        doc="Serializes drain cycles, folds and batch-group execution.",
    ),
    LockSpec(
        "FactorizedService._lock",
        "FactorizedService",
        "_lock",
        reentrant=False,
        doc="Queue lock: admission, sequencing, backpressure condition base.",
    ),
    LockSpec(
        "FactorizedService._stats_lock",
        "FactorizedService",
        "_stats_lock",
        reentrant=True,
        doc="Per-tenant counter map; leaf lock, nothing acquired under it.",
    ),
    LockSpec(
        "Store._mutate_lock",
        "Store",
        "_mutate_lock",
        reentrant=True,
        doc="Catalog mutation lock (put/append/fold/FD churn).",
    ),
    LockSpec(
        "ViewCache._mu",
        "ViewCache",
        "_mu",
        reentrant=True,
        doc="View-cache entry map + byte/hit accounting.",
    ),
    LockSpec(
        "_AttrDict._mu",
        "_AttrDict",
        "_mu",
        reentrant=False,
        doc="Per-attribute dictionary extension lock (append-only encodings).",
    ),
    LockSpec(
        "kernels._build._load_lock",
        "kernels._build",
        "_load_lock",
        reentrant=False,
        doc="Module-level: first build and load of a CUDA library; leaf.",
    ),
)

LOCKS_BY_NAME: Dict[str, LockSpec] = {spec.name: spec for spec in LOCKS}

#: Condition variables and the lock they are built over.  Acquiring the
#: condition (``with self._not_full``) IS acquiring the base lock; waiting on
#: it releases only the base lock, so waiting while holding anything else
#: wedges every other holder of that second lock.
CONDITIONS: Dict[str, str] = {
    "FactorizedService._not_full": "FactorizedService._lock",
}

#: Direct edges of the allowed nesting partial order: ``A -> (B, ...)`` means
#: B may be acquired while A is held.  The checker works with the transitive
#: closure; anything not reachable is an ordering violation.
ORDER: Dict[str, Tuple[str, ...]] = {
    "FactorizedService._cycle_lock": (
        "FactorizedService._lock",
        "FactorizedService._stats_lock",
        "Store._mutate_lock",
        "kernels._build._load_lock",
    ),
    "FactorizedService._lock": ("FactorizedService._stats_lock",),
    "Store._mutate_lock": (
        "ViewCache._mu", "_AttrDict._mu", "kernels._build._load_lock",
    ),
    "FactorizedService._stats_lock": (),
    "ViewCache._mu": (),
    "_AttrDict._mu": (),
    "kernels._build._load_lock": (),
}


# --------------------------------------------------------------------------
# Guarded-by map
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class GuardSpec:
    """One attribute protected by a lock.

    ``policy`` is ``"write"`` for copy-on-write / monotonic fields whose
    readers are deliberately lock-free (only unlocked *writes* are
    violations), ``"full"`` for fields where unlocked reads are races too,
    and ``"memo"`` for idempotent lock-free memo maps (snapshots alias and
    fill them concurrently by design): statically a ``memo`` write still
    needs the lock or an explicit ``# lockcheck:`` suppression, but the
    dynamic sanitizer ignores the field entirely — its empty lockset is the
    documented design, not a race.  ``owners`` lists the classes whose
    ``self.<attr>`` is covered;
    accesses through a non-``self`` receiver match by attribute name alone
    (the guarded names below are unique within ``src/repro_torch`` by design).
    """

    attr: str
    lock: str
    policy: str  # "write" | "full"
    owners: Tuple[str, ...]
    doc: str = ""


GUARDS: Tuple[GuardSpec, ...] = (
    # --- Store catalog (COW: lock-free readers see immutable values) ---
    GuardSpec("_relations", "Store._mutate_lock", "write",
              ("Store", "StoreSnapshot"),
              "Relation catalog; replace-only (see COW_REPLACE_ONLY)."),
    GuardSpec("_fds", "Store._mutate_lock", "write", ("Store",),
              "FD catalog; replace-only (see COW_REPLACE_ONLY)."),
    GuardSpec("_moments", "Store._mutate_lock", "memo",
              ("Store", "StoreSnapshot"),
              "Column-moment memo; snapshot fills are lost-or-correct."),
    GuardSpec("_enc_cols", "Store._mutate_lock", "memo",
              ("Store", "StoreSnapshot"),
              "Per-(relation, attr) encoded-id memo; ids deterministic "
              "from append-only dictionaries."),
    GuardSpec("_rel_versions", "Store._mutate_lock", "write", ("Store",),
              "Per-relation fold watermarks (aliased as ViewCache.watermarks)."),
    GuardSpec("_cofactor_cache", "Store._mutate_lock", "full", ("Store",),
              "Keyed cofactor entries: mutated in place, reads need the lock."),
    GuardSpec("_cat_cache", "Store._mutate_lock", "full", ("Store",),
              "Keyed categorical-cofactor entries."),
    GuardSpec("_red_cache", "Store._mutate_lock", "write", ("Store",),
              "FD-reduction plan memo (snapshots keep their own copy)."),
    GuardSpec("_vorders", "Store._mutate_lock", "write", ("Store",),
              "Traversal variable-order registry."),
    GuardSpec("_dicts", "Store._mutate_lock", "write", ("Store",),
              "Append-only attribute dictionaries (created double-checked)."),
    GuardSpec("_delta_log", "Store._mutate_lock", "write", ("Store",),
              "Pending-delta log; lock-free debt() probe reads are fine."),
    GuardSpec("_fd_version", "Store._mutate_lock", "write", ("Store",),
              "FD-catalog generation counter."),
    GuardSpec("_override_enc", "Store._mutate_lock", "write", ("Store",),
              "Temporary encoding override during drains."),
    GuardSpec("_draining", "Store._mutate_lock", "full", ("Store",),
              "Reentrancy latch for _drain_all."),
    # --- FactorizedService queues / runtime state ---
    GuardSpec("_reads", "FactorizedService._lock", "full", ("FactorizedService",),
              "Pending read-request deque."),
    GuardSpec("_writes", "FactorizedService._lock", "full", ("FactorizedService",),
              "Pending write-request deque."),
    GuardSpec("_seq", "FactorizedService._lock", "full", ("FactorizedService",),
              "Admission sequence counter."),
    GuardSpec("_accepting", "FactorizedService._lock", "full", ("FactorizedService",),
              "Admission gate flag."),
    GuardSpec("_runtime", "FactorizedService._lock", "write", ("FactorizedService",),
              "Runtime handle; lock-free pointer reads are fine."),
    GuardSpec("_shed", "FactorizedService._lock", "write", ("FactorizedService",),
              "Shed-oldest counter; read in cache_info without the lock."),
    GuardSpec("_tenants", "FactorizedService._stats_lock", "full",
              ("FactorizedService",), "Per-tenant counter map."),
    GuardSpec("_snapshot", "FactorizedService._cycle_lock", "full",
              ("FactorizedService",), "Current read snapshot for the cycle."),
    GuardSpec("_writers_since_flush", "FactorizedService._cycle_lock", "full",
              ("FactorizedService",), "Tenants charged for the next fold."),
    GuardSpec("_batches", "FactorizedService._cycle_lock", "write",
              ("FactorizedService",), "Coalescing counters."),
    GuardSpec("_coalesced_requests", "FactorizedService._cycle_lock", "write",
              ("FactorizedService",), "Coalescing counters."),
    GuardSpec("_quarantined", "FactorizedService._cycle_lock", "write",
              ("FactorizedService",), "Poisoned-request log."),
    GuardSpec("_retries", "FactorizedService._cycle_lock", "write",
              ("FactorizedService",), "Retry counter."),
    GuardSpec("_fold_failures", "FactorizedService._cycle_lock", "write",
              ("FactorizedService",), "Failed-fold counter."),
    # --- ViewCache ---
    GuardSpec("_entries", "ViewCache._mu", "full", ("ViewCache",),
              "LRU entry map."),
    GuardSpec("hits", "ViewCache._mu", "write", ("ViewCache",),
              "Hit counter; lock-free reads via cache_info snapshots."),
    GuardSpec("misses", "ViewCache._mu", "write", ("ViewCache",),
              "Miss counter."),
    GuardSpec("evictions", "ViewCache._mu", "write", ("ViewCache",),
              "Eviction counter."),
    # --- _AttrDict (append-only encodings) ---
    GuardSpec("_sorted_vals", "_AttrDict._mu", "write", ("_AttrDict",),
              "Sorted value snapshot for binary search."),
    GuardSpec("_sorted_ids", "_AttrDict._mu", "write", ("_AttrDict",),
              "Ids aligned with _sorted_vals."),
)

GUARDS_BY_ATTR: Dict[str, GuardSpec] = {g.attr: g for g in GUARDS}

#: ``Class.attr`` -> GuardSpec, the canonical field names the sanitizer's
#: access probes report against.
GUARDS_BY_FIELD: Dict[str, GuardSpec] = {
    f"{owner}.{g.attr}": g for g in GUARDS for owner in g.owners
}

#: Constructors (and constructor-like scopes) where guarded attributes may be
#: freely initialised: ``self.x = ...`` before the object is shared is not a
#: race.  Matched by bare function name within any class.
CONSTRUCTOR_SCOPES: FrozenSet[str] = frozenset({"__init__", "__post_init__"})

#: Scopes (``Class.method``) whitelisted to read guarded parent state without
#: the guard: snapshot constructors capture COW maps by reference, which is
#: exactly the pattern the snapshot design blesses.
SNAPSHOT_SCOPES: FrozenSet[str] = frozenset({
    "StoreSnapshot.__init__",
    "Store.snapshot",
})


# --------------------------------------------------------------------------
# Entry contracts + call-edge hints
# --------------------------------------------------------------------------

#: ``Class.method`` -> locks held on entry.  These helpers are only ever
#: called from regions that already hold the named lock(s); the checker
#: verifies their bodies *given* the contract and verifies lexically visible
#: call sites acquire before calling.
ENTRY_HELD: Dict[str, Tuple[str, ...]] = {
    # Store helpers invoked from @_locked methods / explicit with-blocks.
    "Store._drain_all": ("Store._mutate_lock",),
    "Store._fold_relation": ("Store._mutate_lock",),
    "Store._maintain_view_cache": ("Store._mutate_lock",),
    "Store._delta_cofactors": ("Store._mutate_lock",),
    "Store._delta_cat_cofactors": ("Store._mutate_lock",),
    "Store._invalidate": ("Store._mutate_lock",),
    "Store._invalidate_fd_entries": ("Store._mutate_lock",),
    "Store._plan_fd_updates": ("Store._mutate_lock",),
    "Store._bump_fds": ("Store._mutate_lock",),
    "Store._slice_rows": ("Store._mutate_lock",),
    "Store._should_compact": ("Store._mutate_lock",),
    "Store._compact": ("Store._mutate_lock",),
    "Store._entry_current": ("Store._mutate_lock",),
    # Service helpers invoked from the drain cycle (cycle lock held) or the
    # admission path (queue lock held).
    "FactorizedService._admit": ("FactorizedService._lock",),
    "FactorizedService._next_seq": ("FactorizedService._lock",),
    "FactorizedService._drain_cycle": ("FactorizedService._cycle_lock",),
    "FactorizedService._run_batch_group": ("FactorizedService._cycle_lock",),
    "FactorizedService._fail_or_retry": ("FactorizedService._cycle_lock",),
    "FactorizedService._fail_read": ("FactorizedService._cycle_lock",),
    "FactorizedService._flush_pending": ("FactorizedService._cycle_lock",),
    "FactorizedService._charge_store_delta": ("FactorizedService._cycle_lock",),
    "FactorizedService._finish": ("FactorizedService._cycle_lock",),
    "FactorizedService._apply_write": ("FactorizedService._cycle_lock",),
}

#: Methods that *acquire* a lock internally, for call-edge inference: calling
#: one of these while holding lock H adds edge H -> acquired lock.  The
#: static pass also discovers acquisitions lexically; this map resolves
#: cross-class calls through receiver hints below.
METHOD_ACQUIRES: Dict[str, Tuple[str, ...]] = {
    "Store.put": ("Store._mutate_lock",),
    "Store.append": ("Store._mutate_lock",),
    "Store.flush": ("Store._mutate_lock",),
    "Store.add_fd": ("Store._mutate_lock",),
    "Store.infer_fds": ("Store._mutate_lock",),
    "Store.drop_fd": ("Store._mutate_lock",),
    "Store.cofactors": ("Store._mutate_lock",),
    "Store.cat_cofactors": ("Store._mutate_lock",),
    "FactorizedService._stats": ("FactorizedService._stats_lock",),
    "ViewCache.get": ("ViewCache._mu",),
    "ViewCache.put": ("ViewCache._mu",),
    "ViewCache.invalidate_relation": ("ViewCache._mu",),
    "ViewCache.restamp": ("ViewCache._mu",),
    "ViewCache.replace": ("ViewCache._mu",),
    "_AttrDict.extend_encode": ("_AttrDict._mu",),
}

#: Receiver-name hints for resolving ``<recv>.method(...)`` to a class when
#: the receiver is not ``self``.  Keys are dotted receiver expressions as
#: rendered by the checker (``self.store`` or bare names).
RECEIVER_CLASS_HINTS: Dict[str, str] = {
    "self.store": "Store",
    "self._store": "Store",
    "store": "Store",
    "self.view_cache": "ViewCache",
    "view_cache": "ViewCache",
    "vc": "ViewCache",
    "self._vc": "ViewCache",
    "svc": "FactorizedService",
    "service": "FactorizedService",
    "self.service": "FactorizedService",
    "self._service": "FactorizedService",
}


# --------------------------------------------------------------------------
# COW discipline
# --------------------------------------------------------------------------

#: Attributes holding strictly replace-only catalog maps: every mutation must
#: build a new dict and swap the reference; in-place ``d[k] = ``, ``del``,
#: ``.update``/``.pop``/``.setdefault``/``.clear`` are violations anywhere,
#: locked or not (snapshots alias these maps by reference).
COW_REPLACE_ONLY: FrozenSet[str] = frozenset({"_relations", "_fds"})

#: Replace-only dataclass fields: ``obj.field = ...`` after construction must
#: go through ``dataclasses.replace`` instead.  ``FunctionalDependency`` is a
#: plain dataclass shared by reference across snapshots; the frozen config
#: types would raise at runtime but are caught statically too.
FROZEN_FIELDS: Dict[str, Tuple[str, ...]] = {
    "FunctionalDependency": ("lhs", "rhs", "mapping", "source"),
    "RetryPolicy": ("max_attempts", "backoff", "multiplier", "max_backoff",
                    "retry_on"),
    "RuntimeConfig": ("poll_interval", "fold_interval", "fold_min_rows",
                      "drain_timeout"),
}

#: Method names that mutate their receiver in place when called on a guarded
#: or replace-only container.
MUTATOR_METHODS: FrozenSet[str] = frozenset({
    "append", "appendleft", "extend", "extendleft", "insert", "remove",
    "pop", "popleft", "popitem", "clear", "update", "setdefault",
    "add", "discard", "record", "sort",
})


@dataclass(frozen=True)
class Contracts:
    """Bundle handed to the checker/sanitizer; defaults to the repo contracts.

    Tests construct alternate bundles for fixture modules.
    """

    locks: Tuple[LockSpec, ...] = LOCKS
    conditions: Mapping[str, str] = field(default_factory=lambda: CONDITIONS)
    order: Mapping[str, Tuple[str, ...]] = field(default_factory=lambda: ORDER)
    guards: Tuple[GuardSpec, ...] = GUARDS
    entry_held: Mapping[str, Tuple[str, ...]] = field(
        default_factory=lambda: ENTRY_HELD)
    method_acquires: Mapping[str, Tuple[str, ...]] = field(
        default_factory=lambda: METHOD_ACQUIRES)
    receiver_hints: Mapping[str, str] = field(
        default_factory=lambda: RECEIVER_CLASS_HINTS)
    cow_replace_only: FrozenSet[str] = COW_REPLACE_ONLY
    frozen_fields: Mapping[str, Tuple[str, ...]] = field(
        default_factory=lambda: FROZEN_FIELDS)
    constructor_scopes: FrozenSet[str] = CONSTRUCTOR_SCOPES
    snapshot_scopes: FrozenSet[str] = SNAPSHOT_SCOPES

    def lock_names(self) -> FrozenSet[str]:
        return frozenset(spec.name for spec in self.locks)

    def lock_by_attr(self) -> Dict[str, Tuple[LockSpec, ...]]:
        """Lock attribute name -> specs sharing it (usually one)."""
        out: Dict[str, list] = {}
        for spec in self.locks:
            out.setdefault(spec.attr, []).append(spec)
        return {attr: tuple(specs) for attr, specs in out.items()}

    def closure(self) -> Dict[str, FrozenSet[str]]:
        closure: Dict[str, set] = {
            name: set(nbrs) for name, nbrs in self.order.items()
        }
        for spec in self.locks:
            closure.setdefault(spec.name, set())
        changed = True
        while changed:
            changed = False
            for reach in closure.values():
                for nxt in tuple(reach):
                    extra = closure.get(nxt, set()) - reach
                    if extra:
                        reach.update(extra)
                        changed = True
        return {name: frozenset(reach) for name, reach in closure.items()}

    def guards_by_attr(self) -> Dict[str, GuardSpec]:
        return {g.attr: g for g in self.guards}

    def reentrant(self, lock_name: str) -> bool:
        spec = LOCKS_BY_NAME.get(lock_name)
        if spec is None:
            for s in self.locks:
                if s.name == lock_name:
                    spec = s
                    break
        return bool(spec and spec.reentrant)


DEFAULT_CONTRACTS = Contracts()


def guard_policy(field_name: str) -> str:
    """Policy for a canonical ``Class.attr`` field name (sanitizer helper)."""
    spec = GUARDS_BY_FIELD.get(field_name)
    return spec.policy if spec is not None else "full"


def guard_lock(field_name: str) -> str:
    spec = GUARDS_BY_FIELD.get(field_name)
    return spec.lock if spec is not None else ""
