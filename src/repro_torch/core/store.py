"""The in-memory database: a catalog of relations plus a natural-join planner.

Plays the role HyPer plays in the paper — it *holds* the training data and
executes the factorized aggregate plan close to the data.  ``materialize_join``
is the non-factorized ("noPre") path: it computes the flat natural join whose
size is O(|D|^rho*) and against which factorization is benchmarked.

Incremental cofactor maintenance (AC/DC-style, Abo Khamis et al. 2018):
the store keeps a **cofactor cache** keyed by
``(relations, features, variable-order signature, backend)``.

* ``cofactors(vorder, features)`` — compute-on-miss cached *unscaled*
  cofactors over the factorized join (scaled variants derive lazily via
  ``Cofactors.rescale``, the paper's §4.2 view algebra, so one cache entry
  serves every scaling).
* ``append(name, delta)``  — batch row update, **O(delta)** on the write
  path.  The default ``maintenance="lazy"`` mode validates FDs, concats
  the relation, pushes a metadata-only record onto the per-relation
  :class:`repro_torch.core.delta_log.DeltaLog` and returns — no view-cache or
  cofactor folds happen on the write path, so append latency is
  independent of how many cached entries cover the relation.
  ``maintenance="eager"`` restores the fold-on-write behaviour (useful
  when reads vastly outnumber writes, or when append's all-or-nothing
  exception contract matters).
* **lazy drain** — any read entry point that touches a relation with
  pending deltas (``sufficient_stats`` / ``cofactors`` /
  ``cat_cofactors``, and every ``FactorizedEngine`` construction) first
  calls :meth:`Store.flush`, which folds the *stacked* delta of every
  pending relation into the covering entries in one pass per relation
  (joins distribute over union — ``(R ∪ ΔR) ⋈ S = (R ⋈ S) ∪ (ΔR ⋈ S)``,
  Prop. 4.1 — so however many appends piled up, one fold pays for all).
  With several relations pending, relation i's fold freezes every
  later-pending relation to its pre-append prefix, so the per-relation
  fold terms telescope to exactly the merged-join total.  Past a size
  threshold (``compact_ratio`` / ``compact_rows``) folding a huge stacked
  delta would cost more than recomputing from base, so ``append``
  *compacts* instead: covered entries are invalidated and the log
  cleared.
* ``put(rel)``             — catalog mutation: overwriting a relation
  **invalidates** every cache entry that references it (deltas are unions;
  arbitrary replacement is not).  Entries over unrelated relations survive.
* ``column_moments(col)``  — cached per-column (sum, max|x|, count) over the
  union of relations containing the column, maintained under ``append``
  (sum/count accumulate, max folds — always eager: O(delta) columnar work)
  so feature scaling never rescans the historical data either.

Cache versioning: ``version`` increments on every catalog mutation, and
``_rel_versions[name]`` records the version of the last mutation affecting
relation ``name`` (its *watermark*).  An entry is valid iff its stamp is
``>=`` the watermark of every relation its join covers — so an append
makes exactly the covering entries stale ("stale but foldable": the drain
folds them and restamps at the current version) while entries over
untouched relations stay valid with **no** restamping loop on the write
path.

Below the result-level caches sits the **persistent view cache**
(``repro_torch.core.view_cache``): per-node engine views keyed by
``(vorder signature, node, live subset, degree, backend)``, shared by every
``FactorizedEngine`` constructed over this store.  Where the cofactor
caches answer "have I seen this exact query", the view cache answers "have
I already descended this subtree" — so *different* queries over
overlapping attribute sets (FD on/off, per-attribute sweeps, warm
retrains) skip finished descents.  ``append`` maintains it with
delta-path folds: only views on the appended relation's root path are
touched (each folded with a delta view computed by an engine that itself
reuses the cached sibling views); entries over untouched relations stay
valid under the same watermark rule (``ViewCache.watermarks`` aliases
``_rel_versions``).  ``put`` invalidates exactly the entries covering the
replaced relation.

A cached view keeps its group-key columns on the host (numpy int32 ids,
like every structural column of the engine) and its value blocks where the
engine that built it ran: numpy float64 for the oracle backend, torch
tensors on the engine's device for ``backend="torch"``.  A drain folds a
view on the device it lives on — the delta engine is built there, the
cached and delta blocks are concatenated with ``torch.cat`` and regrouped
through ``kernels.ops.segment_blocks`` — and never copies a block to the
host.

Two pieces of store-owned state make those views reusable at all:

* **append-only attribute dictionaries** — every attribute's value↔id
  mapping is global to the store and only ever *extended* (new values get
  fresh ids at the end), so an append never renumbers ids baked into
  cached views;
* an **encoded-column cache** — the int32 id columns of unchanged
  relations, so warm engine construction is O(1) instead of a full
  ``np.unique`` rescan of the catalog.

Counters: ``passes`` / ``node_visits`` accumulate over EVERY engine
traversal against this store (cold computes, delta folds — all paths,
uniformly); ``cat_passes`` / ``cat_node_visits`` remain the
categorical-path subset for continuity.  ``reset_counters()`` zeroes all
of them plus the view-cache hit/miss/eviction counters, so benchmarks and
tests no longer depend on call order.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
from typing import (
    TYPE_CHECKING,
    Callable,
    Dict,
    List,
    Optional,
    Sequence,
    Tuple,
)

import numpy as np
import torch

from .delta_log import DeltaLog
from .fd import (
    FDReduction,
    FunctionalDependency,
    extend_mapping,
    reduction_plan,
    witnessed_mapping,
)
from .relation import Relation, join_keys, sort_merge_join
from .view_cache import DEFAULT_MAX_BYTES, ViewCache

if TYPE_CHECKING:  # avoid a circular import at runtime (factorize -> store)
    from .factorize import Cofactors
    from .variable_order import VariableOrder

__all__ = ["Store", "StoreSnapshot"]

#: the zero-work return value of :meth:`Store.flush`
_NO_DRAIN = {"relations": 0, "rows": 0, "appends": 0}


def _attr_domain(relations: Dict[str, Relation], attr: str) -> int:
    """Max declared dictionary domain of ``attr`` over ``relations``."""
    doms = [rel.domains[attr] for rel in relations.values() if attr in rel.domains]
    if not doms:
        raise ValueError(
            f"attribute {attr!r} is not a dictionary-encoded key in any "
            "relation"
        )
    return max(doms)


def _column_moments(
    relations: Dict[str, Relation], col: str
) -> Tuple[float, float, int]:
    """(sum, max|x|, count) of ``col`` over the union of ``relations``
    holding it, in float64."""
    chunks = [
        rel.column(col).astype(np.float64)
        for rel in relations.values()
        if col in rel.values or col in rel.keys
    ]
    if not chunks:
        raise ValueError(f"column {col} not found in any relation")
    allv = np.concatenate(chunks)
    return float(allv.sum()), float(np.abs(allv).max()), len(allv)


def _fd_reduction(
    relations: Dict[str, Relation],
    fds: Dict[Tuple[str, str], FunctionalDependency],
    memo: Dict[tuple, FDReduction],
    cat: Sequence[str],
) -> FDReduction:
    """The FD reduction plan of ``cat``, memoized per (cat list, domains)
    in ``memo`` until the FD catalog changes."""
    domains = {a: _attr_domain(relations, a) for a in cat}
    key = (tuple(cat), tuple(sorted(domains.items())))
    plan = memo.get(key)
    if plan is None:
        plan = memo[key] = reduction_plan(fds, list(cat), domains)
    return plan


def _sufficient_stats(
    reader, vorder, features, label, categorical, backend, refresh,
    reduce_fds, device,
):
    """``sufficient_stats``' routing, shared by :class:`Store` and
    :class:`StoreSnapshot`: the continuous block is the non-categorical
    features plus the label; with categorical attributes the read goes to
    ``cat_cofactors`` (default backend ``"numpy"``), else to ``cofactors``
    (default ``"torch"``)."""
    cont = [f for f in features if f not in set(categorical)]
    if label is not None:
        cont.append(label)
    cat = list(categorical)
    if cat:
        return reader.cat_cofactors(
            vorder,
            cont,
            cat,
            backend=backend if backend is not None else "numpy",
            refresh=refresh,
            reduce_fds=reduce_fds,
            device=device,
        )
    return reader.cofactors(
        vorder,
        cont,
        backend=backend if backend is not None else "torch",
        refresh=refresh,
        device=device,
    )


def _locked(method: Callable) -> Callable:
    """Serialize a catalog-mutating method under ``self._mutate_lock``.

    The lock is re-entrant because mutators nest (``cofactors`` →
    ``flush`` → ``_fold_relation``; ``append`` in eager mode folds
    inline).  Readers off the snapshot path stay lock-free: catalog maps
    are replaced copy-on-write, so a concurrent reader sees either the
    old or the new map, never a half-mutated one."""

    @functools.wraps(method)
    def wrapper(self, *args, **kwargs):
        with self._mutate_lock:
            return method(self, *args, **kwargs)

    return wrapper


@dataclasses.dataclass
class _CacheEntry:
    cofactors: object  # Cofactors | CatCofactors — unscaled; treat as immutable
    relations: frozenset  # relation names the entry's join covers
    version: int  # stamp: valid iff >= every covered relation's watermark


def _device_tag(backend: str, device) -> Optional[str]:
    """The device a result entry is keyed by: a torch entry's blocks live
    on ``device`` and its delta folds run there, so reads on different
    devices keep entries apart; a numpy entry lives on the host whatever
    ``device`` says."""
    return str(torch.device(device)) if backend == "torch" else None


class _AttrDict:
    """Append-only global dictionary of one attribute's values.

    ``values[i]`` is the i-th distinct value ever seen (first-seen order —
    NOT sorted: sorting would renumber existing ids when a later value
    lands in the middle, invalidating every cached view keyed by them).
    ``extend_encode`` folds a column in, assigning fresh trailing ids to
    unseen values, and returns the column's int32 ids.  Lookup is fully
    vectorized against a sorted snapshot (``searchsorted``) — continuous
    columns with ~n distinct values cost O(n log n) array work, never a
    Python-level loop.  ``values`` is replaced (never mutated) on growth,
    so captured references stay valid.
    """

    __slots__ = ("values", "_sorted_vals", "_sorted_ids", "_mu")

    def __init__(self) -> None:
        self.values = np.zeros(0, dtype=np.float64)
        self._sorted_vals = np.zeros(0, dtype=np.float64)  # values, sorted
        self._sorted_ids = np.zeros(0, dtype=np.int64)  # ids aligned above
        # a drain-thread snapshot encoding an override column races an
        # appender extending the same attribute's dictionary — growth must
        # be atomic so issued ids never alias two values
        self._mu = threading.Lock()

    def extend_encode(self, col: np.ndarray) -> np.ndarray:
        col = np.asarray(col, dtype=np.float64)
        if not len(col):
            return np.zeros(0, dtype=np.int32)
        with self._mu:
            uniq, inv = np.unique(col, return_inverse=True)
            if len(self._sorted_vals):
                pos = np.searchsorted(self._sorted_vals, uniq)
                pos_c = np.minimum(pos, len(self._sorted_vals) - 1)
                known = self._sorted_vals[pos_c] == uniq
                uid = np.where(known, self._sorted_ids[pos_c], -1)
            else:
                uid = np.full(len(uniq), -1, dtype=np.int64)
            fresh_mask = uid < 0
            if fresh_mask.any():
                fresh = uniq[fresh_mask]  # sorted (unique), first-seen here
                uid[fresh_mask] = len(self.values) + np.arange(len(fresh))
                self.values = np.concatenate([self.values, fresh])
                merged_vals = np.concatenate([self._sorted_vals, fresh])
                order = np.argsort(merged_vals, kind="stable")
                self._sorted_vals = merged_vals[order]
                self._sorted_ids = np.concatenate(
                    [self._sorted_ids, uid[fresh_mask]]
                )[order]
            return uid[inv].astype(np.int32)


class Store:
    """Catalog of named relations with natural-join materialization and an
    incrementally-maintained cofactor cache."""

    def __init__(
        self,
        relations: Optional[Sequence[Relation]] = None,
        view_cache_bytes: int = DEFAULT_MAX_BYTES,
        maintenance: str = "lazy",
        compact_ratio: Optional[float] = 0.5,
        compact_rows: Optional[int] = None,
    ) -> None:
        if maintenance not in ("lazy", "eager"):
            raise ValueError(
                f"maintenance must be 'lazy' or 'eager', got {maintenance!r}"
            )
        #: "lazy" (default): append is O(delta), folds deferred to reads;
        #: "eager": append folds every covering entry before returning.
        self.maintenance = maintenance
        #: compact (invalidate + clear log) when a relation's pending rows
        #: exceed ``compact_ratio`` × its pre-append row count …
        self.compact_ratio = compact_ratio
        #: … or this absolute row cap (either None disables that trigger).
        self.compact_rows = compact_rows
        self._relations: Dict[str, Relation] = {}
        self._cofactor_cache: Dict[tuple, _CacheEntry] = {}
        # categorical entries live in their own cache: the key includes the
        # categorical signature (cont tuple, cat tuple) and the delta
        # maintenance runs the grouped engine instead of the plain one.
        self._cat_cache: Dict[tuple, _CacheEntry] = {}
        # per-relation watermarks: version of the last mutation affecting
        # the relation.  Entry validity = stamp >= every covered watermark;
        # shared with the view cache so both levels use one rule.
        self._rel_versions: Dict[str, int] = {}
        # per-relation pending-append log (lazy maintenance write path)
        self._delta_log = DeltaLog()
        self._draining = False  # re-entrancy guard for flush()
        # serializes catalog mutation (put/append/fold/FD-catalog changes)
        # across threads — see the ``_locked`` decorator.  Snapshot readers
        # never take it.
        self._mutate_lock = threading.RLock()
        # fault-injection seam: when set, called as hook("fold", name) at
        # the top of every delta fold so tests can poison maintenance
        # deterministically.  None in production.
        self.fault_hook: Optional[Callable[[str, str], None]] = None
        # persistent cross-batch per-node view cache (see module docstring);
        # view_cache_bytes=0 disables it (the cold-baseline escape hatch).
        self.view_cache = ViewCache(max_bytes=view_cache_bytes)
        self.view_cache.watermarks = self._rel_versions
        # attr -> append-only global dictionary; (rel, attr) -> cached ids
        self._dicts: Dict[str, _AttrDict] = {}
        self._enc_cols: Dict[Tuple[str, str], np.ndarray] = {}
        # per-fold memo of active override relations' encoded columns (see
        # attr_encoding): {id(override relation): {attr: ids}} while a fold
        # or drain is running — one relation may spawn several delta
        # engines, and a drain overrides several relations at once.
        self._override_enc: Optional[Dict[int, Dict[str, np.ndarray]]] = None
        # functional-dependency catalog: (lhs, rhs) -> FD with its witnessed
        # id mapping.  Declared FDs are contracts; inferred ones are dropped
        # when an append falsifies them (see append / _plan_fd_updates).
        self._fds: Dict[Tuple[str, str], FunctionalDependency] = {}
        # FD-catalog generation + reduction-plan memo: reduction_plan is
        # pure in (cat list, FD catalog), so invalidation is just a bump.
        self._fd_version = 0
        self._red_cache: Dict[tuple, FDReduction] = {}
        # signature -> VariableOrder, kept so maintenance can re-run the engine
        self._vorders: Dict[tuple, "VariableOrder"] = {}
        # col -> (sum, max|x|, count) over the union of relations with col
        self._moments: Dict[str, Tuple[float, float, int]] = {}
        # unified cumulative counters: EVERY engine traversal / view
        # evaluation against this store (cold computes, delta folds, ...)
        # — the engine increments them directly.
        self.passes = 0
        self.node_visits = 0
        # categorical-path subset (cold computes AND delta folds) — with the
        # fused multi-output plan this grows by 1 pass per compute/fold,
        # however many categorical attributes ride along.
        self.cat_passes = 0
        self.cat_node_visits = 0
        self.version = 0
        for rel in relations or ():
            self.put(rel)

    # -- attribute dictionaries (append-only, store-global) --------------------
    def _dict_for(self, attr: str) -> _AttrDict:
        d = self._dicts.get(attr)
        if d is None:
            with self._mutate_lock:  # two threads must not race the create
                d = self._dicts.get(attr)
                if d is None:
                    d = self._dicts[attr] = _AttrDict()
        return d

    def attr_encoding(
        self, rel_name: str, attr: str, override: Optional[Relation] = None
    ) -> np.ndarray:
        """int32 ids of ``rel_name``'s column ``attr`` under the store's
        append-only dictionary.  Catalog columns are cached (and extended
        in place by ``append``); ``override`` encodes a replacement
        relation's column instead — used by delta engines — without
        touching the cache."""
        if override is not None:
            # one fold spawns several delta engines (view-cache folds per
            # feature group + the result-cache folds), and a drain folds
            # several override relations; encode each override column once
            # per fold, not once per engine.
            memo = self._override_enc
            if memo is not None:
                by_attr = memo.setdefault(id(override), {})
                ids = by_attr.get(attr)
                if ids is None:
                    ids = by_attr[attr] = self._dict_for(attr).extend_encode(
                        override.column(attr)
                    )
                return ids
            return self._dict_for(attr).extend_encode(override.column(attr))
        key = (rel_name, attr)
        ids = self._enc_cols.get(key)
        if ids is None:
            col = self._relations[rel_name].column(attr)
            ids = self._dict_for(attr).extend_encode(col)
            # Deliberate lock-free memo fill: racing threads compute the
            # same ids (append-only dictionaries) and a dict put is atomic
            # under the GIL, so last-writer-wins is correct.
            self._enc_cols[key] = ids
        return ids

    def attr_values_array(self, attr: str) -> np.ndarray:
        """id -> value translation array of ``attr``'s global dictionary."""
        return self._dict_for(attr).values

    def _register_vorder(self, sig: tuple, vorder: "VariableOrder") -> None:
        """Remember a variable order by signature so ``append`` can rebuild
        delta engines for view-cache entries created outside
        :meth:`cofactors` / :meth:`cat_cofactors`.  Engines call this from
        snapshot reads too, so the registry insert takes the mutate lock."""
        with self._mutate_lock:
            self._vorders.setdefault(sig, vorder)

    def reset_counters(self) -> None:
        """Zero every cumulative counter (unified + categorical + view
        cache) — benches and tests measure deltas from a known origin
        instead of depending on call order.  Taken under the mutate lock so
        a reset never lands mid-fold and splits one maintenance pass's
        counters across epochs."""
        with self._mutate_lock:
            self.passes = 0
            self.node_visits = 0
            self.cat_passes = 0
            self.cat_node_visits = 0
            self.view_cache.reset_counters()

    # -- catalog -------------------------------------------------------------
    @_locked
    def put(self, rel: Relation) -> None:
        """Insert or replace a relation.  Replacement is an arbitrary
        mutation, so cache entries covering the name are invalidated, and
        every FD touching the relation's attributes is re-verified from
        scratch (a declared FD that no longer holds raises; an inferred one
        is silently dropped).

        Copy-on-write: the catalog / FD / moments / encoded-column maps are
        *replaced*, never mutated — a :class:`StoreSnapshot` taken before
        the call keeps reading the old maps, unblocked and uncorrupted.
        """
        old = self._relations.get(rel.name)
        old_relations = self._relations
        touched = set(rel.keys) | set(old.keys if old else ())
        stale_fds = [
            key for key in self._fds if key[0] in touched or key[1] in touched
        ]
        # install the new catalog map up front so FD re-verification sees
        # the post-put data; a declared-FD violation restores the untouched
        # old map (rollback is a single pointer swap under COW).
        self._relations = {**old_relations, rel.name: rel}
        reverified: Dict[Tuple[str, str], np.ndarray] = {}
        dropped_fds = []
        for key in stale_fds:
            fd = self._fds[key]
            try:
                dom = self.attr_domain(key[0])
            except ValueError:  # lhs attribute vanished from the catalog
                dom = 0
            mapping = (
                witnessed_mapping(self.relations(), key[0], key[1], dom)
                if dom
                else None
            )
            if mapping is None:
                if fd.source == "declared":
                    self._relations = old_relations
                    raise ValueError(
                        f"put({rel.name!r}) violates declared FD "
                        f"{key[0]} → {key[1]}"
                    )
                dropped_fds.append(key)
            else:
                reverified[key] = mapping
        if dropped_fds or reverified:
            new_fds = dict(self._fds)
            for key in dropped_fds:
                del new_fds[key]
            for key, mapping in reverified.items():
                new_fds[key] = dataclasses.replace(
                    new_fds[key], mapping=mapping
                )
            self._fds = new_fds
        if stale_fds:
            self._bump_fds()
        self.version += 1
        # watermark bump: entries covering the name fail validity from now
        # on (they are dropped below anyway); survivors stay valid with no
        # restamping loop.
        self._rel_versions[rel.name] = self.version
        self._invalidate(rel.name)
        self._invalidate_fd_entries()
        # pending deltas of the replaced relation describe rows that no
        # longer exist, and the entries they would have maintained are gone
        self._delta_log.clear(rel.name)
        stale_attrs = set(rel.attributes) | set(
            old.attributes if old else ()
        )
        self._moments = {
            k: v for k, v in self._moments.items() if k not in stale_attrs
        }
        # encoded columns of the replaced relation are stale; the global
        # dictionaries are NOT rebuilt (append-only forever — unused old
        # values keep their ids so sibling views never renumber).
        self._enc_cols = {
            k: v for k, v in self._enc_cols.items() if k[0] != rel.name
        }

    def get(self, name: str) -> Relation:
        return self._relations[name]

    def __contains__(self, name: str) -> bool:
        return name in self._relations

    def names(self) -> List[str]:
        return list(self._relations)

    def relations(self) -> List[Relation]:
        return list(self._relations.values())

    def total_rows(self) -> int:
        return sum(r.num_rows for r in self._relations.values())

    def attr_domain(self, attr: str) -> int:
        """Dictionary-domain size of a key attribute: the max declared
        domain over all relations carrying it (``concat`` merges domains
        with max, so this is stable under append)."""
        return _attr_domain(self._relations, attr)

    # -- functional dependencies ----------------------------------------------
    @_locked
    def add_fd(self, lhs: str, rhs: str) -> FunctionalDependency:
        """Declare the functional dependency ``lhs → rhs`` between two
        dictionary-encoded key attributes.  Verified against the data now
        (raises if no relation witnesses the pair or any witness violates
        functionality) and re-checked on every ``append``/``put`` — a
        mutation that breaks a declared FD is rejected."""
        mapping = witnessed_mapping(
            self.relations(), lhs, rhs, self.attr_domain(lhs)
        )
        if mapping is None:
            raise ValueError(
                f"functional dependency {lhs} → {rhs} does not hold (or no "
                "relation contains both attributes as keys)"
            )
        fd = FunctionalDependency(lhs, rhs, mapping, "declared")
        self._fds = {**self._fds, (lhs, rhs): fd}
        self._bump_fds()
        self._invalidate_fd_entries()
        return fd

    @_locked
    def infer_fds(
        self, attrs: Optional[Sequence[str]] = None
    ) -> List[Tuple[str, str]]:
        """Scan the catalog for candidate FDs ``f → g`` and register every
        verified one as *inferred* (falsifiable by later appends).

        Candidates are ordered pairs of key attributes co-located in at
        least one relation — the only pairs whose FD status is decidable
        without computing the join (and, by the projection argument in
        ``repro_torch.core.fd``, exactly the witnesses that make the FD sound on
        the join result).  ``attrs`` restricts the candidate universe.
        Returns the newly registered (lhs, rhs) pairs.
        """
        universe = set(attrs) if attrs is not None else None
        pairs: Dict[Tuple[str, str], None] = {}
        for rel in self._relations.values():
            keys = [
                a
                for a in rel.keys
                if universe is None or a in universe
            ]
            for lhs in keys:
                for rhs in keys:
                    if lhs != rhs:
                        pairs.setdefault((lhs, rhs))
        found: List[Tuple[str, str]] = []
        new_fds = dict(self._fds)
        for lhs, rhs in pairs:
            if (lhs, rhs) in new_fds:
                continue
            mapping = witnessed_mapping(
                self.relations(), lhs, rhs, self.attr_domain(lhs)
            )
            if mapping is not None:
                new_fds[(lhs, rhs)] = FunctionalDependency(
                    lhs, rhs, mapping, "inferred"
                )
                found.append((lhs, rhs))
        if found:
            self._fds = new_fds
            self._bump_fds()
            self._invalidate_fd_entries()
        return found

    def fds(self) -> List[FunctionalDependency]:
        return list(self._fds.values())

    @_locked
    def drop_fd(self, lhs: str, rhs: str) -> None:
        if (lhs, rhs) in self._fds:
            self._fds = {
                k: v for k, v in self._fds.items() if k != (lhs, rhs)
            }
            self._bump_fds()
        self._invalidate_fd_entries()

    def _bump_fds(self) -> None:
        """The FD catalog changed (set membership or a mapping's contents):
        memoized reduction plans are stale."""
        self._fd_version += 1
        self._red_cache.clear()

    def fd_reduction(self, cat: Sequence[str]) -> FDReduction:
        """The FD reduction of a categorical attribute list under the
        current catalog: which attributes a solver can drop (they are
        functionally determined by an earlier one) and the id maps needed
        to recover their coefficients in closed form.  Memoized per
        (cat list, domains) until the FD catalog changes — warm
        ``cat_cofactors(reduce_fds=True)`` calls and cache-invalidation
        scans stop re-running the BFS planner."""
        domains = {a: self.attr_domain(a) for a in cat}
        key = (tuple(cat), tuple(sorted(domains.items())))
        plan = self._red_cache.get(key)
        if plan is None:
            plan = reduction_plan(self._fds, list(cat), domains)
            with self._mutate_lock:
                self._red_cache[key] = plan
        return plan

    def _plan_fd_updates(
        self, delta: Relation
    ) -> Tuple[List[Tuple[str, str]], Dict[Tuple[str, str], np.ndarray]]:
        """Pure check of ``delta`` against the FD catalog: returns the
        inferred FDs it falsifies and the mapping extensions (new lhs ids)
        it implies; raises on a declared-FD violation — before the caller
        has mutated anything."""
        falsified: List[Tuple[str, str]] = []
        extensions: Dict[Tuple[str, str], np.ndarray] = {}
        for key, fd in self._fds.items():
            lhs, rhs = key
            if lhs not in delta.keys or rhs not in delta.keys:
                continue
            l = delta.keys[lhs].astype(np.int64)
            r = delta.keys[rhs].astype(np.int64)
            size = max(
                len(fd.mapping), int(l.max()) + 1 if len(l) else 0
            )
            mapping = np.full(size, -1, dtype=np.int64)
            mapping[: len(fd.mapping)] = fd.mapping
            if extend_mapping(mapping, l, r):
                extensions[key] = mapping
            elif fd.source == "declared":
                raise ValueError(
                    f"append violates declared FD {lhs} → {rhs}"
                )
            else:
                falsified.append(key)
        return falsified, extensions

    def _invalidate_fd_entries(self) -> None:
        """Drop categorical cache entries whose FD-reduced shape no longer
        matches the catalog (an FD was added, dropped, or falsified).
        Entries keyed with a trivial/no reduction are untouched."""
        stale = []
        for key in self._cat_cache:
            fdsig = key[4]
            if fdsig is None:
                continue
            if self.fd_reduction(list(key[2])).signature() != fdsig:
                stale.append(key)
        for key in stale:
            del self._cat_cache[key]

    # -- incremental updates ---------------------------------------------------
    @_locked
    def append(self, name: str, delta: Relation) -> Relation:
        """Append the rows of ``delta`` to relation ``name`` (batch update).

        ``delta`` must carry the same key/value attribute sets as the stored
        relation (its own ``name`` is ignored).  Returns the merged relation
        now in the catalog.

        Under the default ``maintenance="lazy"`` the write path is
        **O(delta)**: FD validation, the concat, the moments / encoded-
        column extension, and a metadata push onto the pending-delta log —
        no view-cache or cofactor folds, whatever the cache population.
        Cached entries covering ``name`` become stale-but-foldable; the
        next read that touches them drains the log (:meth:`flush`), folding
        the *stacked* delta in one pass (Prop. 4.1 union commutativity).
        If the pending rows cross the compaction threshold
        (``compact_ratio`` / ``compact_rows``), covering entries are
        invalidated instead — recomputing from the merged base is cheaper
        than folding a delta comparable to it.

        ``maintenance="eager"`` folds every covering entry before the
        catalog is touched (the pre-lazy behaviour): the delta cofactors
        are computed against the pre-merge catalog and summed in, and a
        fold that raises leaves the catalog, moments and FD catalog
        exactly as before the call (covering entries invalidated).

        FD maintenance (both modes): the delta is checked against the FD
        catalog first — a violated *declared* FD rejects the append
        outright (nothing mutated); a falsified *inferred* FD is dropped
        and every FD-reduced cache entry built under it is invalidated;
        new lhs ids with consistent rhs values extend the FD mappings.
        """
        if name not in self._relations:
            raise KeyError(f"append target {name!r} not in catalog")
        base = self._relations[name]
        merged = base.concat(delta)  # validates attribute sets first

        if not delta.num_rows:
            # empty delta: publish the (identical) merged relation and bump
            # the version WITHOUT moving the watermark — nothing about the
            # data changed, so every cached entry stays valid.
            self._relations = {**self._relations, name: merged}
            self.version += 1
            return merged

        delta_named = dataclasses.replace(
            delta,
            name=name,
            keys=dict(delta.keys),
            values=dict(delta.values),
            domains=dict(delta.domains),
        )
        # FD check is a pure plan: raises on a declared-FD violation
        # before anything below has mutated.
        falsified, extensions = self._plan_fd_updates(delta_named)
        if self.maintenance == "eager":
            # fold-on-write, against the pre-merge catalog; stamped at the
            # post-publish version so the entries are valid the moment the
            # catalog lands.  A poisoned delta raises out of here with the
            # store untouched (covering entries invalidated).
            self._override_enc = {}
            try:
                self._fold_relation(name, delta_named, {}, self.version + 1)
            except Exception:
                self._invalidate(name)
                raise
            finally:
                self._override_enc = None
        # per-column moments: accumulate under union.  Eager in BOTH modes
        # — the O(delta) column scan costs no more than the log push and
        # keeps feature scaling off the drain path.  Built as a fresh map
        # and published below with the catalog — a snapshot holding the
        # old map never sees a partial update.
        new_moments = dict(self._moments)
        for attr, (s, mx, cnt) in list(self._moments.items()):
            if attr not in delta_named.attributes:
                continue
            col = delta_named.column(attr).astype(np.float64)
            new_moments[attr] = (
                s + float(col.sum()),
                max(mx, float(np.abs(col).max())),
                cnt + len(col),
            )
        if falsified or extensions:
            new_fds = dict(self._fds)
            for key in falsified:
                del new_fds[key]
            for key, mapping in extensions.items():
                new_fds[key] = dataclasses.replace(
                    new_fds[key], mapping=mapping
                )
            self._fds = new_fds
            self._bump_fds()
        if falsified:
            self._invalidate_fd_entries()
        # encoded-column cache: the merged relation is base ++ delta,
        # so cached id columns extend with the delta's ids (global
        # dictionaries grow append-only — existing ids never move).
        new_enc = dict(self._enc_cols)
        for attr in delta_named.attributes:
            enc_key = (name, attr)
            ids = new_enc.get(enc_key)
            if ids is not None:
                delta_ids = self._dict_for(attr).extend_encode(
                    delta_named.column(attr)
                )
                new_enc[enc_key] = np.concatenate([ids, delta_ids])
        self._enc_cols = new_enc
        self._moments = new_moments
        # COW publish: snapshot readers holding the old maps are untouched.
        self._relations = {**self._relations, name: merged}
        log = None
        if self.maintenance == "lazy":
            # metadata only: the stacked delta IS merged[base_rows:], so
            # the log records row counts, never rows.
            log = self._delta_log.record(
                name, base.num_rows, delta.num_rows, self.version
            )
        self.version += 1
        self._rel_versions[name] = self.version
        if log is not None and self._should_compact(log):
            self._compact(name)
        return merged

    # -- lazy maintenance: pending-delta log + drain ---------------------------
    @_locked
    def flush(self, names: Optional[Sequence[str]] = None) -> Dict[str, int]:
        """Fold every pending append into the caches NOW (the lazy-
        maintenance read barrier, also callable as an explicit idle-window
        pass).  ``names`` is an optional scope hint: when given and no
        pending relation is among them, the call is a no-op — but a drain,
        once started, always folds ALL pending relations (partial drains
        would leave entries covering several pending relations half
        folded).

        Returns ``{"relations", "rows", "appends"}`` actually drained
        (zeros when there was nothing to do).  Never bumps ``version`` —
        folding changes no data, so snapshots taken before a flush remain
        current through it."""
        if self._draining or not self._delta_log:
            return dict(_NO_DRAIN)
        if names is not None and not (
            set(names) & set(self._delta_log.names())
        ):
            return dict(_NO_DRAIN)
        return self._drain_all()

    def _drain_all(self) -> Dict[str, int]:
        """Fold the stacked delta of every pending relation into the
        covering view-cache / cofactor entries, in first-pending order.

        Multi-relation exactness (the telescoping sum): when relations
        A, B, … are pending, relation i's fold runs with relation i
        overridden to its stacked delta and every LATER pending relation
        frozen to its pre-append prefix.  Summing the per-relation fold
        terms then telescopes to exactly the merged-join total — the
        ΔA ⋈ ΔB cross terms are picked up exactly once (by the earlier
        relation's fold, whose catalog view of the later one is still the
        prefix), independent of drain order.

        Exception safety: a fold that raises invalidates every entry
        covering a still-pending relation (the failed one may be half
        folded), clears those logs, and re-raises to the reader — the
        catalog itself was published at append time and stays correct.
        """
        log = self._delta_log
        pend = log.items()
        stats = {
            "relations": len(pend),
            "rows": log.total_rows(),
            "appends": log.total_appends(),
        }
        self._draining = True
        try:
            for i, (name, rlog) in enumerate(pend):
                # fresh memo per relation: the override slices below are
                # keyed by object id, which a freed slice could recycle
                self._override_enc = {}
                delta = self._slice_rows(name, rlog.base_rows, None)
                frozen = {
                    later: self._slice_rows(later, 0, later_log.base_rows)
                    for later, later_log in pend[i + 1 :]
                }
                self._fold_relation(name, delta, frozen, self.version)
                log.clear(name, drained=True)
        except Exception:
            for name, _ in pend:
                if name in log:
                    self._invalidate(name)
                    log.clear(name)
            raise
        finally:
            self._draining = False
            self._override_enc = None
        log.drains += 1
        return stats

    def _slice_rows(
        self, name: str, start: int, stop: Optional[int]
    ) -> Relation:
        """A row-range view of cataloged relation ``name`` — the stacked
        pending delta (``[base_rows:]``) or the frozen pre-append prefix
        (``[:base_rows]``) used as a drain override.  Its encoded columns
        are pre-seeded into the override memo by slicing the cached merged
        encodings, so delta engines never re-encode drained rows."""
        merged = self._relations[name]
        sl = slice(start, stop)
        rel = Relation(
            name=name,
            keys={a: c[sl] for a, c in merged.keys.items()},
            values={a: c[sl] for a, c in merged.values.items()},
            domains=dict(merged.domains),
        )
        memo = self._override_enc
        if memo is not None:
            # overwrite (never setdefault): a dead slice's recycled id must
            # not leak its encodings to this fresh one
            by_attr = memo[id(rel)] = {}
            for attr in rel.attributes:
                by_attr[attr] = self.attr_encoding(name, attr)[sl]
        return rel

    def _should_compact(self, log) -> bool:
        if self.compact_rows is not None and log.rows > self.compact_rows:
            return True
        return (
            self.compact_ratio is not None
            and log.rows > self.compact_ratio * max(log.base_rows, 1)
        )

    def _compact(self, name: str) -> None:
        """Pending rows crossed the fold-vs-recompute crossover: folding a
        stacked delta comparable to the base costs as much as a fresh
        descent, so drop the covering entries and the log — the next read
        recomputes from the merged base and re-seeds the caches."""
        self._invalidate(name)
        self._delta_log.clear(name)
        self._delta_log.compactions += 1

    def _fold_relation(
        self,
        name: str,
        delta: Relation,
        frozen: Dict[str, Relation],
        stamp: int,
    ) -> None:
        """Fold ``delta`` (relation ``name``'s update rows) into every
        cache entry covering ``name``, stamping survivors at ``stamp``.
        ``frozen`` overrides other relations to their pre-append prefixes
        (the drain's telescoping guard; empty for eager single-relation
        folds).  Callers own exception handling and the override memo."""
        hook = self.fault_hook
        if hook is not None:
            hook("fold", name)
        overrides = {name: delta, **frozen}
        # persistent view cache first: entries on the appended relation's
        # root path are folded with delta views (their sibling subtrees'
        # entries stay valid untouched), so the result-cache delta engines
        # below — and every later warm batch — start from an already-
        # maintained view layer.
        self._maintain_view_cache(name, overrides, stamp)
        # one delta factorization per (vorder, backend, device) over the
        # union of cached feature sets; entries derive via project —
        # entries differing only in features don't pay the join again.
        groups: Dict[tuple, List[tuple]] = {}
        for key, entry in self._cofactor_cache.items():
            if name in entry.relations:
                sig, feats, backend, device = key
                groups.setdefault((sig, backend, device), []).append(key)
        for (sig, backend, device), keys in groups.items():
            feats_union = list(dict.fromkeys(f for k in keys for f in k[1]))
            delta_cof = self._delta_cofactors(
                sig, feats_union, backend, overrides, device
            )
            for key in keys:
                entry = self._cofactor_cache[key]
                entry.cofactors = entry.cofactors + delta_cof.project(
                    list(key[1])
                )
                entry.version = stamp
        # categorical entries: same union algebra, grouped engine, and the
        # same delta-sharing scheme as above — one delta pass per (vorder,
        # backend, device) over the union feature sets, entries derive via
        # ``CatCofactors.project``.  FD-reduced entries only carry their
        # KEPT attributes (entry.cofactors.cat), so the union delta is
        # computed over kept attributes too — the reduced blocks are plain
        # cofactors over the kept set and fold with the same algebra.  The
        # delta carries the delta's (possibly larger) domains; ``__add__``
        # zero-pads, so unseen category ids appended here grow the cached
        # blocks in place.
        cat_groups: Dict[tuple, List[tuple]] = {}
        for key, entry in self._cat_cache.items():
            if name in entry.relations:
                sig, cont, cat, backend, fdsig, device = key
                cat_groups.setdefault((sig, backend, device), []).append(key)
        for (sig, backend, device), keys in cat_groups.items():
            cont_union = list(dict.fromkeys(f for k in keys for f in k[1]))
            cat_union = list(
                dict.fromkeys(
                    c
                    for k in keys
                    for c in self._cat_cache[k].cofactors.cat
                )
            )
            delta_cof = self._delta_cat_cofactors(
                sig, cont_union, cat_union, backend, overrides, device
            )
            for key in keys:
                entry = self._cat_cache[key]
                entry.cofactors = entry.cofactors + delta_cof.project(
                    list(key[1]), list(entry.cofactors.cat)
                )
                entry.version = stamp

    def _maintain_view_cache(
        self, name: str, overrides: Dict[str, Relation], stamp: int
    ) -> None:
        """Delta-path maintenance of the persistent view cache for one
        relation's fold.

        Joins distribute over union, per node: the view of a subtree
        containing ``name`` over the post-append catalog equals its
        pre-append view ⊎ the view with ``name`` replaced by the delta
        rows (Prop. 4.1 at view granularity).  So instead of blanket
        invalidation, every affected entry — they all sit on the appended
        relation leaf's root path — is folded in place with a delta view;
        the delta engines reuse the cached views of untouched sibling
        subtrees, keeping the cost O(delta root path), never O(tree).
        Entries whose variable order was never registered fall back to
        invalidation (cannot rebuild an engine for them).  Each delta
        engine runs on the device the cached view's blocks live on, so the
        fold never moves a block between the host and the card."""
        vc = self.view_cache
        affected = [(k, e) for k, e in vc.items() if name in e.relations]
        if not affected:
            return
        from .factorize import FactorizedEngine, engine_dtype

        # highest degree first: the degree-2 folds populate the shared
        # delta memo, and every lower-degree fold trims from it instead
        # of re-descending
        affected.sort(key=lambda ke: -ke[0].degree)
        engines: Dict[tuple, FactorizedEngine] = {}
        for key, entry in affected:
            device = getattr(entry.view.c, "device", "cpu")
            ekey = (key.vorder_sig, key.backend, key.dtype, key.feats, device)
            eng = engines.get(ekey)
            if eng is None:
                vorder = self._vorders.get(key.vorder_sig)
                if vorder is None:
                    vc.discard(key)
                    continue
                eng = FactorizedEngine(
                    self,
                    vorder,
                    list(key.feats),
                    backend=key.backend,
                    dtype=engine_dtype(key.backend, key.dtype),
                    overrides=overrides,
                    use_view_cache=True,
                    device=device,
                )
                engines[ekey] = eng
            vc.replace(
                key, eng.fold_delta_view(key, entry.view), version=stamp
            )

    def column_moments(self, col: str) -> Tuple[float, float, int]:
        """(sum, max|x|, count) of ``col`` over the union of relations that
        contain it — computed once, then maintained under ``append`` and
        invalidated by ``put``.  The feature-scaling building block
        (``compute_scale_factors`` reads avg = sum/count and max|x| from
        here, so warm retrains never rescan the historical data)."""
        if col in self._moments:
            return self._moments[col]
        out = _column_moments(self._relations, col)
        with self._mutate_lock:
            self._moments[col] = out
        return out

    def _delta_cofactors(
        self,
        vorder_sig: tuple,
        features: List[str],
        backend: str,
        overrides: Dict[str, Relation],
        device,
    ) -> "Cofactors":
        """Cofactors of the join with the folding relation replaced by its
        delta rows (and, during a multi-relation drain, later pending
        relations frozen to their prefixes) — the additive update term for
        one cache entry.  Runs as a delta engine against THIS store
        (``overrides``), so the descent reuses cached sibling-subtree views
        and the shared dictionaries instead of re-encoding the whole
        pre-merge catalog into a throwaway store."""
        from .factorize import FactorizedEngine

        vorder = self._vorders[vorder_sig]
        return FactorizedEngine(
            self,
            vorder,
            features,
            backend=backend,
            overrides=overrides,
            device=device,
        ).cofactors()

    def _delta_cat_cofactors(
        self,
        vorder_sig: tuple,
        cont: List[str],
        cat: List[str],
        backend: str,
        overrides: Dict[str, Relation],
        device,
    ):
        """Categorical delta term: the full fused cofactor batch of the join
        under ``overrides`` — ONE multi-output engine traversal per fold,
        not one per attribute/pair, reusing cached sibling-subtree views
        through ``overrides``."""
        from .categorical import cat_cofactors_factorized

        vorder = self._vorders[vorder_sig]
        stats: Dict[str, int] = {}
        out = cat_cofactors_factorized(
            self,
            vorder,
            cont,
            cat,
            backend=backend,
            stats=stats,
            overrides=overrides,
            device=device,
        )
        self.cat_passes += stats["passes"]
        self.cat_node_visits += stats["node_visits"]
        return out

    # -- cofactor cache --------------------------------------------------------
    def sufficient_stats(
        self,
        vorder: "VariableOrder",
        features: Sequence[str],
        label: Optional[str] = None,
        categorical: Sequence[str] = (),
        backend: Optional[str] = None,
        refresh: bool = False,
        reduce_fds: bool = False,
        device="cuda",
    ):
        """Sufficient statistics of a regression over the factorized join —
        THE public read entry point for model training (and the single
        choke point the lazy-maintenance drain instruments).

        ``features`` are the model inputs; ``label`` (if given) is appended
        to the continuous block.  With ``categorical=()`` this returns the
        continuous :class:`~repro_torch.core.factorize.Cofactors` over
        ``features + [label]`` (default backend ``"torch"``, float32 on
        ``device``, ``"cuda"`` unless the caller asks for the CPU); with
        categorical attributes it returns the
        :class:`~repro_torch.core.categorical.CatCofactors` whose continuous
        block covers the non-categorical features + label (default backend
        ``"numpy"``; ``reduce_fds`` applies the FD reduction — see
        :meth:`cat_cofactors`).  Results are cached and maintained under
        append; ``refresh=True`` forces a from-scratch recompute.  Do not
        mutate returned objects.

        Under lazy maintenance this is a read barrier: pending deltas are
        drained (:meth:`flush`) before the cache is consulted, so entries
        are folded up to date or recomputed — never served stale.

        :meth:`cofactors` and :meth:`cat_cofactors` are thin wrappers kept
        for the established call sites.  Torch-backend entries are keyed by
        ``device`` (a read on another device computes its own entry) and
        the drain folds each one there.
        """
        return _sufficient_stats(
            self, vorder, features, label, categorical, backend, refresh,
            reduce_fds, device,
        )

    def _entry_current(self, entry: _CacheEntry) -> bool:
        """Entry validity under per-relation watermarks: valid iff stamped
        at or after the last mutation of every relation it covers.  A lazy
        append moves the covered relations' watermarks without touching
        the entry; the pre-read drain folds the entry and restamps it —
        this check is the backstop against drain/invalidation bugs."""
        rv = self._rel_versions
        return all(entry.version >= rv.get(r, 0) for r in entry.relations)

    @_locked
    def cofactors(
        self,
        vorder: "VariableOrder",
        features: Sequence[str],
        backend: str = "torch",
        refresh: bool = False,
        device="cuda",
    ) -> "Cofactors":
        """Cached *unscaled* cofactors over the factorized join of
        ``vorder`` for ``features`` (continuous wrapper around
        :meth:`sufficient_stats` — the features here already include any
        label column).  Computes on miss; appends maintain the entry
        incrementally (eagerly or via the pending-delta drain);
        ``refresh=True`` forces a from-scratch recompute (and re-seeds the
        cache).  Do not mutate the result — derive scaled views with
        ``Cofactors.rescale``."""
        from .factorize import FactorizedEngine

        self.flush(vorder.relations())
        sig = vorder.signature()
        key = (sig, tuple(features), backend, _device_tag(backend, device))
        entry = self._cofactor_cache.get(key)
        if entry is not None and not refresh and self._entry_current(entry):
            return entry.cofactors
        cof = FactorizedEngine(
            self, vorder, list(features), backend=backend, device=device
        ).cofactors()
        self._vorders[sig] = vorder
        self._cofactor_cache[key] = _CacheEntry(
            cofactors=cof,
            relations=frozenset(vorder.relations()),
            version=self.version,
        )
        return cof

    @_locked
    def cat_cofactors(
        self,
        vorder: "VariableOrder",
        cont: Sequence[str],
        cat: Sequence[str],
        backend: str = "numpy",
        refresh: bool = False,
        reduce_fds: bool = False,
        device="cuda",
    ):
        """Cached categorical cofactors over the factorized join — the
        categorical twin of :meth:`cofactors` (wrapper around
        :meth:`sufficient_stats`; ``cont`` already includes the label).
        The cache key includes the categorical signature (which attributes
        are declared categorical, in order), so continuous and categorical
        entries over the same join never alias, and ``append`` maintains
        both kinds incrementally.  Cold computes and delta folds both run
        the fused multi-output plan — exactly one engine traversal each,
        audited by ``cat_passes`` / ``cat_node_visits`` in
        :meth:`cache_info`.

        ``reduce_fds=True`` applies the FD reduction of ``cat`` under the
        store's catalog: functionally-determined attributes are dropped
        before the traversal (fewer GROUP BY queries, smaller COO blocks)
        and the returned ``CatCofactors`` covers only the KEPT attributes
        (``store.fd_reduction(cat)`` describes the mapping; expansion /
        coefficient recovery live in ``repro_torch.core.fd``).  The cache key
        carries the reduction *signature*, so entries built under an FD
        that is later falsified are invalidated rather than re-served.
        Returns a ``repro_torch.core.categorical.CatCofactors``; do not mutate."""
        from .categorical import cat_cofactors_factorized

        self.flush(vorder.relations())
        sig = vorder.signature()
        red = self.fd_reduction(cat) if reduce_fds else None
        fdsig = red.signature() if red is not None else None
        key = (
            sig, tuple(cont), tuple(cat), backend, fdsig,
            _device_tag(backend, device),
        )
        entry = self._cat_cache.get(key)
        if entry is not None and not refresh and self._entry_current(entry):
            return entry.cofactors
        run_cat = list(red.kept) if red is not None else list(cat)
        stats: Dict[str, int] = {}
        cof = cat_cofactors_factorized(
            self,
            vorder,
            list(cont),
            run_cat,
            backend=backend,
            stats=stats,
            device=device,
        )
        self.cat_passes += stats["passes"]
        self.cat_node_visits += stats["node_visits"]
        self._vorders[sig] = vorder
        self._cat_cache[key] = _CacheEntry(
            cofactors=cof,
            relations=frozenset(vorder.relations()),
            version=self.version,
        )
        return cof

    @_locked
    def cache_info(self) -> Dict[str, int]:
        # Under the mutate lock so the report is one consistent cut: entry
        # counts, counters and delta-log debt all from the same instant,
        # never straddling a fold.
        vc = self.view_cache
        info = {
            "entries": len(self._cofactor_cache),
            "cat_entries": len(self._cat_cache),
            "fds": len(self._fds),
            "version": self.version,
            "maintenance": self.maintenance,
            "passes": self.passes,
            "node_visits": self.node_visits,
            "cat_passes": self.cat_passes,
            "cat_node_visits": self.cat_node_visits,
            "view_cache_entries": len(vc),
            "view_cache_bytes": vc.bytes,
            "view_cache_hits": vc.hits,
            "view_cache_misses": vc.misses,
            "view_cache_evictions": vc.evictions,
        }
        info.update(self._delta_log.info())
        return info

    def _invalidate(self, name: str) -> None:
        for cache in (self._cofactor_cache, self._cat_cache):
            stale = [k for k, e in cache.items() if name in e.relations]
            for k in stale:
                del cache[k]
        self.view_cache.invalidate_relation(name)

    # -- snapshots -------------------------------------------------------------
    @property
    def live_version(self) -> int:
        """The store's current catalog version.  On a :class:`StoreSnapshot`
        the same property forwards to the parent store, so engines can ask
        "is the catalog I froze still the live one" uniformly."""
        return self.version

    def snapshot(self) -> "StoreSnapshot":
        """An immutable read view of the catalog at the current version.

        O(1): captures references to the copy-on-write maps (`_relations`,
        encoded columns, moments, FD catalog) — every later ``put`` /
        ``append`` / FD mutation *replaces* those maps on the store, so the
        snapshot keeps serving the frozen state without blocking writers
        and without writers corrupting it (MVCC by structural sharing).
        """
        return StoreSnapshot(self)

    # -- natural join (the noPre path) ----------------------------------------
    def materialize_join(
        self, names: Optional[Sequence[str]] = None
    ) -> Relation:
        """Materialize the natural join of ``names`` (default: all relations).

        Joins pairwise on shared key attributes, greedily preferring joins
        with at least one shared attribute (avoids accidental cross products
        when a connected join order exists).
        """
        return _materialize(self._relations, names)


class StoreSnapshot:
    """Read-only view of a :class:`Store` frozen at one catalog version.

    Duck-types the Store read surface (`get` / `attr_encoding` /
    `column_moments` / `fd_reduction` / `cofactors` / ... ), so a
    ``FactorizedEngine`` — or any reader — runs against it unchanged.
    Concurrent ``append`` / ``put`` / FD mutations on the parent replace
    the parent's maps copy-on-write; this object keeps the frozen
    references, so an in-flight reader observes bit-identical data whether
    or not a mutation lands mid-request.

    Shared with the parent (safe by construction):

    * the append-only attribute dictionaries — values are only ever
      *extended*, ids never renumber, so post-snapshot growth is invisible
      to ids the snapshot can produce;
    * the version-stamped ``ViewCache`` — entries carry the version they
      are valid at, and engines stand down from the cache the moment the
      live version moves past their frozen one;
    * the cumulative ``passes`` / ``node_visits`` counters — snapshot
      traversals forward into the parent's totals so store-level counter
      audits keep summing up.

    Result-level caches (`cofactors` / `cat_cofactors`) delegate to the
    parent only while the snapshot is still current; once the parent moves
    on, the snapshot computes fresh, uncached, against its frozen maps.
    """

    def __init__(self, store: Store) -> None:
        self._store = store
        self.version = store.version
        self._relations = store._relations
        self._enc_cols = store._enc_cols
        self._moments = store._moments
        self._fds_map = store._fds
        self._fd_version = store._fd_version
        self._red_cache: Dict[tuple, FDReduction] = {}
        self.view_cache = store.view_cache

    # -- freshness -------------------------------------------------------------
    @property
    def live_version(self) -> int:
        return self._store.version

    @property
    def is_current(self) -> bool:
        """True while no catalog or FD mutation has landed on the parent
        since this snapshot was taken."""
        return (
            self.version == self._store.version
            and self._fd_version == self._store._fd_version
        )

    def snapshot(self) -> "StoreSnapshot":
        return self  # already frozen; engines may call this blindly

    # -- counters (forwarded: store totals stay the audit source of truth) -----
    @property
    def passes(self) -> int:
        return self._store.passes

    @passes.setter
    def passes(self, v: int) -> None:
        self._store.passes = v

    @property
    def node_visits(self) -> int:
        return self._store.node_visits

    @node_visits.setter
    def node_visits(self, v: int) -> None:
        self._store.node_visits = v

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

    def _register_vorder(self, sig: tuple, vorder: "VariableOrder") -> None:
        # registration targets append-time maintenance on the live store
        self._store._register_vorder(sig, vorder)

    # -- catalog reads (frozen) ------------------------------------------------
    def get(self, name: str) -> Relation:
        return self._relations[name]

    def __contains__(self, name: str) -> bool:
        return name in self._relations

    def names(self) -> List[str]:
        return list(self._relations)

    def relations(self) -> List[Relation]:
        return list(self._relations.values())

    def total_rows(self) -> int:
        return sum(r.num_rows for r in self._relations.values())

    def attr_domain(self, attr: str) -> int:
        return _attr_domain(self._relations, attr)

    def attr_values_array(self, attr: str) -> np.ndarray:
        # append-only global dictionary: a longer array than at snapshot
        # time is fine — every id this snapshot can produce predates the
        # growth, and existing slots never change.
        return self._store.attr_values_array(attr)

    def attr_encoding(
        self, rel_name: str, attr: str, override: Optional[Relation] = None
    ) -> np.ndarray:
        if override is not None:
            return self._store.attr_encoding(rel_name, attr, override=override)
        key = (rel_name, attr)
        ids = self._enc_cols.get(key)
        if ids is None:
            # miss against the frozen column; fills the frozen map, which
            # the parent still shares while no mutation has landed (same
            # version ⇒ same data) and owns exclusively afterwards.
            col = self._relations[rel_name].column(attr)
            ids = self._store._dict_for(attr).extend_encode(col)
            self._enc_cols[key] = ids
        return ids

    def column_moments(self, col: str) -> Tuple[float, float, int]:
        if col in self._moments:
            return self._moments[col]
        out = _column_moments(self._relations, col)
        # Lock-free fill of the map shared with the parent: a concurrent
        # parent append either swaps the map (this write lands in the
        # orphaned copy, lost) or folds this value forward with the delta
        # rows (correct) — lost-or-correct, never wrong.
        self._moments[col] = out
        return out

    # -- FD catalog (frozen) ---------------------------------------------------
    def fds(self) -> List[FunctionalDependency]:
        return list(self._fds_map.values())

    def fd_reduction(self, cat: Sequence[str]) -> FDReduction:
        return _fd_reduction(self._relations, self._fds_map, self._red_cache, cat)

    # -- aggregate entry points ------------------------------------------------
    def flush(self, names: Optional[Sequence[str]] = None) -> Dict[str, int]:
        """Lazy-maintenance read barrier, snapshot flavour: forwards to the
        parent while current (a drain folds caches without changing any
        data, so currency survives it); a no-op with zero stats on a stale
        snapshot, whose frozen catalog needs no cache maintenance."""
        if self.is_current:
            return self._store.flush(names)
        return dict(_NO_DRAIN)

    def sufficient_stats(
        self,
        vorder: "VariableOrder",
        features: Sequence[str],
        label: Optional[str] = None,
        categorical: Sequence[str] = (),
        backend: Optional[str] = None,
        refresh: bool = False,
        reduce_fds: bool = False,
        device="cuda",
    ):
        """See :meth:`Store.sufficient_stats` — the same routing against
        this frozen view (cached via the parent while current, computed
        over the frozen catalog once stale)."""
        return _sufficient_stats(
            self, vorder, features, label, categorical, backend, refresh,
            reduce_fds, device,
        )

    def cofactors(
        self,
        vorder: "VariableOrder",
        features: Sequence[str],
        backend: str = "torch",
        refresh: bool = False,
        device="cuda",
    ) -> "Cofactors":
        """Unscaled cofactors at this snapshot's version.  While the
        snapshot is current this is exactly the parent's cached entry;
        once the parent has moved on it is a fresh uncached compute over
        the frozen catalog (the parent's result cache holds newer data)."""
        if self.is_current:
            return self._store.cofactors(
                vorder, features, backend=backend, refresh=refresh,
                device=device,
            )
        from .factorize import FactorizedEngine

        self._register_vorder(vorder.signature(), vorder)
        return FactorizedEngine(
            self, vorder, list(features), backend=backend, device=device
        ).cofactors()

    def cat_cofactors(
        self,
        vorder: "VariableOrder",
        cont: Sequence[str],
        cat: Sequence[str],
        backend: str = "numpy",
        refresh: bool = False,
        reduce_fds: bool = False,
        device="cuda",
    ):
        if self.is_current:
            return self._store.cat_cofactors(
                vorder,
                cont,
                cat,
                backend=backend,
                refresh=refresh,
                reduce_fds=reduce_fds,
                device=device,
            )
        from .categorical import cat_cofactors_factorized

        red = self.fd_reduction(cat) if reduce_fds else None
        run_cat = list(red.kept) if red is not None else list(cat)
        stats: Dict[str, int] = {}
        out = cat_cofactors_factorized(
            self,
            vorder,
            list(cont),
            run_cat,
            backend=backend,
            stats=stats,
            device=device,
        )
        self._store.cat_passes += stats["passes"]
        self._store.cat_node_visits += stats["node_visits"]
        return out

    def materialize_join(
        self, names: Optional[Sequence[str]] = None
    ) -> Relation:
        return _materialize(self._relations, names)

    def cache_info(self) -> Dict[str, int]:
        return self._store.cache_info()


def _materialize(
    relations: Dict[str, Relation], names: Optional[Sequence[str]]
) -> Relation:
    todo = [relations[n] for n in (names or list(relations))]
    if not todo:
        raise ValueError("no relations to join")
    acc = todo.pop(0)
    while todo:
        pick = None
        for i, rel in enumerate(todo):
            if set(acc.keys) & set(rel.keys):
                pick = i
                break
        if pick is None:  # genuine cross product required
            pick = 0
        acc = _join_pair(acc, todo.pop(pick))
    return acc


def _join_pair(left: Relation, right: Relation) -> Relation:
    shared = sorted(set(left.keys) & set(right.keys))
    if shared:
        doms = [max(left.domains[a], right.domains[a]) for a in shared]
        # join_keys falls back to the dictionary-encoded hash join when the
        # mixed-radix product of the shared domains overflows int64 (many /
        # wide shared attributes), keeping strict composite keys otherwise.
        lk, rk = join_keys(
            [left.keys[a] for a in shared],
            [right.keys[a] for a in shared],
            doms,
        )
        il, ir = sort_merge_join(lk, rk)
    else:  # cross product
        nl, nr = left.num_rows, right.num_rows
        il = np.repeat(np.arange(nl, dtype=np.int64), nr)
        ir = np.tile(np.arange(nr, dtype=np.int64), nl)

    keys = {a: c[il] for a, c in left.keys.items()}
    for a, c in right.keys.items():
        if a not in keys:
            keys[a] = c[ir]
    values = {a: c[il] for a, c in left.values.items()}
    for a, c in right.values.items():
        if a not in values:
            values[a] = c[ir]
    # merge domains per attribute with max: the join key above was built with
    # max(left, right), so keeping a smaller domain here would desynchronize
    # later composite_key calls on the joined relation.
    domains = dict(right.domains)
    for a, d in left.domains.items():
        domains[a] = max(d, domains.get(a, 0))
    return Relation(
        name=f"({left.name}⋈{right.name})",
        keys=keys,
        values=values,
        domains=domains,
    )
