"""The in-memory database: a catalog of relations plus a natural-join planner.

Plays the role HyPer plays in the paper — it *holds* the training data that
the factorized engine aggregates.  ``materialize_join`` is the
non-factorized ("noPre") path: it computes the flat natural join against
which factorization is benchmarked.

This is the store's read surface:

* the catalog (``put`` / ``get`` / ``names`` / ``relations`` /
  ``total_rows`` / ``attr_domain``);
* **append-only attribute dictionaries** — every attribute's value↔id
  mapping is global to the store and only ever *extended* (new values get
  fresh ids at the end, in first-seen order), plus an encoded-column
  cache, so engine construction over unchanged relations never rescans
  them;
* per-column moments (``column_moments``) for feature scaling;
* ``snapshot`` — an O(1) frozen read view (catalog maps are replaced on
  ``put``, never mutated);
* the cumulative traversal counters ``passes`` / ``node_visits`` that
  every engine traversal against the store increments;
* the **functional-dependency catalog** (``add_fd`` / ``infer_fds`` /
  ``fds`` / ``drop_fd``) and the memoized ``fd_reduction`` planner that
  the categorical solve reads; ``put`` re-verifies every FD touching the
  replaced relation.

Appends (and with them the FD re-check of each appended delta), the
pending-delta log, the result caches and the persistent view cache belong
to later parts of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .fd import FDReduction, FunctionalDependency, reduction_plan, witnessed_mapping
from .relation import Relation, join_keys, sort_merge_join

__all__ = ["Store", "StoreSnapshot"]


class _AttrDict:
    """Append-only global dictionary of one attribute's values.

    ``values[i]`` is the i-th distinct value ever seen (first-seen order;
    sorting would renumber existing ids when a later value lands in the
    middle).  ``extend_encode`` folds a column in, assigning fresh trailing
    ids to unseen values, and returns the column's int32 ids.  Lookup is
    vectorized against a sorted snapshot (``searchsorted``).  ``values`` is
    replaced (never mutated) on growth, so captured references stay valid.
    """

    __slots__ = ("values", "_sorted_vals", "_sorted_ids")

    def __init__(self) -> None:
        self.values = np.zeros(0, dtype=np.float64)
        self._sorted_vals = np.zeros(0, dtype=np.float64)  # values, sorted
        self._sorted_ids = np.zeros(0, dtype=np.int64)  # ids aligned above

    def extend_encode(self, col: np.ndarray) -> np.ndarray:
        col = np.asarray(col, dtype=np.float64)
        if not len(col):
            return np.zeros(0, dtype=np.int32)
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


class Store:
    """Catalog of named relations with natural-join materialization."""

    def __init__(self, relations: Optional[Sequence[Relation]] = None) -> None:
        self._relations: Dict[str, Relation] = {}
        # attr -> append-only global dictionary; (rel, attr) -> cached ids
        self._dicts: Dict[str, _AttrDict] = {}
        self._enc_cols: Dict[Tuple[str, str], np.ndarray] = {}
        # col -> (sum, max|x|, count) over the union of relations with col
        self._moments: Dict[str, Tuple[float, float, int]] = {}
        # functional-dependency catalog: (lhs, rhs) -> FD with its witnessed
        # id mapping.  Declared FDs are contracts; inferred ones are dropped
        # when a put falsifies them.  The reduction-plan memo is cleared
        # whenever the catalog changes (``_set_fds``).
        self._fds: Dict[Tuple[str, str], FunctionalDependency] = {}
        self._red_cache: Dict[tuple, FDReduction] = {}
        # cumulative counters over EVERY engine traversal of this store
        self.passes = 0
        self.node_visits = 0
        self.version = 0
        for rel in relations or ():
            self.put(rel)

    # -- attribute dictionaries (append-only, store-global) --------------------
    def _dict_for(self, attr: str) -> _AttrDict:
        d = self._dicts.get(attr)
        if d is None:
            d = self._dicts[attr] = _AttrDict()
        return d

    def attr_encoding(self, rel_name: str, attr: str) -> np.ndarray:
        """int32 ids of ``rel_name``'s column ``attr`` under the store's
        append-only dictionary (cached per column)."""
        key = (rel_name, attr)
        ids = self._enc_cols.get(key)
        if ids is None:
            col = self._relations[rel_name].column(attr)
            ids = self._enc_cols[key] = self._dict_for(attr).extend_encode(col)
        return ids

    def attr_values_array(self, attr: str) -> np.ndarray:
        """id -> value translation array of ``attr``'s global dictionary."""
        return self._dict_for(attr).values

    def reset_counters(self) -> None:
        self.passes = 0
        self.node_visits = 0

    # -- catalog -------------------------------------------------------------
    def put(self, rel: Relation) -> None:
        """Insert or replace a relation.  Copy-on-write: the catalog, FD,
        moments and encoded-column maps are *replaced*, never mutated, so a
        :class:`StoreSnapshot` taken before the call keeps the old state.
        The global dictionaries are never rebuilt (append-only forever).

        Every FD touching the relation's attributes is re-verified from
        scratch: a declared FD that no longer holds raises (and the catalog
        is left as it was); an inferred one is dropped."""
        old = self._relations.get(rel.name)
        old_relations = self._relations
        touched = set(rel.keys) | set(old.keys if old else ())
        stale_fds = [
            key for key in self._fds if key[0] in touched or key[1] in touched
        ]
        # install the new catalog map first so re-verification sees the
        # post-put data; a declared-FD violation restores the old map
        self._relations = {**old_relations, rel.name: rel}
        new_fds = dict(self._fds)
        for key in stale_fds:
            try:
                dom = self.attr_domain(key[0])
            except ValueError:  # lhs attribute vanished from the catalog
                dom = 0
            mapping = (
                witnessed_mapping(self.relations(), key[0], key[1], dom)
                if dom
                else None
            )
            if mapping is not None:
                new_fds[key] = dataclasses.replace(new_fds[key], mapping=mapping)
            elif self._fds[key].source == "declared":
                self._relations = old_relations
                raise ValueError(
                    f"put({rel.name!r}) violates declared FD "
                    f"{key[0]} → {key[1]}"
                )
            else:
                del new_fds[key]
        if stale_fds:
            self._set_fds(new_fds)
        self.version += 1
        stale_attrs = set(rel.attributes) | set(old.attributes if old else ())
        self._moments = {
            k: v for k, v in self._moments.items() if k not in stale_attrs
        }
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
        domain over all relations carrying it."""
        return _attr_domain(self._relations, attr)

    def column_moments(self, col: str) -> Tuple[float, float, int]:
        """(sum, max|x|, count) of ``col`` over the union of relations that
        contain it — computed once, dropped by ``put``."""
        out = self._moments.get(col)
        if out is None:
            out = self._moments[col] = _column_moments(self._relations, col)
        return out

    # -- functional dependencies ----------------------------------------------
    def add_fd(self, lhs: str, rhs: str) -> FunctionalDependency:
        """Declare the functional dependency ``lhs → rhs`` between two
        dictionary-encoded key attributes.  Verified against the data now
        (raises if no relation witnesses the pair or any witness violates
        functionality) and re-checked on every ``put``."""
        mapping = witnessed_mapping(
            self.relations(), lhs, rhs, self.attr_domain(lhs)
        )
        if mapping is None:
            raise ValueError(
                f"functional dependency {lhs} → {rhs} does not hold (or no "
                "relation contains both attributes as keys)"
            )
        fd = FunctionalDependency(lhs, rhs, mapping, "declared")
        self._set_fds({**self._fds, (lhs, rhs): fd})
        return fd

    def infer_fds(
        self, attrs: Optional[Sequence[str]] = None
    ) -> List[Tuple[str, str]]:
        """Scan the catalog for candidate FDs ``f → g`` and register every
        verified one as *inferred*.

        Candidates are ordered pairs of key attributes co-located in at
        least one relation — the only pairs whose FD status is decidable
        without computing the join (and, by the projection argument in
        ``repro_torch.core.fd``, exactly the witnesses that make the FD
        sound on the join result).  ``attrs`` restricts the candidate
        universe.  Returns the newly registered (lhs, rhs) pairs.
        """
        universe = set(attrs) if attrs is not None else None
        pairs: Dict[Tuple[str, str], None] = {}
        for rel in self._relations.values():
            keys = [a for a in rel.keys if universe is None or a in universe]
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
            self._set_fds(new_fds)
        return found

    def fds(self) -> List[FunctionalDependency]:
        return list(self._fds.values())

    def drop_fd(self, lhs: str, rhs: str) -> None:
        if (lhs, rhs) in self._fds:
            self._set_fds(
                {k: v for k, v in self._fds.items() if k != (lhs, rhs)}
            )

    def _set_fds(self, fds: Dict[Tuple[str, str], FunctionalDependency]) -> None:
        """Install a new FD catalog map (copy-on-write); memoized reduction
        plans are stale."""
        self._fds = fds
        self._red_cache = {}

    def fd_reduction(self, cat: Sequence[str]) -> FDReduction:
        """The FD reduction of a categorical attribute list under the
        current catalog: which attributes a solver can drop (they are
        functionally determined by an earlier one) and the id maps needed
        to recover their coefficients in closed form.  Memoized per
        (cat list, domains) until the FD catalog changes."""
        return _fd_reduction(self._relations, self._fds, self._red_cache, cat)

    # -- snapshots -------------------------------------------------------------
    def snapshot(self) -> "StoreSnapshot":
        """An immutable read view of the catalog at the current version."""
        return StoreSnapshot(self)

    # -- natural join (the noPre path) ----------------------------------------
    def materialize_join(
        self, names: Optional[Sequence[str]] = None
    ) -> Relation:
        """Materialize the natural join of ``names`` (default: all
        relations), joining pairwise and preferring joins with at least one
        shared attribute."""
        return _materialize(self._relations, names)


class StoreSnapshot:
    """Read-only view of a :class:`Store` frozen at one catalog version.

    Shares the parent's append-only dictionaries (ids never renumber, so
    later growth is invisible to the ids this snapshot produces) and
    forwards the ``passes`` / ``node_visits`` counters to the parent, so
    store totals stay the audit source of truth.
    """

    def __init__(self, store: Store) -> None:
        self._store = store
        self.version = store.version
        self._relations = store._relations
        self._enc_cols = store._enc_cols
        self._moments = store._moments
        self._fds_map = store._fds
        self._red_cache: Dict[tuple, FDReduction] = {}

    @property
    def is_current(self) -> bool:
        """True while no catalog mutation has landed on the parent."""
        return self.version == self._store.version

    def snapshot(self) -> "StoreSnapshot":
        return self  # already frozen

    # -- counters (forwarded) --------------------------------------------------
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
        return self._store.attr_values_array(attr)

    def attr_encoding(self, rel_name: str, attr: str) -> np.ndarray:
        key = (rel_name, attr)
        ids = self._enc_cols.get(key)
        if ids is None:
            # fills the frozen map, which the parent shares until its next
            # put (same version ⇒ same data)
            col = self._relations[rel_name].column(attr)
            ids = self._store._dict_for(attr).extend_encode(col)
            self._enc_cols[key] = ids
        return ids

    def column_moments(self, col: str) -> Tuple[float, float, int]:
        out = self._moments.get(col)
        if out is None:
            out = self._moments[col] = _column_moments(self._relations, col)
        return out

    # -- FD catalog (frozen) ---------------------------------------------------
    def fds(self) -> List[FunctionalDependency]:
        return list(self._fds_map.values())

    def fd_reduction(self, cat: Sequence[str]) -> FDReduction:
        return _fd_reduction(self._relations, self._fds_map, self._red_cache, cat)

    def materialize_join(
        self, names: Optional[Sequence[str]] = None
    ) -> Relation:
        return _materialize(self._relations, names)


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
    # merge domains per attribute with max: the join key above was built
    # with max(left, right), so later composite keys stay in sync.
    domains = dict(right.domains)
    for a, d in left.domains.items():
        domains[a] = max(d, domains.get(a, 0))
    return Relation(
        name=f"({left.name}⋈{right.name})",
        keys=keys,
        values=values,
        domains=domains,
    )
