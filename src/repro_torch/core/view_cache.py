"""Persistent cross-batch view cache — store-owned per-node engine views.

``FactorizedEngine.run_batch`` memoizes per-node partial views for the
duration of ONE batch; this module promotes that memo to a **store-owned,
cross-batch** cache (the AC/DC direction: reuse aggregates *across* calls
and maintain them incrementally under updates).  Successive engine batches
over overlapping attribute sets — warm retrains, FD on/off comparisons,
per-attribute sweeps — reuse finished subtree descents instead of
recomputing them.

Keying.  A view is identified by :class:`ViewKey`:

  ``vorder_sig``  structural signature of the variable order (two orders
                  with the same shape share entries, whatever Python
                  objects they are),
  ``backend`` / ``dtype``  the value-math configuration (torch fp32 views
                  never alias numpy fp64 oracle views),
  ``node``        the node's *preorder index* within the order — stable
                  across engine instances, unlike ``id(node)``,
  ``feats``       the (sorted) engine features present in the node's
                  subtree — engines with different global feature lists
                  share every subtree that sees the same feature subset,
  ``keep``        the live group-attribute subset at the node,
  ``degree``      the monomial degree the view was evaluated at (a cached
                  degree-2 view serves degree-0/1 requests by trimming).

Validity.  Entries are stamped with the store version they were built (or
last folded) at, and the owning store wires its per-relation watermark map
into ``watermarks`` — an entry is valid iff its stamp is >= the watermark
of every relation its subtree covers.  That distinguishes three states:
*valid* (no covered relation mutated since the stamp), *stale but
foldable* (a covered relation has pending appended rows — the store's
drain folds the entry with a delta view, union commutativity Prop. 4.1,
and restamps it; see ``Store._maintain_view_cache``), and *invalid*
(``put`` replaced a covered relation — those entries are dropped
outright).  A watermark-violating entry found by ``get`` is dropped on
sight as the backstop against drain-rule bugs.  Without a ``watermarks``
map the cache falls back to exact version equality (standalone use).

Eviction.  The cache is bytes-accounted with LRU eviction.  A view's value
blocks may be torch tensors on the card: their bytes are counted from the
tensor's metadata (``numel() * element_size()``), never by copying them to
the host.  This module is deliberately free of engine imports — views are
opaque objects with ``keys``/``c``/``l``/``q`` array attributes.

Thread safety.  Every structural operation (get / put / replace /
discard / invalidate / eviction) and the hit/miss counters run under one
internal re-entrant lock, so the OrderedDict and the byte accounting stay
consistent when one thread invalidates entries while another publishes.
Views themselves are immutable once stored, so returning one outside the
lock is safe.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, FrozenSet, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

__all__ = ["DEFAULT_MAX_BYTES", "ViewCache", "ViewKey", "view_nbytes"]

#: Default eviction budget — generous for test/bench scale, small enough
#: that a sweep over many variable orders cannot grow unbounded.
DEFAULT_MAX_BYTES = 256 << 20


class ViewKey(NamedTuple):
    """Identity of one cached per-node view (see module docstring)."""

    vorder_sig: tuple
    backend: str
    dtype: str
    node: int  # preorder index of the node within the variable order
    feats: Tuple[str, ...]  # sorted features present in the node's subtree
    keep: FrozenSet[str]  # live group attributes at the node
    degree: int


def _arr_nbytes(arr) -> int:
    """Resident bytes of one block: a tensor (on any device) from its
    metadata, a host array from its own ``nbytes``."""
    if arr is None:
        return 0
    if isinstance(arr, torch.Tensor):
        return arr.numel() * arr.element_size()
    return int(np.asarray(arr).nbytes)


def view_nbytes(view) -> int:
    """Approximate resident size of a ``_View`` (host keys + value blocks)."""
    n = 0
    for col in view.keys.values():
        n += _arr_nbytes(col)
    for arr in (view.c, view.l, view.q):
        n += _arr_nbytes(arr)
    return n


class _Entry:
    __slots__ = ("view", "relations", "version", "nbytes")

    def __init__(self, view, relations: frozenset, version: int, nbytes: int):
        self.view = view
        self.relations = relations
        self.version = version
        self.nbytes = nbytes


class ViewCache:
    """Bytes-accounted LRU cache of per-node factorized views.

    ``enabled=False`` turns the cache into a no-op sink (``get`` misses,
    ``put`` discards) without dropping already-stored entries — the
    ``use_view_cache=False`` escape hatch for a cold baseline.  Hit/miss
    counters are maintained by the *engine* (one logical probe may try
    several degrees); eviction counters here.
    """

    def __init__(
        self, max_bytes: int = DEFAULT_MAX_BYTES, enabled: bool = True
    ) -> None:
        self._entries: "OrderedDict[ViewKey, _Entry]" = OrderedDict()
        # re-entrant: put() discards subsumed entries while already locked
        self._mu = threading.RLock()
        self.max_bytes = int(max_bytes)
        self.enabled = enabled and self.max_bytes > 0
        self.bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        #: per-relation watermark map, aliased to the owning store's
        #: ``_rel_versions`` — when set, validity is the watermark rule
        #: (see module docstring) instead of exact version equality.
        self.watermarks: Optional[Dict[str, int]] = None

    def __len__(self) -> int:
        with self._mu:
            return len(self._entries)

    def reset_counters(self) -> None:
        """Zero the hit/miss/eviction counters under the cache lock."""
        with self._mu:
            self.hits = 0
            self.misses = 0
            self.evictions = 0

    def _valid(self, entry: _Entry, version: int) -> bool:
        wm = self.watermarks
        if wm is None:
            return entry.version == version
        return all(entry.version >= wm.get(r, 0) for r in entry.relations)

    def get(self, key: ViewKey, version: int):
        """The view under ``key`` valid at store ``version``, else None.
        An entry failing the validity rule is dropped on sight."""
        with self._mu:
            entry = self._entries.get(key)
            if entry is None:
                return None
            if not self._valid(entry, version):
                self.discard(key)
                return None
            self._entries.move_to_end(key)
            return entry.view

    def put(
        self,
        key: ViewKey,
        view,
        relations: frozenset,
        version: int,
        nbytes: Optional[int] = None,
    ) -> None:
        if nbytes is None:
            nbytes = view_nbytes(view)
        if nbytes > self.max_bytes:
            return  # single oversized view: never worth the whole budget
        with self._mu:
            self.discard(key)
            # a higher-degree view subsumes the lower-degree variants —
            # drop them so the budget isn't spent twice on the same subtree
            for d in range(key.degree):
                self.discard(key._replace(degree=d))
            self._entries[key] = _Entry(view, relations, version, nbytes)
            self.bytes += nbytes
            self._evict()

    def _evict(self) -> None:
        """LRU-evict until the byte budget holds.  The most recent entry
        (tail) is never popped: ``popitem(last=False)`` takes the head and
        the loop stops once a single entry remains."""
        with self._mu:
            while self.bytes > self.max_bytes and len(self._entries) > 1:
                _, old = self._entries.popitem(last=False)
                self.bytes -= old.nbytes
                self.evictions += 1

    def replace(
        self,
        key: ViewKey,
        view,
        nbytes: Optional[int] = None,
        version: Optional[int] = None,
    ) -> None:
        """Swap the view of an existing entry in place (delta fold),
        keeping its relations; no-op if absent.  ``version`` (if given)
        restamps the entry.  The entry counts as freshly used (moved to
        the LRU tail), and growth re-runs eviction so folds cannot creep
        past the byte budget."""
        with self._mu:
            entry = self._entries.get(key)
            if entry is None:
                return
            if nbytes is None:
                nbytes = view_nbytes(view)
            self.bytes += nbytes - entry.nbytes
            entry.view = view
            entry.nbytes = nbytes
            if version is not None:
                entry.version = version
            self._entries.move_to_end(key)
            self._evict()

    def discard(self, key: ViewKey) -> None:
        with self._mu:
            entry = self._entries.pop(key, None)
            if entry is not None:
                self.bytes -= entry.nbytes

    def note_hit(self) -> None:
        """Engine-side probe accounting, atomic under concurrent engines."""
        with self._mu:
            self.hits += 1

    def note_miss(self) -> None:
        with self._mu:
            self.misses += 1

    def items(self) -> List[Tuple[ViewKey, _Entry]]:
        """Snapshot of (key, entry) pairs — safe to mutate while iterating."""
        with self._mu:
            return list(self._entries.items())

    def invalidate_relation(self, name: str) -> None:
        """Drop every entry whose subtree covers relation ``name`` (the
        ``put`` rule).  Entries over unrelated subtrees survive."""
        with self._mu:
            for key in [
                k for k, e in self._entries.items() if name in e.relations
            ]:
                self.discard(key)

    def clear(self) -> None:
        with self._mu:
            self._entries.clear()
            self.bytes = 0

    def evict_all(self) -> int:
        """Evict every entry, counted as evictions — the fault-injection
        harness's cache-pressure storm, and an operator pressure valve."""
        with self._mu:
            n = len(self._entries)
            self._entries.clear()
            self.bytes = 0
            self.evictions += n
            return n

    def info(self) -> Dict[str, int]:
        with self._mu:
            return {
                "entries": len(self._entries),
                "bytes": self.bytes,
                "max_bytes": self.max_bytes,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
            }
