"""Per-relation pending-delta log — the write side of lazy maintenance.

``Store.append`` (in its default ``maintenance="lazy"`` mode) does no
view-cache or cofactor folding on the write path: it validates FDs,
concatenates the relation, and records the append here — O(delta) metadata
work, independent of how many cached entries cover the relation.  The log
is **metadata only**: ``Relation.concat`` appends rows in order, so the
stacked pending delta of a relation is exactly the row range
``merged[base_rows:]`` of the merged relation already in the catalog, and
the frozen pre-append prefix is ``merged[:base_rows]``.  No delta rows are
copied or retained by the log itself.

Reads drain the log (``Store.flush`` / ``Store._drain_all``): every cached
entry covering a pending relation is folded once with the relation's
*stacked* delta — however many appends piled up, one fold pays for all of
them (union commutativity, Prop. 4.1: the deltas' cofactors sum, so their
concatenation folds in one engine pass).  Compaction is the escape hatch
for the crossover point where folding a huge stacked delta costs more
than recomputing from the merged base: past a size threshold the store
invalidates the covered entries and clears the log instead.

Counters (``drains`` / ``drained_rows`` / ``compactions``) feed
``Store.cache_info`` so benchmarks and tests can audit the write path:
a lazy append must leave ``pending_rows`` > 0 and every engine counter
untouched.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

__all__ = ["DeltaLog", "RelationLog"]


@dataclasses.dataclass
class RelationLog:
    """Pending-append record of ONE relation (metadata only).

    ``base_rows``     row count of the relation when its FIRST pending
                      append landed — the catalog rows ``[:base_rows]``
                      are the frozen pre-append prefix, ``[base_rows:]``
                      the stacked delta.
    ``first_version`` store version just before the first pending append
                      (every surviving cache entry covering the relation
                      is stamped at most here — the fold precondition).
    ``appends``       number of stacked appends.
    ``rows``          total pending delta rows (merged rows − base_rows).
    """

    base_rows: int
    first_version: int
    appends: int = 0
    rows: int = 0


class DeltaLog:
    """The store's pending-append bookkeeping, one record per relation
    with unfolded deltas.  Insertion order is preserved (dict semantics):
    ``Store._drain_all`` folds relations in first-pending order, freezing
    later pending relations to their pre-append prefixes so the
    multi-relation telescoping sum is exact."""

    def __init__(self) -> None:
        self._logs: Dict[str, RelationLog] = {}
        # cumulative audit counters (surfaced via Store.cache_info)
        self.drains = 0  # completed _drain_all passes
        self.drained_rows = 0  # delta rows folded by drains
        self.compactions = 0  # logs cleared by the size threshold

    def __bool__(self) -> bool:
        return bool(self._logs)

    def __len__(self) -> int:
        return len(self._logs)

    def __contains__(self, name: str) -> bool:
        return name in self._logs

    def record(
        self, name: str, base_rows: int, delta_rows: int, version: int
    ) -> RelationLog:
        """Record one append of ``delta_rows`` rows onto ``name`` whose
        pre-append row count was ``base_rows`` at store ``version``.
        Stacks onto an existing record (base_rows/first_version keep their
        first-append values — the fold boundary never moves)."""
        log = self._logs.get(name)
        if log is None:
            log = self._logs[name] = RelationLog(
                base_rows=base_rows, first_version=version
            )
        log.appends += 1
        log.rows += delta_rows
        return log

    def get(self, name: str) -> RelationLog:
        return self._logs[name]

    def pending(self, name: str) -> int:
        """Pending delta rows of ``name`` (0 when fully folded)."""
        log = self._logs.get(name)
        return log.rows if log is not None else 0

    def names(self) -> List[str]:
        """Relations with pending deltas, in first-pending order."""
        return list(self._logs)

    def items(self) -> List[Tuple[str, RelationLog]]:
        """Snapshot of (name, record) pairs in first-pending order — safe
        to clear entries while iterating."""
        return list(self._logs.items())

    def clear(self, name: str, drained: bool = False) -> None:
        """Drop ``name``'s record — after a successful fold
        (``drained=True``, counted) or because the entries it would have
        maintained were invalidated instead (compaction / put / error)."""
        log = self._logs.pop(name, None)
        if log is not None and drained:
            self.drained_rows += log.rows

    def total_rows(self) -> int:
        return sum(log.rows for log in self._logs.values())

    def debt(self) -> Tuple[int, int]:
        """(pending relations, pending rows) — the cheap should-I-run
        probe a background fold can poll between idle windows."""
        return len(self._logs), self.total_rows()

    def total_appends(self) -> int:
        return sum(log.appends for log in self._logs.values())

    def info(self) -> Dict[str, int]:
        return {
            "pending_relations": len(self._logs),
            "pending_rows": self.total_rows(),
            "pending_appends": self.total_appends(),
            "drains": self.drains,
            "drained_rows": self.drained_rows,
            "compactions": self.compactions,
        }
