"""Columnar in-memory relations — the storage layer of the factorized engine.

The paper's "in-memory database system" (HyPer) becomes a columnar store of
host arrays whose value aggregation runs on the GPU:

  * join-key attributes are **dictionary encoded** to contiguous int32 ids
    (the domain is materialized once per attribute, like a DB dictionary),
  * numeric feature attributes are float arrays,
  * multi-attribute keys are packed into a single int64 **composite key**
    with mixed-radix encoding so joins and group-bys reduce to 1-D integer
    sort / searchsorted problems (sort-merge join), which vectorize cleanly.

Structural index computation (join indices, group ids) runs on the host with
numpy — the query-plan/executor role the DBMS plays in the paper — while all
value aggregation runs as torch tensor ops, on the card through the CUDA
kernels in ``repro_torch.kernels``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "Dictionary",
    "Relation",
    "composite_key",
    "group_key",
    "hash_join_keys",
    "join_keys",
    "radix_fits",
    "sort_merge_join",
    "group_ids",
    "segment_sum_np",
    "segment_sum_torch",
]


class Dictionary:
    """Dictionary encoding of one key attribute (value <-> dense int id)."""

    def __init__(self, values: Sequence) -> None:
        uniq = sorted(set(values))
        self._val_to_id = {v: i for i, v in enumerate(uniq)}
        self._id_to_val = list(uniq)

    def __len__(self) -> int:
        return len(self._id_to_val)

    def encode(self, values: Sequence) -> np.ndarray:
        return np.asarray([self._val_to_id[v] for v in values], dtype=np.int32)

    def decode(self, ids: Iterable[int]) -> list:
        return [self._id_to_val[int(i)] for i in ids]


@dataclasses.dataclass
class Relation:
    """A named columnar relation.

    ``keys``     : attr -> int32 array [n]   (dictionary-encoded join keys)
    ``values``   : attr -> float array  [n]  (numeric attributes / features)
    ``domains``  : attr -> domain size (for composite-key radix packing)
    """

    name: str
    keys: Dict[str, np.ndarray]
    values: Dict[str, np.ndarray]
    domains: Dict[str, int]

    def __post_init__(self) -> None:
        n = self.num_rows
        for attr, col in {**self.keys, **self.values}.items():
            if len(col) != n:
                raise ValueError(
                    f"relation {self.name}: column {attr} has {len(col)} rows, "
                    f"expected {n}"
                )
        for attr, col in self.keys.items():
            if attr not in self.domains:
                self.domains[attr] = int(col.max()) + 1 if len(col) else 1

    # -- construction -------------------------------------------------------
    @staticmethod
    def from_columns(
        name: str,
        key_cols: Mapping[str, Sequence],
        value_cols: Mapping[str, Sequence],
        domains: Optional[Mapping[str, int]] = None,
    ) -> "Relation":
        keys = {
            a: np.asarray(c, dtype=np.int32) for a, c in key_cols.items()
        }
        values = {
            a: np.asarray(c, dtype=np.float64) for a, c in value_cols.items()
        }
        doms = dict(domains or {})
        return Relation(name=name, keys=keys, values=values, domains=doms)

    # -- basic properties ----------------------------------------------------
    @property
    def num_rows(self) -> int:
        for col in self.keys.values():
            return len(col)
        for col in self.values.values():
            return len(col)
        return 0

    @property
    def attributes(self) -> List[str]:
        return list(self.keys) + list(self.values)

    def column(self, attr: str) -> np.ndarray:
        if attr in self.keys:
            return self.keys[attr]
        return self.values[attr]

    def select(self, idx: np.ndarray) -> "Relation":
        return Relation(
            name=self.name,
            keys={a: c[idx] for a, c in self.keys.items()},
            values={a: c[idx] for a, c in self.values.items()},
            domains=dict(self.domains),
        )

    def concat(self, other: "Relation") -> "Relation":
        """Row-wise union with ``other`` (same attribute sets required).

        Domains merge per attribute with ``max`` so existing dictionary ids
        stay valid and new ids from ``other`` extend the domain.
        """
        if set(other.keys) != set(self.keys) or set(other.values) != set(
            self.values
        ):
            raise ValueError(
                f"cannot concat {other.name} into {self.name}: attribute "
                f"sets differ ({sorted(other.attributes)} vs "
                f"{sorted(self.attributes)})"
            )
        keys = {
            a: np.concatenate([c, other.keys[a]]) for a, c in self.keys.items()
        }
        values = {
            a: np.concatenate([c, other.values[a]])
            for a, c in self.values.items()
        }
        domains = {
            a: max(self.domains.get(a, 0), other.domains.get(a, 0))
            for a in set(self.domains) | set(other.domains)
        }
        return Relation(self.name, keys, values, domains)

    def with_value(self, attr: str, col: np.ndarray) -> "Relation":
        values = dict(self.values)
        values[attr] = np.asarray(col, dtype=np.float64)
        return Relation(self.name, dict(self.keys), values, dict(self.domains))

    def rows(self) -> np.ndarray:
        """Materialize all columns as a dense [n, n_attr] float matrix."""
        cols = [self.column(a).astype(np.float64) for a in self.attributes]
        if not cols:
            return np.zeros((0, 0))
        return np.stack(cols, axis=1)


# ---------------------------------------------------------------------------
# Composite keys, joins, group-by: the host-side "query executor".
# ---------------------------------------------------------------------------

def composite_key(
    cols: Sequence[np.ndarray], domains: Sequence[int]
) -> np.ndarray:
    """Pack multiple int key columns into one int64 via mixed-radix encoding."""
    if not cols:
        raise ValueError("composite_key requires at least one column")
    if not radix_fits(domains):
        raise OverflowError("composite key domain exceeds int64 range")
    out = np.zeros_like(cols[0], dtype=np.int64)
    for col, dom in zip(cols, domains):
        out = out * max(int(dom), 1) + col.astype(np.int64)
    return out


def radix_fits(domains: Sequence[int]) -> bool:
    """Whether the mixed-radix domain product stays inside the int64 budget
    (``max // 4`` headroom) — the single overflow rule: ``composite_key``
    raises when this is False, ``join_keys`` switches to the hash join."""
    total = 1
    limit = np.iinfo(np.int64).max // 4
    for d in domains:
        total *= max(int(d), 1)
        if total > limit:
            return False
    return True


def hash_join_keys(
    left_cols: Sequence[np.ndarray], right_cols: Sequence[np.ndarray]
) -> Tuple[np.ndarray, np.ndarray]:
    """Dictionary-encoded join keys with no radix limit.

    Densifies the *concatenation* of both sides' key tuples to their
    observed uniques, so equal tuples receive equal codes **across both
    inputs** — the contract an equi-join needs.  Codes are call-local:
    never mix keys from different calls.
    """
    if not left_cols:
        raise ValueError("hash_join_keys requires at least one column")
    nl = len(left_cols[0])
    cols, doms = [], []
    for lc, rc in zip(left_cols, right_cols):
        col = np.concatenate([lc, rc]).astype(np.int64)
        cols.append(col)
        doms.append(int(col.max()) + 1 if len(col) else 1)
    key = group_key(cols, doms)
    return key[:nl], key[nl:]


def join_keys(
    left_cols: Sequence[np.ndarray],
    right_cols: Sequence[np.ndarray],
    domains: Sequence[int],
) -> Tuple[np.ndarray, np.ndarray]:
    """Join keys for a two-sided equi-join on the same attribute list:
    strict mixed-radix :func:`composite_key` while the domain product fits
    int64, :func:`hash_join_keys` past the limit."""
    if radix_fits(domains):
        return (
            composite_key(left_cols, domains),
            composite_key(right_cols, domains),
        )
    return hash_join_keys(left_cols, right_cols)


def group_key(
    cols: Sequence[np.ndarray], domains: Sequence[int]
) -> np.ndarray:
    """Injective-within-call key over multiple int columns.

    Like :func:`composite_key`, but only guarantees that equal tuples get
    equal codes *within this call* — the contract a GROUP BY needs — so
    when the mixed-radix product would overflow int64 it re-densifies the
    accumulated code to its observed uniques and keeps packing.  After
    densification the accumulated size is bounded by the row count, so
    ``rows · next_domain`` always fits int64.  NOT usable for joins.
    """
    if not cols:
        raise ValueError("group_key requires at least one column")
    limit = np.iinfo(np.int64).max // 4
    out = cols[0].astype(np.int64)
    size = max(int(domains[0]), 1)
    for col, dom in zip(cols[1:], domains[1:]):
        dom = max(int(dom), 1)
        if size > limit // dom:
            uniq, inv = np.unique(out, return_inverse=True)
            out = inv.astype(np.int64)
            size = max(len(uniq), 1)
        out = out * dom + col.astype(np.int64)
        size *= dom
    return out


def sort_merge_join(
    left_key: np.ndarray, right_key: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Equi-join two composite key columns.

    Returns index arrays ``(il, ir)`` of equal length M such that
    ``left_key[il] == right_key[ir]`` enumerates every matching pair —
    the classic sort + searchsorted merge join, fully vectorized.
    """
    order = np.argsort(right_key, kind="stable")
    rsorted = right_key[order]
    lo = np.searchsorted(rsorted, left_key, side="left")
    hi = np.searchsorted(rsorted, left_key, side="right")
    cnt = hi - lo
    il = np.repeat(np.arange(len(left_key)), cnt)
    if len(il) == 0:
        return il.astype(np.int64), il.astype(np.int64)
    starts = np.cumsum(cnt) - cnt
    within = np.arange(len(il)) - np.repeat(starts, cnt)
    ir = order[np.repeat(lo, cnt) + within]
    return il.astype(np.int64), ir.astype(np.int64)


def group_ids(key: np.ndarray) -> Tuple[np.ndarray, np.ndarray, int]:
    """Group rows by composite key: (unique_keys, inverse_ids, num_groups),
    ``inverse_ids`` being each row's dense group id (int32)."""
    uniq, inv = np.unique(key, return_inverse=True)
    return uniq, inv.astype(np.int32), len(uniq)


def segment_sum_np(data: np.ndarray, seg: np.ndarray, num: int) -> np.ndarray:
    """Host-side segment sum."""
    out = np.zeros((num,) + data.shape[1:], dtype=data.dtype)
    np.add.at(out, seg, data)
    return out


def segment_sum_torch(
    data: torch.Tensor, seg: torch.Tensor, num: int
) -> torch.Tensor:
    """Tensor segment sum over the leading axis (``index_add_``), on the
    device and in the dtype of ``data``."""
    seg = torch.as_tensor(seg, device=data.device).long()
    out = torch.zeros(
        (num,) + tuple(data.shape[1:]), dtype=data.dtype, device=data.device
    )
    return out.index_add_(0, seg, data)
