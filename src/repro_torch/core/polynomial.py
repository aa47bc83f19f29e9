"""Beyond-paper: degree-d factorized **polynomial** regression.

The paper's conclusion names polynomial regression as future work: "The added
complexity increases the gain from factorized representations even more."
This module generalizes the degree-≤2 block algebra of ``factorize.py`` to
arbitrary degree d by representing each view's aggregates as a dictionary

    monomial (sorted tuple of feature names, len ≤ d)  →  [N] tensor

Combining children is monomial convolution (Σ over splits with total degree
≤ d), and aggregating out feature A multiplies in powers x_A^e.  The host
loops over monomial *pairs* (tiny — the data math stays vectorized), so this
path is intended for the moderate feature counts where polynomial models are
used; the dense degree-2 engine remains the fast path.

The aggregates are float64 tensors on ``device`` (``"cuda"`` unless the
caller asks for the CPU); the structure work — dictionary encoding, the
joins of ``_combine`` and the group keys of ``_aggregate_out`` — stays on
host numpy, as in the quadratic engine.  Each GROUP BY sums all of a view's
monomials in one ``segment_blocks`` call (``()`` as the count block, the
rest as the columns of one ``[N, W]`` block): the segment-reduce kernel on
the card, its plain version on the CPU.  Where every group has one row, the
call passes each group's row (the kernel's gather path).

Training: a degree-d polynomial model is a *linear* model over the expanded
monomial features, so the cofactor trick applies verbatim — the cofactor
matrix over monomials-of-degree-≤d requires aggregates up to degree 2d.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..kernels import ops as kernel_ops
from .factorize import Cofactors
from .relation import group_key, join_keys, sort_merge_join
from .store import Store
from .variable_order import INTERCEPT, VariableOrder, validate

Monomial = Tuple[str, ...]  # sorted tuple of feature names, with repetition

__all__ = ["polynomial_aggregates", "polynomial_cofactors", "expand_monomials"]


@dataclasses.dataclass
class _PolyView:
    keys: Dict[str, np.ndarray]  # host int32 ids
    aggs: Dict[Monomial, torch.Tensor]  # () -> count; ('x',) -> Σx; ('x','x') ...

    @property
    def num_rows(self) -> int:
        return len(next(iter(self.aggs.values())))


class _PolyEngine:
    def __init__(
        self,
        store: Store,
        vorder: VariableOrder,
        features: Sequence[str],
        degree: int,
        device="cuda",
    ) -> None:
        validate(vorder, store)
        if degree < 1:
            raise ValueError("degree must be >= 1")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "polynomial aggregates run on device='cuda' by default and "
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU"
            )
        self.store = store
        self.vorder = vorder
        self.features = list(features)
        self.degree = degree
        self._encode()

    def _encode(self) -> None:
        cols: Dict[str, List[Tuple[str, np.ndarray]]] = {}
        for rn in self.vorder.relations():
            rel = self.store.get(rn)
            for attr in rel.attributes:
                cols.setdefault(attr, []).append((rn, rel.column(attr)))
        self.domains: Dict[str, int] = {}
        self.attr_values: Dict[str, np.ndarray] = {}
        self.encoded: Dict[Tuple[str, str], np.ndarray] = {}
        for attr, entries in cols.items():
            allv = np.concatenate([c.astype(np.float64) for _, c in entries])
            uniq, inv = np.unique(allv, return_inverse=True)
            self.domains[attr] = len(uniq)
            self.attr_values[attr] = uniq
            off = 0
            for rn, c in entries:
                self.encoded[(rn, attr)] = inv[off : off + len(c)].astype(np.int32)
                off += len(c)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def run(self) -> Dict[Monomial, float]:
        view = self._process(self.vorder)
        if view.num_rows != 1:
            raise AssertionError("root view must have one row")
        vals = torch.cat(list(view.aggs.values())).cpu().tolist()
        return dict(zip(view.aggs, vals))

    def _process(self, node: VariableOrder) -> _PolyView:
        if node.is_relation:
            rel = self.store.get(node.relation)
            keys = {a: self.encoded[(node.relation, a)] for a in rel.attributes}
            ones = torch.ones(
                (rel.num_rows,), dtype=torch.float64, device=self.device
            )
            return _PolyView(keys=keys, aggs={(): ones})
        views = [self._process(ch) for ch in node.children]
        view = views[0]
        for other in views[1:]:
            view = self._combine(view, other)
        if node.name == INTERCEPT:
            return view
        if node.name in self.features:
            view = self._extend(view, node.name)
        return self._aggregate_out(view, node.name)

    def _combine(self, v1: _PolyView, v2: _PolyView) -> _PolyView:
        shared = sorted(set(v1.keys) & set(v2.keys))
        if shared:
            doms = [self.domains[a] for a in shared]
            # hash-join fallback past the int64 radix limit, same as the
            # quadratic engine's _combine and Store._join_pair
            k1, k2 = join_keys(
                [v1.keys[a] for a in shared],
                [v2.keys[a] for a in shared],
                doms,
            )
            i1, i2 = sort_merge_join(k1, k2)
        else:
            n1, n2 = v1.num_rows, v2.num_rows
            i1 = np.repeat(np.arange(n1, dtype=np.int64), n2)
            i2 = np.tile(np.arange(n2, dtype=np.int64), n1)
        keys = {a: c[i1] for a, c in v1.keys.items()}
        for a, c in v2.keys.items():
            keys.setdefault(a, c[i2])
        t1, t2 = self._tensor(i1), self._tensor(i2)
        a2i = {m2: a2[t2] for m2, a2 in v2.aggs.items()}
        aggs: Dict[Monomial, torch.Tensor] = {}
        for m1, a1 in v1.aggs.items():
            a1i = a1[t1]
            for m2, a2 in a2i.items():
                if len(m1) + len(m2) > self.degree:
                    continue
                m = tuple(sorted(m1 + m2))
                prod = a1i * a2
                aggs[m] = aggs[m] + prod if m in aggs else prod
        return _PolyView(keys=keys, aggs=aggs)

    def _extend(self, view: _PolyView, attr: str) -> _PolyView:
        x = self._tensor(self.attr_values[attr][np.asarray(view.keys[attr])])
        aggs: Dict[Monomial, torch.Tensor] = {}
        for m, a in view.aggs.items():
            xe = torch.ones_like(x)
            for e in range(self.degree - len(m) + 1):
                mm = tuple(sorted(m + (attr,) * e))
                contrib = a * xe
                aggs[mm] = aggs[mm] + contrib if mm in aggs else contrib
                xe = xe * x
        return _PolyView(keys=view.keys, aggs=aggs)

    def _aggregate_out(self, view: _PolyView, attr: str) -> _PolyView:
        remaining = sorted(set(view.keys) - {attr})
        n = view.num_rows
        order = None
        if remaining:
            doms = [self.domains[a] for a in remaining]
            # group_key: a GROUP BY only needs within-call injectivity, so
            # wide key sets densify instead of overflowing (as in factorize)
            key = group_key([view.keys[a] for a in remaining], doms)
            uniq, first, inv = np.unique(
                key, return_index=True, return_inverse=True
            )
            num = len(uniq)
            keys = {a: view.keys[a][first] for a in remaining}
            seg = inv
            if num == n:  # one row a group: each group's row is its first
                order = first
        else:
            seg = np.zeros((n,), dtype=np.int64)
            num, keys = 1, {}
        # every monomial of the view in one segmented sum: () is the count
        # block, the others the columns of one [N, W] block
        monos = [m for m in view.aggs if m != ()]
        lin = (
            torch.stack([view.aggs[m] for m in monos], dim=1)
            if monos
            else None
        )
        c, l, _ = kernel_ops.segment_blocks(
            view.aggs[()], lin, None, seg, num,
            degree=1 if monos else 0, order=order,
        )
        cols = {m: l[:, j] for j, m in enumerate(monos)}
        aggs = {m: c if m == () else cols[m] for m in view.aggs}
        return _PolyView(keys=keys, aggs=aggs)


def polynomial_aggregates(
    store: Store,
    vorder: VariableOrder,
    features: Sequence[str],
    degree: int,
    device="cuda",
) -> Dict[Monomial, float]:
    """All SUM(Π monomial) aggregates of degree ≤ ``degree`` over the join,
    computed in float64 on ``device``."""
    return _PolyEngine(store, vorder, features, degree, device=device).run()


def expand_monomials(features: Sequence[str], degree: int) -> List[Monomial]:
    """All monomials of degree 1..degree over ``features`` (with repetition)."""
    out: List[Monomial] = []
    for d in range(1, degree + 1):
        out.extend(itertools.combinations_with_replacement(sorted(features), d))
    return out


def polynomial_cofactors(
    store: Store,
    vorder: VariableOrder,
    features: Sequence[str],
    label: str,
    degree: int,
    device="cuda",
) -> Cofactors:
    """Cofactor matrix for degree-d polynomial regression over the join.

    The expanded feature list is all monomials of degree ≤ d plus the label;
    entries require join aggregates up to degree 2d — computed factorized.
    """
    monos = expand_monomials(features, degree)
    aggs = polynomial_aggregates(
        store, vorder, list(features) + [label], 2 * degree, device=device
    )
    cols: List[str] = ["*".join(m) for m in monos] + [label]
    terms: List[Monomial] = monos + [(label,)]
    k = len(terms)
    lin = np.zeros((k,))
    quad = np.zeros((k, k))
    for i, mi in enumerate(terms):
        lin[i] = aggs[tuple(sorted(mi))]
        for j, mj in enumerate(terms):
            quad[i, j] = aggs[tuple(sorted(mi + mj))]
    return Cofactors(count=aggs[()], lin=lin, quad=quad, features=cols)
