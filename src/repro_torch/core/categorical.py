"""Sparse categorical cofactors — group-by aggregates instead of one-hot.

AC/DC-style treatment of categorical features (Abo Khamis et al.; see
PAPERS.md): a categorical attribute c with domain D_c conceptually enters
the model as D_c one-hot columns, but every cofactor entry those columns
would produce is a **group-by aggregate** over the join —

    intercept × c        SUM(1)            GROUP BY c     → counts [D_c]
    continuous f × c     SUM(x_f)          GROUP BY c     → sums   [D_c]
    c × c (diagonal)     SUM(1)            GROUP BY c     → the same counts
    c × d (c ≠ d)        SUM(1)            GROUP BY c, d  → sparse counts

so the full one-hot cofactor matrix is assembled from a handful of small
grouped arrays plus a sparse co-occurrence tensor, **without ever
materializing the [m, Σ D_c] one-hot design matrix**.  Nonzeros of the c×d
block are bounded by the join size (and usually far below D_c·D_d).

Four computation paths, mirroring ``cofactor.py``'s engine matrix:

* ``cat_cofactors_factorized``   — ONE fused multi-output engine pass: the
  ungrouped Gram block, every GROUP BY c vector and every GROUP BY (c, d)
  co-occurrence ride a single traversal of the variable order
  (``FactorizedEngine.run_batch``), sharing the join descent and the
  per-node view cache AC/DC-style; O(factorization), the flat join never
  materializes, and cofactor time is roughly flat in |cat|.
* ``cat_cofactors_per_pass``     — the pre-fusion baseline: one grouped
  engine traversal per categorical attribute plus one per pair
  (O(1 + |cat| + |cat|²) passes).  Kept as the benchmark baseline and the
  equivalence oracle for the fused plan.
* ``cat_cofactors_materialized`` — flat join, then grouped Gram blocks via
  the hand-written ``multi_segment_gram`` kernel (``use_kernel=True``, one
  fused multi-segment pass over all categorical columns on ``device``) or
  fp64 host scatters; the "noPre-but-not-one-hot" middle path.
* ``onehot_design_matrix`` + ``cofactors_from_matrix`` — the fully dense
  one-hot baseline, used as the oracle in tests and the slow side of
  ``benchmarks/bench_categorical.py``.

``CatCofactors`` supports ``__add__`` (union commutativity, Prop. 4.1 — the
same algebra the store's incremental ``append`` maintenance and the sharded
reduction use), with domain growth handled by zero-padding, so cache entries
stay valid when an append introduces unseen category ids.

The factorized paths take the engine's ``backend`` (``"numpy"`` float64 on
the host by default, or ``"torch"`` float32 on ``device``, ``"cuda"`` unless
the caller asks for the CPU).  The delta-engine ``overrides`` and the
persistent view cache of the JAX package belong to later parts of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import ops as kernel_ops
from .api import StoreReads
from .cofactor import _device
from .factorize import AggregateQuery, FactorizedEngine
from .relation import Relation
from .variable_order import VariableOrder

__all__ = [
    "CatCofactors",
    "SparseCounts",
    "cat_cofactors_factorized",
    "cat_cofactors_from_arrays",
    "cat_cofactors_materialized",
    "cat_cofactors_per_pass",
    "onehot_design_matrix",
]


@dataclasses.dataclass
class SparseCounts:
    """COO sparse matrix of co-occurrence counts for one cat×cat block."""

    rows: np.ndarray  # int64 [nnz]
    cols: np.ndarray  # int64 [nnz]
    vals: np.ndarray  # float64 [nnz]
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(len(self.vals))

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=np.float64)
        np.add.at(out, (self.rows, self.cols), self.vals)
        return out

    def pad(self, shape: Tuple[int, int]) -> "SparseCounts":
        if shape[0] < self.shape[0] or shape[1] < self.shape[1]:
            raise ValueError(f"cannot shrink {self.shape} to {shape}")
        return SparseCounts(self.rows, self.cols, self.vals, shape)

    def __add__(self, other: "SparseCounts") -> "SparseCounts":
        shape = (
            max(self.shape[0], other.shape[0]),
            max(self.shape[1], other.shape[1]),
        )
        rows = np.concatenate([self.rows, other.rows])
        cols = np.concatenate([self.cols, other.cols])
        vals = np.concatenate([self.vals, other.vals])
        return coalesce_counts(rows, cols, vals, shape)

    @staticmethod
    def from_dense(dense: np.ndarray) -> "SparseCounts":
        rows, cols = np.nonzero(dense)
        return SparseCounts(
            rows.astype(np.int64),
            cols.astype(np.int64),
            dense[rows, cols].astype(np.float64),
            dense.shape,
        )


def coalesce_counts(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    shape: Tuple[int, int],
) -> SparseCounts:
    """Sum duplicate (row, col) coordinates into a canonical sorted COO."""
    if len(vals) == 0:
        return SparseCounts(
            np.zeros(0, np.int64), np.zeros(0, np.int64),
            np.zeros(0, np.float64), shape,
        )
    flat = rows.astype(np.int64) * shape[1] + cols.astype(np.int64)
    uniq, inv = np.unique(flat, return_inverse=True)
    out = np.zeros(len(uniq), dtype=np.float64)
    np.add.at(out, inv, vals.astype(np.float64))
    return SparseCounts(uniq // shape[1], uniq % shape[1], out, shape)


@dataclasses.dataclass
class CatCofactors:
    """Cofactors of a feature set with continuous AND categorical columns.

    ``cont`` lists the continuous columns (callers training a linear model
    append the label here, as in ``Cofactors``); ``cat`` lists categorical
    attributes, which must be dictionary-encoded key columns.  Block layout
    (see module docstring): dense continuous count/lin/quad, per-category
    count and continuous-sum arrays, and sparse cat×cat counts keyed by
    ``(cat[i], cat[j])`` with i < j in ``cat`` order.
    """

    count: float
    lin: np.ndarray  # [k] continuous sums
    quad: np.ndarray  # [k, k] continuous Gram
    cont: List[str]
    cat: List[str]
    domains: Dict[str, int]  # cat attr -> domain size D_c
    cat_count: Dict[str, np.ndarray]  # c -> [D_c] per-category counts
    cat_cont: Dict[str, np.ndarray]  # c -> [D_c, k] per-category cont sums
    cat_cat: Dict[Tuple[str, str], SparseCounts]  # (c, d) -> sparse counts

    # -- shape / layout -------------------------------------------------------
    @property
    def num_params(self) -> int:
        """Width of the assembled one-hot cofactor matrix (incl. intercept)."""
        return 1 + len(self.cont) + sum(self.domains[c] for c in self.cat)

    def column_names(self) -> List[str]:
        """Assembled column order: [intercept, cont..., c=0..c=D_c-1, ...]."""
        names = ["intercept"] + list(self.cont)
        for c in self.cat:
            names.extend(f"{c}={g}" for g in range(self.domains[c]))
        return names

    def nnz(self) -> int:
        """Stored entries — the compressed size the one-hot path can't beat."""
        k = len(self.cont)
        n = 1 + k + k * k
        for c in self.cat:
            n += self.cat_count[c].size + self.cat_cont[c].size
        for coo in self.cat_cat.values():
            n += 3 * coo.nnz
        return n

    # -- assembly -------------------------------------------------------------
    def matrix(self) -> np.ndarray:
        """Dense one-hot cofactor matrix in ``column_names()`` order.

        Equals ``[1 | X_cont | onehot(cat)]^T @ [1 | X_cont | onehot(cat)]``
        over the join result — assembled from the grouped aggregates, never
        from the one-hot matrix itself.
        """
        k = len(self.cont)
        p = self.num_params
        out = np.zeros((p, p), dtype=np.float64)
        out[0, 0] = self.count
        out[0, 1 : 1 + k] = self.lin
        out[1 : 1 + k, 1 : 1 + k] = self.quad
        off = {}
        o = 1 + k
        for c in self.cat:
            off[c] = o
            d = self.domains[c]
            sl = slice(o, o + d)
            out[0, sl] = self.cat_count[c]
            out[sl, sl] = np.diag(self.cat_count[c])
            out[1 : 1 + k, sl] = self.cat_cont[c].T
            o += d
        for (c, d_), coo in self.cat_cat.items():
            block = np.zeros((self.domains[c], self.domains[d_]))
            np.add.at(block, (coo.rows, coo.cols), coo.vals)
            out[off[c] : off[c] + self.domains[c],
                off[d_] : off[d_] + self.domains[d_]] = block
        return np.where(
            np.arange(p)[:, None] <= np.arange(p)[None, :], out, out.T
        )

    def regression_matrix(self, label: str) -> Tuple[np.ndarray, List[str]]:
        """Assembled matrix permuted to the solver convention: the label
        column moved last ([intercept, cont\\label, cats..., label]), the
        ordering ``gd.bgd_cofactor`` / ``solve_cofactor`` expect."""
        if label not in self.cont:
            raise ValueError(f"label {label!r} not among continuous columns")
        names = self.column_names()
        li = 1 + self.cont.index(label)
        perm = [i for i in range(len(names)) if i != li] + [li]
        mat = self.matrix()[np.ix_(perm, perm)]
        return mat, [names[i] for i in perm]

    # -- algebra (Prop. 4.1) ---------------------------------------------------
    def project(
        self, cont_keep: Sequence[str], cat_keep: Sequence[str]
    ) -> "CatCofactors":
        """Commutativity with projection: restrict to a feature subset
        without recomputation — the delta-sharing rule ``Store.append``
        uses (one delta factorization over the union feature set, each
        cache entry derives its own view).  Pair blocks transpose when the
        kept ``cat`` order reverses a stored pair."""
        cont_keep, cat_keep = list(cont_keep), list(cat_keep)
        idx = [self.cont.index(f) for f in cont_keep]
        cat_cat = {}
        for i in range(len(cat_keep)):
            for j in range(i + 1, len(cat_keep)):
                c, d_ = cat_keep[i], cat_keep[j]
                if (c, d_) in self.cat_cat:
                    cat_cat[(c, d_)] = self.cat_cat[(c, d_)]
                else:
                    coo = self.cat_cat[(d_, c)]  # stored transposed
                    cat_cat[(c, d_)] = SparseCounts(
                        coo.cols.copy(), coo.rows.copy(), coo.vals.copy(),
                        (coo.shape[1], coo.shape[0]),
                    )
        return CatCofactors(
            count=self.count,
            lin=self.lin[idx],
            quad=self.quad[np.ix_(idx, idx)],
            cont=cont_keep,
            cat=cat_keep,
            domains={c: self.domains[c] for c in cat_keep},
            cat_count={c: self.cat_count[c] for c in cat_keep},
            cat_cont={c: self.cat_cont[c][:, idx] for c in cat_keep},
            cat_cat=cat_cat,
        )

    def __add__(self, other: "CatCofactors") -> "CatCofactors":
        """Union commutativity: cofactors of a disjoint partition sum block
        by block.  Domains may differ (an append can introduce unseen
        category ids); smaller blocks zero-pad to the larger domain."""
        if self.cont != other.cont or self.cat != other.cat:
            raise ValueError("feature sets differ — cannot add CatCofactors")
        domains = {
            c: max(self.domains[c], other.domains[c]) for c in self.cat
        }

        def _pad(a: np.ndarray, d: int) -> np.ndarray:
            if a.shape[0] == d:
                return a
            widths = [(0, d - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
            return np.pad(a, widths)

        cat_count = {
            c: _pad(self.cat_count[c], domains[c])
            + _pad(other.cat_count[c], domains[c])
            for c in self.cat
        }
        cat_cont = {
            c: _pad(self.cat_cont[c], domains[c])
            + _pad(other.cat_cont[c], domains[c])
            for c in self.cat
        }
        cat_cat = {}
        for key in self.cat_cat:
            c, d_ = key
            shape = (domains[c], domains[d_])
            cat_cat[key] = self.cat_cat[key].pad(shape) + other.cat_cat[
                key
            ].pad(shape)
        return CatCofactors(
            count=self.count + other.count,
            lin=self.lin + other.lin,
            quad=self.quad + other.quad,
            cont=list(self.cont),
            cat=list(self.cat),
            domains=domains,
            cat_count=cat_count,
            cat_cont=cat_cont,
            cat_cat=cat_cat,
        )


# ---------------------------------------------------------------------------
# Computation paths
# ---------------------------------------------------------------------------

def _store_domains(store: StoreReads, cat: Sequence[str]) -> Dict[str, int]:
    """Dictionary-domain sizes from the catalog."""
    return {c: store.attr_domain(c) for c in cat}


def _checked_ids(g, attr: str, dom: int) -> np.ndarray:
    """Group ids of ``attr`` with the same loud out-of-domain rejection as
    the from-arrays/sharded paths — np.add.at would wrap negatives into the
    LAST category."""
    ids = g.ids(attr)
    if len(ids):
        lo, hi = int(ids.min()), int(ids.max())
        if lo < 0 or hi >= dom:
            raise ValueError(
                f"category ids of {attr!r} span [{lo}, {hi}], outside "
                f"domain [0, {dom})"
            )
    return ids


def cat_cofactors_factorized(
    store: StoreReads,
    vorder: VariableOrder,
    cont: Sequence[str],
    cat: Sequence[str],
    backend: str = "numpy",
    domains: Optional[Dict[str, int]] = None,
    stats: Optional[Dict[str, int]] = None,
    use_node_kernels: Optional[bool] = None,
    device="cuda",
) -> CatCofactors:
    """Categorical cofactors over the **factorized** join — ONE fused pass.

    The whole cofactor batch — the ungrouped continuous Gram block, one
    GROUP BY c count/Σx query per categorical attribute (degree 1: no
    per-group quad tensors), and one GROUP BY (c, d) count query per pair
    (degree 0: counts only) — is issued as a single multi-output plan, so
    the engine traverses the variable order exactly once and every subtree
    below the referenced attributes is evaluated once and shared across
    outputs.  O(factorization size); the flat join and the one-hot matrix
    never exist; cofactor time is roughly flat in |cat| instead of
    quadratic.  ``domains`` overrides the store-derived domain sizes (used
    by the incremental delta path, where the delta relation may not cover
    the full dictionary).  ``stats``, when given, receives the engine's
    ``passes``/``node_visits`` counters — the audit trail of the
    single-pass claim.  With ``backend="torch"`` the traversal runs on
    ``device``: the base query through ``segment_view``, the GROUP BY c
    queries through ``segment_view1`` and the pair counts through
    ``segment_reduce``.  The JAX package's ``overrides`` (delta engine) and
    ``use_view_cache`` arguments belong to the view-cache part of the port
    and are not taken here.
    """
    cont = list(cont)
    cat = list(cat)
    k = len(cont)
    doms = dict(domains) if domains is not None else _store_domains(store, cat)
    engine = FactorizedEngine(
        store,
        vorder,
        cont,
        backend=backend,
        use_node_kernels=use_node_kernels,
        device=device,
    )
    queries = [AggregateQuery("base", (), 2)]
    queries += [AggregateQuery(f"g:{c}", (c,), 1) for c in cat]
    pairs = [
        (cat[i], cat[j])
        for i in range(len(cat))
        for j in range(i + 1, len(cat))
    ]
    queries += [AggregateQuery(f"p:{c}|{d_}", (c, d_), 0) for c, d_ in pairs]
    out = engine.run_batch(queries)
    if stats is not None:
        stats["passes"] = engine.passes
        stats["node_visits"] = engine.node_visits

    base = out["base"]
    perm = [base.features.index(f) for f in cont]
    lin = base.lin[0][perm]
    quad = base.quad[0][np.ix_(perm, perm)]

    cat_count: Dict[str, np.ndarray] = {}
    cat_cont: Dict[str, np.ndarray] = {}
    for c in cat:
        g = out[f"g:{c}"]
        gperm = [g.features.index(f) for f in cont]
        ids = _checked_ids(g, c, doms[c])
        counts = np.zeros(doms[c], dtype=np.float64)
        sums = np.zeros((doms[c], k), dtype=np.float64)
        np.add.at(counts, ids, g.count)
        np.add.at(sums, ids, g.lin[:, gperm])
        cat_count[c] = counts
        cat_cont[c] = sums

    cat_cat: Dict[Tuple[str, str], SparseCounts] = {}
    for c, d_ in pairs:
        g = out[f"p:{c}|{d_}"]
        cat_cat[(c, d_)] = coalesce_counts(
            _checked_ids(g, c, doms[c]),
            _checked_ids(g, d_, doms[d_]),
            g.count,
            (doms[c], doms[d_]),
        )
    return CatCofactors(
        count=float(base.count[0]),
        lin=lin,
        quad=quad,
        cont=cont,
        cat=cat,
        domains=doms,
        cat_count=cat_count,
        cat_cont=cat_cont,
        cat_cat=cat_cat,
    )


def cat_cofactors_per_pass(
    store: StoreReads,
    vorder: VariableOrder,
    cont: Sequence[str],
    cat: Sequence[str],
    backend: str = "numpy",
    domains: Optional[Dict[str, int]] = None,
    device="cuda",
) -> CatCofactors:
    """The pre-fusion baseline: one ungrouped engine pass for the continuous
    block, one GROUP BY c traversal per categorical attribute, one
    GROUP BY (c, d) traversal per pair — O(1 + |cat| + |cat|²) full
    traversals of the same factorization the fused plan covers once.  Kept
    as the benchmark baseline and the equivalence oracle for
    :func:`cat_cofactors_factorized` (they must match to 1e-12)."""
    cont = list(cont)
    cat = list(cat)
    k = len(cont)
    doms = dict(domains) if domains is not None else _store_domains(store, cat)
    base = FactorizedEngine(
        store, vorder, cont, backend=backend, device=device
    ).cofactors()

    cat_count: Dict[str, np.ndarray] = {}
    cat_cont: Dict[str, np.ndarray] = {}
    for c in cat:
        g = FactorizedEngine(
            store, vorder, cont, backend=backend, group_by=[c], device=device
        ).grouped_cofactors()
        ids = _checked_ids(g, c, doms[c])
        counts = np.zeros(doms[c], dtype=np.float64)
        sums = np.zeros((doms[c], k), dtype=np.float64)
        np.add.at(counts, ids, g.count)
        np.add.at(sums, ids, g.lin)
        cat_count[c] = counts
        cat_cont[c] = sums

    cat_cat: Dict[Tuple[str, str], SparseCounts] = {}
    for i in range(len(cat)):
        for j in range(i + 1, len(cat)):
            c, d_ = cat[i], cat[j]
            g = FactorizedEngine(
                store, vorder, [], backend=backend, group_by=[c, d_],
                device=device,
            ).grouped_cofactors()
            cat_cat[(c, d_)] = coalesce_counts(
                _checked_ids(g, c, doms[c]),
                _checked_ids(g, d_, doms[d_]),
                g.count,
                (doms[c], doms[d_]),
            )
    return CatCofactors(
        count=base.count,
        lin=base.lin,
        quad=base.quad,
        cont=cont,
        cat=cat,
        domains=doms,
        cat_count=cat_count,
        cat_cont=cat_cont,
        cat_cat=cat_cat,
    )


def cat_cofactors_from_arrays(
    x_cont: np.ndarray,
    cat_ids: np.ndarray,
    cont: Sequence[str],
    cat: Sequence[str],
    domains: Dict[str, int],
    use_kernel: bool = False,
    device="cuda",
) -> CatCofactors:
    """Categorical cofactors of already-extracted columns: ``x_cont`` is the
    [m, k] continuous matrix, ``cat_ids`` the [m, n_cat] dictionary ids.

    With ``use_kernel=True`` the per-category blocks of ALL categorical
    attributes run through the ``multi_segment_gram`` kernel on ``device``
    in one fused pass, in float32 — u = [1, x] makes each grouped block
    carry counts and continuous sums together, and the batched kernel
    streams u from memory once instead of once per attribute.  The fp64
    host path (`np.add.at`) is the oracle.  Never builds a one-hot column.
    """
    cont = list(cont)
    cat = list(cat)
    m, k = x_cont.shape
    if cat_ids.shape != (m, len(cat)):
        raise ValueError(
            f"cat_ids shape {cat_ids.shape} != ({m}, {len(cat)})"
        )
    for i, c in enumerate(cat):
        if m == 0:
            continue
        lo, hi = int(cat_ids[:, i].min()), int(cat_ids[:, i].max())
        if lo < 0 or hi >= int(domains[c]):
            # negative ids would wrap through np.add.at into the LAST
            # category — reject both bounds loudly
            raise ValueError(
                f"category ids of {c!r} span [{lo}, {hi}], outside domain "
                f"[0, {int(domains[c])})"
            )
    ones = np.ones((m, 1), dtype=np.float64)
    u = np.concatenate([ones, x_cont.astype(np.float64)], axis=1)

    gram = u.T @ u
    cat_count: Dict[str, np.ndarray] = {}
    cat_cont: Dict[str, np.ndarray] = {}
    if use_kernel and cat:
        # one fused multi-segment pass over u = [1, x]: every attribute's
        # grouped block comes out of a single data-chunk stream — row 0 of
        # each [1+k, 1+k] block carries count and continuous sums together.
        dev = _device(device)
        blocks = kernel_ops.multi_segment_gram(
            torch.as_tensor(u, dtype=torch.float32, device=dev),
            torch.as_tensor(np.asarray(cat_ids), device=dev),
            [int(domains[c]) for c in cat],
        )
        for i, c in enumerate(cat):
            blk = blocks[i][:, 0, :].cpu().numpy().astype(np.float64)
            cat_count[c] = blk[:, 0]
            cat_cont[c] = blk[:, 1:]
    else:
        # host path: bincount + scatter-add, O(m·k) — the full per-group
        # Gram would build an O(m·k²) temporary only to read row 0.
        for i, c in enumerate(cat):
            seg, num = cat_ids[:, i], int(domains[c])
            cat_count[c] = np.bincount(seg, minlength=num).astype(np.float64)
            sums = np.zeros((num, k), dtype=np.float64)
            np.add.at(sums, seg, x_cont.astype(np.float64))
            cat_cont[c] = sums
    cat_cat: Dict[Tuple[str, str], SparseCounts] = {}
    for i in range(len(cat)):
        for j in range(i + 1, len(cat)):
            c, d_ = cat[i], cat[j]
            # O(nnz) memory: coalesce the present coordinate pairs only —
            # a dense bincount over D_c·D_d would defeat the sparse design.
            cat_cat[(c, d_)] = coalesce_counts(
                cat_ids[:, i].astype(np.int64),
                cat_ids[:, j].astype(np.int64),
                np.ones(m, dtype=np.float64),
                (domains[c], domains[d_]),
            )
    return CatCofactors(
        count=float(gram[0, 0]),
        lin=np.asarray(gram[0, 1:], dtype=np.float64),
        quad=np.asarray(gram[1:, 1:], dtype=np.float64),
        cont=cont,
        cat=cat,
        domains=dict(domains),
        cat_count=cat_count,
        cat_cont=cat_cont,
        cat_cat=cat_cat,
    )


def cat_cofactors_materialized(
    store: StoreReads,
    cont: Sequence[str],
    cat: Sequence[str],
    relations: Optional[Sequence[str]] = None,
    use_kernel: bool = False,
    device="cuda",
) -> CatCofactors:
    """Flat-join path: materialize the natural join, then grouped blocks —
    still no one-hot matrix (the grouped middle ground the benchmark pits
    against full one-hot materialization)."""
    joined = store.materialize_join(relations)
    x = np.stack(
        [joined.column(f).astype(np.float64) for f in cont], axis=1
    ) if cont else np.zeros((joined.num_rows, 0))
    ids = np.stack(
        [joined.column(c).astype(np.int64) for c in cat], axis=1
    ) if cat else np.zeros((joined.num_rows, 0), dtype=np.int64)
    return cat_cofactors_from_arrays(
        x, ids, cont, cat, _store_domains(store, cat), use_kernel=use_kernel,
        device=device,
    )


def onehot_design_matrix(
    joined: Relation,
    cont: Sequence[str],
    cat: Sequence[str],
    domains: Dict[str, int],
) -> Tuple[np.ndarray, List[str]]:
    """The dense baseline: materialize the [m, k + Σ D_c] one-hot design
    matrix (no intercept column).  Exists to be benchmarked against and to
    serve as the oracle in tests — the factorized paths never build this."""
    m = joined.num_rows
    cols = [joined.column(f).astype(np.float64) for f in cont]
    names = list(cont)
    for c in cat:
        ids = joined.column(c).astype(np.int64)
        onehot = np.zeros((m, domains[c]), dtype=np.float64)
        onehot[np.arange(m), ids] = 1.0
        cols.append(onehot)
        names.extend(f"{c}={g}" for g in range(domains[c]))
    parts = [
        c[:, None] if c.ndim == 1 else c for c in cols
    ]
    x = np.concatenate(parts, axis=1) if parts else np.zeros((m, 0))
    return x, names
