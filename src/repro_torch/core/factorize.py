"""Factorized aggregate pushdown over a variable order (paper §2.3, §4.3).

Computes, in **one pass over the factorized join** (never materializing the
flat result), every monomial aggregate of degree ≤ 2 over a feature set F:

    count          = SUM(1)
    lin[f]         = SUM(x_f)            for f in F
    quad[f, g]     = SUM(x_f * x_g)      for f, g in F

— the cofactor entries of paper §3.4 — as **dense monomial tensors** per
view:

    c : [N]        degree-0 aggregates (one row per distinct key combo)
    l : [N, k]     degree-1 aggregates over the k features below this node
    q : [N, k, k]  degree-2 aggregates (symmetric)

Views combine bottom-up with closed-form block algebra (children C1, C2):

    c = c1·c2
    l = [l1·c2, c1·l2]
    q = [[q1·c2, l1⊗l2], [l2⊗l1, c1·q2]]

and aggregating out a feature variable with values x extends the blocks by
``x·c / x²·c / x·l`` before a GROUP BY (sort + segment-sum) over the node's
remaining key attributes.

The engine is split into a **plan** layer and an **executor** layer so a
*batch* of :class:`AggregateQuery` outputs shares ONE traversal: per-node
views are memoized by ``(node, live-query-subset)``.  ``passes`` counts
executor traversals (one per :meth:`FactorizedEngine.run_batch`);
``node_visits`` counts distinct ``(node, live-subset)`` view evaluations.

Backends: ``"torch"`` keeps the value blocks as torch tensors (float32 by
default) on ``device`` — ``"cuda"`` unless the caller asks for the CPU —
and runs every feature node through the fused ``segment_view`` kernel and
every regroup through ``segment_blocks``; ``"numpy"`` is the float64 host
oracle.  Structural index work (joins, group keys) stays on host numpy, as
in the paper's query executor; with a GPU the GROUP BY ids come from a
device sort and only the G first-occurrence indices return to the host.

The persistent view cache and append-time delta folds of the JAX package
are not part of this port yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import ops as kernel_ops
from .api import StoreReads
from .relation import group_key, join_keys, segment_sum_torch, sort_merge_join
from .variable_order import INTERCEPT, VariableOrder, validate

__all__ = [
    "AggregateBlock",
    "AggregateQuery",
    "BatchPart",
    "Cofactors",
    "FactorizedEngine",
    "GroupedView",
    "MergedBatch",
    "cofactors_factorized",
    "grouped_cofactors_factorized",
    "merge_batches",
    "scatter_results",
]


@dataclasses.dataclass
class Cofactors:
    """Degree-≤2 aggregates over the join result for feature list ``features``."""

    count: float
    lin: np.ndarray  # [k]
    quad: np.ndarray  # [k, k]
    features: List[str]

    def matrix(self) -> np.ndarray:
        """Full (k+1)×(k+1) cofactor matrix, ordered [intercept] + features.

        Cof[0,0] = m, Cof[0,j] = Σ x_j, Cof[i,j] = Σ x_i·x_j  (paper §3.4).
        """
        k = len(self.features)
        out = np.zeros((k + 1, k + 1), dtype=np.float64)
        out[0, 0] = self.count
        out[0, 1:] = self.lin
        out[1:, 0] = self.lin
        out[1:, 1:] = self.quad
        return out

    def project(self, keep: Sequence[str]) -> "Cofactors":
        """Commutativity with projection (paper Prop. 4.1): restrict the
        feature set without recomputation."""
        idx = [self.features.index(f) for f in keep]
        return Cofactors(
            count=self.count,
            lin=self.lin[idx],
            quad=self.quad[np.ix_(idx, idx)],
            features=list(keep),
        )

    def __add__(self, other: "Cofactors") -> "Cofactors":
        """Commutativity with union (paper Prop. 4.1): cofactors of a
        disjoint partition sum elementwise."""
        assert self.features == other.features
        return Cofactors(
            count=self.count + other.count,
            lin=self.lin + other.lin,
            quad=self.quad + other.quad,
            features=list(self.features),
        )

    def rescale(self, factors) -> "Cofactors":
        """Cofactors of the affinely rescaled columns x' = (x − a)/b, derived
        from the unscaled aggregates in O(k²):

            Σ x'_i        = (lin_i − a_i·m) / b_i
            Σ x'_i x'_j   = (quad_ij − a_i·lin_j − a_j·lin_i + m·a_i·a_j)
                            / (b_i·b_j)

        ``factors`` is a ``ScaleFactors``; columns it does not cover pass
        through (a=0, b=1)."""
        a = np.array(
            [factors.avg.get(f, 0.0) for f in self.features], dtype=np.float64
        )
        b = np.array(
            [factors.max.get(f, 1.0) for f in self.features], dtype=np.float64
        )
        m = self.count
        lin = (self.lin - a * m) / b
        quad = (
            self.quad
            - np.outer(a, self.lin)
            - np.outer(self.lin, a)
            + m * np.outer(a, a)
        ) / np.outer(b, b)
        return Cofactors(
            count=m, lin=lin, quad=quad, features=list(self.features)
        )


@dataclasses.dataclass(frozen=True)
class AggregateQuery:
    """One output of a multi-output aggregate plan.

    ``group_by``  : attributes carried (as keys) to the root — the SQL
                    ``GROUP BY`` list.  Empty for global aggregates.
    ``degree``    : highest monomial degree this output reads —
                    0 = counts only, 1 = counts + Σx_f, 2 = full Gram block.
    """

    name: str
    group_by: Tuple[str, ...] = ()
    degree: int = 2


@dataclasses.dataclass
class AggregateBlock:
    """One query's output: per-group aggregates keyed by the query's group
    attributes' *original dictionary values*.

    ``lin``/``quad`` are present only up to the query's declared degree.
    """

    keys: Dict[str, np.ndarray]  # attr -> attribute values [N] (float64)
    count: np.ndarray  # [N]
    lin: Optional[np.ndarray]  # [N, k] if degree >= 1
    quad: Optional[np.ndarray]  # [N, k, k] if degree == 2
    features: List[str]

    @property
    def num_groups(self) -> int:
        return int(self.count.shape[0])

    def ids(self, attr: str) -> np.ndarray:
        """Group keys of a dictionary-encoded attribute as int64 ids."""
        return self.keys[attr].astype(np.int64)

    def restrict(
        self, features: Sequence[str], degree: int
    ) -> "AggregateBlock":
        """Project onto a feature sublist and trim blocks above ``degree``
        (Prop. 4.1 commutativity with projection, at block granularity)."""
        lin = quad = None
        feats: List[str] = []
        if degree >= 1:
            if self.lin is None:
                raise ValueError("block holds no degree-1 aggregates")
            idx = [self.features.index(f) for f in features]
            feats = list(features)
            lin = self.lin[:, idx]
            if degree == 2:
                if self.quad is None:
                    raise ValueError("block holds no degree-2 aggregates")
                quad = self.quad[:, idx][:, :, idx]
        return AggregateBlock(
            keys=dict(self.keys),
            count=self.count,
            lin=lin,
            quad=quad,
            features=feats,
        )


@dataclasses.dataclass(frozen=True)
class BatchPart:
    """One request's slice of a merged multi-request batch: the features
    and aggregate queries a single caller asked for, tagged with a
    caller-chosen request id used to route results back."""

    rid: object  # hashable request id, unique within one merge
    features: Tuple[str, ...]
    queries: Tuple[AggregateQuery, ...]


@dataclasses.dataclass
class MergedBatch:
    """The coalescing product of :func:`merge_batches`: ONE feature union +
    ONE deduplicated query list to hand to a single ``run_batch``, plus the
    assignment map that scatters shared outputs back per request."""

    features: List[str]
    queries: List[AggregateQuery]
    # (rid, per-request query name) -> merged query name
    assignments: Dict[Tuple[object, str], str]


def merge_batches(parts: Sequence[BatchPart]) -> MergedBatch:
    """Coalesce aggregate batches from different requests into one plan:
    feature lists union (a view over F ⊇ F' serves F' by projection), and
    queries that group by the same attribute set collapse to one output
    evaluated at the max requested degree."""
    if not parts:
        raise ValueError("merge_batches needs at least one part")
    features = list(
        dict.fromkeys(f for p in parts for f in p.features)
    )
    by_sig: Dict[FrozenSet[str], List] = {}
    order: List[FrozenSet[str]] = []
    assignments: Dict[Tuple[object, str], FrozenSet[str]] = {}
    for p in parts:
        for q in p.queries:
            akey = (p.rid, q.name)
            if akey in assignments:
                raise ValueError(
                    f"duplicate query name {q.name!r} in request {p.rid!r}"
                )
            sig = frozenset(q.group_by)
            ent = by_sig.get(sig)
            if ent is None:
                by_sig[sig] = [tuple(q.group_by), q.degree]
                order.append(sig)
            else:
                ent[1] = max(ent[1], q.degree)
            assignments[akey] = sig
    names = {sig: f"m{i}" for i, sig in enumerate(order)}
    return MergedBatch(
        features=features,
        queries=[
            AggregateQuery(names[sig], by_sig[sig][0], by_sig[sig][1])
            for sig in order
        ],
        assignments={k: names[sig] for k, sig in assignments.items()},
    )


def scatter_results(
    merged: MergedBatch,
    parts: Sequence[BatchPart],
    results: Dict[str, AggregateBlock],
) -> Dict[object, Dict[str, AggregateBlock]]:
    """Slice one merged ``run_batch`` output back into per-request results:
    ``out[rid][query name]`` is the block the request would have received
    from a private engine over its own feature list."""
    out: Dict[object, Dict[str, AggregateBlock]] = {}
    for p in parts:
        mine = out.setdefault(p.rid, {})
        for q in p.queries:
            blk = results[merged.assignments[(p.rid, q.name)]]
            mine[q.name] = blk.restrict(list(p.features), q.degree)
    return out


@dataclasses.dataclass
class GroupedView:
    """Root view of a GROUP BY evaluation: one row per distinct combination
    of the group attributes' values, carrying that group's degree-≤2
    aggregates in the engine's requested feature order."""

    keys: Dict[str, np.ndarray]  # attr -> attribute values [N] (float64)
    count: np.ndarray  # [N]
    lin: np.ndarray  # [N, k]
    quad: np.ndarray  # [N, k, k]
    features: List[str]

    @property
    def num_groups(self) -> int:
        return int(self.count.shape[0])

    def ids(self, attr: str) -> np.ndarray:
        """Group keys of a dictionary-encoded attribute as int64 ids."""
        return self.keys[attr].astype(np.int64)


@dataclasses.dataclass
class _View:
    """One factorized view Q_A: keyed aggregate tensors (see module doc).
    ``keys`` are host int32 id columns; ``c``/``l``/``q`` are backend
    arrays, ``l``/``q`` ``None`` above the view's evaluation degree."""

    keys: Dict[str, np.ndarray]  # attr -> int32 ids [N]
    c: object  # [N]
    l: object  # [N, k] | None
    q: object  # [N, k, k] | None
    feats: List[str]
    degree: int

    @property
    def num_rows(self) -> int:
        return int(self.c.shape[0])


@dataclasses.dataclass
class _BatchPlan:
    """Which ``(node, live-subset)`` views the executor must evaluate, and
    at which degree.

    ``subtree_vars[id(node)]`` — attribute-node names in the subtree.
    ``need[id(node)][sig]``    — max degree over queries whose live subset
                                 at the node equals ``sig``.
    """

    queries: List[AggregateQuery]
    subtree_vars: Dict[int, FrozenSet[str]]
    need: Dict[int, Dict[FrozenSet[str], int]]


class FactorizedEngine:
    """Evaluates degree-≤2 monomial aggregates over an extended variable order.

    ``backend='torch'`` keeps value blocks as tensors (float32 by default)
    on ``device`` (``"cuda"`` by default; there is no fallback to the CPU
    when no GPU is present).  ``backend='numpy'`` uses float64 host math —
    the exact oracle used in tests.

    ``use_node_kernels`` (default: on for the torch backend, never for
    numpy) routes feature nodes through the fused ``segment_view`` and
    regroups through one ``segment_blocks`` call instead of one scatter per
    block.
    """

    def __init__(
        self,
        store: StoreReads,
        vorder: VariableOrder,
        features: Sequence[str],
        backend: str = "torch",
        dtype=None,
        scale=None,  # Optional[ScaleFactors] — lazy view rescaling (§4.2)
        group_by: Sequence[str] = (),
        use_node_kernels: Optional[bool] = None,
        device="cuda",
    ) -> None:
        self.store = store
        # freeze the catalog: all *data* reads go through an immutable
        # snapshot; counters route through ``self.store`` (the snapshot
        # forwards them), keeping store totals authoritative.
        snap = getattr(store, "snapshot", None)
        self.data = snap() if callable(snap) else store
        validate(vorder, self.data)
        self.vorder = vorder
        self.features = list(features)
        if backend == "torch":
            self.device = torch.device(device)
            if self.device.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError(
                    "backend='torch' runs on device='cuda' by default and "
                    "no CUDA device is available; pass device='cpu' to run "
                    "on the CPU"
                )
            self.dtype = dtype or torch.float32
        elif backend == "numpy":
            self.device = None
            self.dtype = dtype or np.float64
        else:
            raise ValueError(f"unknown backend {backend}")
        self.backend = backend
        self.scale = scale
        if use_node_kernels is None:
            use_node_kernels = backend == "torch"
        self.use_node_kernels = bool(use_node_kernels) and backend == "torch"
        # device-resident grouping where the device sort wins (a GPU);
        # tests flip this attribute to exercise the path on the CPU.
        self.device_grouping = (
            self.use_node_kernels
            and kernel_ops.fast_device_grouping(self.device)
        )
        self.group_by = list(group_by)
        self.passes = 0
        self.node_visits = 0
        self._check_group_attrs(self.group_by)
        self._index_nodes()
        self._encode_attributes()
        missing = set(self.group_by) - set(self.domains)
        if missing:
            raise ValueError(
                f"group-by attributes {sorted(missing)} occur in no relation "
                "of the variable order"
            )
        self._leaf_memo: Dict[Tuple[str, int], _View] = {}

    def _index_nodes(self) -> None:
        """Static subtree summaries: the attribute nodes under each node."""
        self._subtree_vars: Dict[int, FrozenSet[str]] = {}

        def walk(node: VariableOrder) -> set:
            vs: set = set()
            if not node.is_relation and node.name != INTERCEPT:
                vs.add(node.name)
            for ch in node.children:
                vs |= walk(ch)
            self._subtree_vars[id(node)] = frozenset(vs)
            return vs

        walk(self.vorder)

    def _check_group_attrs(self, group_by: Sequence[str]) -> None:
        overlap = set(group_by) & set(self.features)
        if overlap:
            raise ValueError(
                f"attributes {sorted(overlap)} cannot be both a feature and "
                "a group-by key — declare them one or the other"
            )

    # -- dictionary encoding (global, per attribute) --------------------------
    def _encode_attributes(self) -> None:
        """Dictionary-encode every (relation, attribute) column through the
        store's append-only attribute dictionaries (``attr_encoding``), or,
        for store-likes without them, with one in-engine ``np.unique`` per
        attribute."""
        rel_names = list(dict.fromkeys(self.vorder.relations()))
        self.domains: Dict[str, int] = {}
        self.attr_values: Dict[str, np.ndarray] = {}  # id -> float value
        self.encoded: Dict[Tuple[str, str], np.ndarray] = {}  # (rel, attr) -> ids
        if hasattr(self.data, "attr_encoding"):
            attrs: set = set()
            for rn in rel_names:
                for attr in self.data.get(rn).attributes:
                    self.encoded[(rn, attr)] = self.data.attr_encoding(rn, attr)
                    attrs.add(attr)
            # capture dictionaries AFTER all columns are encoded
            for attr in attrs:
                vals = self.data.attr_values_array(attr)
                self.attr_values[attr] = vals
                self.domains[attr] = len(vals)
            return
        cols: Dict[str, List[Tuple[str, np.ndarray]]] = {}
        for rn in rel_names:
            rel = self.data.get(rn)
            for attr in rel.attributes:
                cols.setdefault(attr, []).append((rn, rel.column(attr)))
        for attr, entries in cols.items():
            allv = np.concatenate([c.astype(np.float64) for _, c in entries])
            uniq, inv = np.unique(allv, return_inverse=True)
            self.domains[attr] = len(uniq)
            self.attr_values[attr] = uniq
            off = 0
            for rn, c in entries:
                self.encoded[(rn, attr)] = inv[off : off + len(c)].astype(np.int32)
                off += len(c)

    # -- backend array helpers --------------------------------------------------
    def _zeros(self, shape) -> object:
        if self.backend == "torch":
            return torch.zeros(shape, dtype=self.dtype, device=self.device)
        return np.zeros(shape, dtype=self.dtype)

    def _ones(self, shape) -> object:
        if self.backend == "torch":
            return torch.ones(shape, dtype=self.dtype, device=self.device)
        return np.ones(shape, dtype=self.dtype)

    def _cat(self, parts, dim: int):
        if self.backend == "torch":
            return torch.cat(parts, dim)
        return np.concatenate(parts, axis=dim)

    def _rows(self, idx: np.ndarray):
        """A host row-index array in the backend's index form."""
        if self.backend == "torch":
            return torch.from_numpy(idx).to(self.device)
        return idx

    @staticmethod
    def _host(a) -> np.ndarray:
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu().numpy()
        return np.asarray(a, dtype=np.float64)

    # -- public API ------------------------------------------------------------
    def cofactors(self) -> Cofactors:
        if self.group_by:
            raise ValueError("use grouped_cofactors() when group_by is set")
        blk = self.run_batch([AggregateQuery("__cof__", (), 2)])["__cof__"]
        if blk.num_groups != 1:
            raise AssertionError(
                f"root view must have exactly one row, got {blk.num_groups} "
                "— invalid variable order"
            )
        perm = [blk.features.index(f) for f in self.features]
        return Cofactors(
            count=float(blk.count[0]),
            lin=blk.lin[0][perm],
            quad=blk.quad[0][np.ix_(perm, perm)],
            features=list(self.features),
        )

    def grouped_cofactors(self) -> GroupedView:
        """Per-group cofactors, grouped by the ``group_by`` attributes —
        the SQL ``GROUP BY`` pushed through the factorization."""
        if not self.group_by:
            raise ValueError("group_by is empty — use cofactors()")
        blk = self.run_batch(
            [AggregateQuery("__grp__", tuple(self.group_by), 2)]
        )["__grp__"]
        perm = [blk.features.index(f) for f in self.features]
        return GroupedView(
            keys=blk.keys,
            count=blk.count,
            lin=blk.lin[:, perm],
            quad=blk.quad[:, perm][:, :, perm],
            features=list(self.features),
        )

    def run_batch(
        self, queries: Sequence[AggregateQuery]
    ) -> Dict[str, AggregateBlock]:
        """Evaluate a batch of aggregate queries in ONE shared traversal:
        queries whose live subsets coincide at a node share that node's
        view, so subtrees below all referenced group attributes are
        computed exactly once for the whole batch."""
        queries = list(queries)
        plan = self._plan(queries)
        self.passes += 1
        store_passes = getattr(self.store, "passes", None)
        if store_passes is not None:
            self.store.passes = store_passes + 1
        cache: Dict[Tuple[int, FrozenSet[str]], _View] = {}
        out: Dict[str, AggregateBlock] = {}
        for q in queries:
            view = self._execute(self.vorder, frozenset(q.group_by), plan, cache)
            out[q.name] = self._to_block(view, q)
        return out

    # -- plan layer -------------------------------------------------------------
    def _plan(self, queries: Sequence[AggregateQuery]) -> _BatchPlan:
        names = set()
        for q in queries:
            if q.name in names:
                raise ValueError(f"duplicate query name {q.name!r}")
            names.add(q.name)
            if q.degree not in (0, 1, 2):
                raise ValueError(f"query {q.name!r}: degree must be 0, 1 or 2")
            self._check_group_attrs(q.group_by)
            missing = set(q.group_by) - set(self.domains)
            if missing:
                raise ValueError(
                    f"query {q.name!r}: group-by attributes "
                    f"{sorted(missing)} occur in no relation of the "
                    "variable order"
                )

        subtree_vars = self._subtree_vars
        need: Dict[int, Dict[FrozenSet[str], int]] = {}

        def record(node: VariableOrder) -> None:
            at_node = need.setdefault(id(node), {})
            sub = subtree_vars[id(node)]
            for q in queries:
                sig = frozenset(q.group_by) & sub
                at_node[sig] = max(at_node.get(sig, -1), q.degree)
            for ch in node.children:
                record(ch)

        record(self.vorder)
        return _BatchPlan(
            queries=list(queries), subtree_vars=subtree_vars, need=need
        )

    # -- executor: memoized bottom-up evaluation ---------------------------------
    def _execute(
        self,
        node: VariableOrder,
        keep: FrozenSet[str],
        plan: _BatchPlan,
        cache: Dict[Tuple[int, FrozenSet[str]], _View],
    ) -> _View:
        memo_key = (id(node), keep)
        degree = plan.need[id(node)][keep]
        hit = cache.get(memo_key)
        if hit is not None and hit.degree >= degree:
            return hit
        self.node_visits += 1
        store_visits = getattr(self.store, "node_visits", None)
        if store_visits is not None:
            self.store.node_visits = store_visits + 1
        if node.is_relation:
            view = self._leaf_view(node.relation, degree)
        else:
            child_views = [
                self._execute(ch, keep & plan.subtree_vars[id(ch)], plan, cache)
                for ch in node.children
            ]
            view = child_views[0]
            for other in child_views[1:]:
                view = self._combine(view, other, degree)
            if node.name == INTERCEPT:
                if set(view.keys) != keep:
                    extra = sorted(set(view.keys) - keep)
                    raise AssertionError(
                        f"attributes {extra} survive to the intercept — "
                        "variable order misses nodes for them"
                    )
                # canonical key layout: a multi-child intercept leaves the
                # root view in JOIN order; every other keyed view comes out
                # of _group_rows in sorted-key order — regroup here too.
                if keep and len(child_views) > 1:
                    view = self._group_rows(view, sorted(view.keys), degree)
            elif (
                self.use_node_kernels
                and node.name in self.features
                and degree >= 1
                and view.num_rows > 0
            ):
                # fused node: extend + GROUP BY in one kernel pass
                view = self._extend_and_group(view, node.name, keep, degree)
            else:
                if node.name in self.features and degree >= 1:
                    view = self._extend_with_feature(view, node.name, degree)
                view = self._aggregate_out(view, node.name, keep, degree)
        cache[memo_key] = view
        return view

    @staticmethod
    def _trim_view(view: _View, degree: int) -> _View:
        """Serve a lower-degree request from a higher-degree view — block
        slicing only, no recompute."""
        if view.degree == degree:
            return view
        return _View(
            keys=view.keys,
            c=view.c,
            l=view.l if degree >= 1 else None,
            q=view.q if degree == 2 else None,
            feats=list(view.feats) if degree >= 1 else [],
            degree=degree,
        )

    def _to_block(self, view: _View, q: AggregateQuery) -> AggregateBlock:
        keys = {
            a: self.attr_values[a][np.asarray(view.keys[a])].astype(np.float64)
            for a in q.group_by
        }
        count = self._host(view.c)
        lin = self._host(view.l) if q.degree >= 1 else None
        quad = self._host(view.q) if q.degree == 2 else None
        return AggregateBlock(
            keys=keys,
            count=count,
            lin=lin,
            quad=quad,
            features=list(view.feats),
        )

    def _leaf_view(self, rel_name: str, degree: int) -> _View:
        # hoisted per (relation, degree): repeated batches within one
        # engine share the leaf block
        memo_key = (rel_name, degree)
        hit = self._leaf_memo.get(memo_key)
        if hit is not None:
            return hit
        for d in range(degree + 1, 3):  # a higher-degree leaf trims for free
            hit = self._leaf_memo.get((rel_name, d))
            if hit is not None:
                view = self._trim_view(hit, degree)
                self._leaf_memo[memo_key] = view
                return view
        rel = self.data.get(rel_name)
        n = rel.num_rows
        keys = {a: self.encoded[(rel_name, a)] for a in rel.attributes}
        view = _View(
            keys=keys,
            c=self._ones((n,)),
            l=self._zeros((n, 0)) if degree >= 1 else None,
            q=self._zeros((n, 0, 0)) if degree == 2 else None,
            feats=[],
            degree=degree,
        )
        self._leaf_memo[memo_key] = view
        return view

    def _combine(self, v1: _View, v2: _View, degree: int) -> _View:
        shared = sorted(set(v1.keys) & set(v2.keys))
        if shared:
            doms = [self.domains[a] for a in shared]
            k1, k2 = join_keys(
                [v1.keys[a] for a in shared],
                [v2.keys[a] for a in shared],
                doms,
            )
            i1, i2 = sort_merge_join(k1, k2)
        else:  # cross product (e.g. under the intercept)
            n1, n2 = v1.num_rows, v2.num_rows
            i1 = np.repeat(np.arange(n1, dtype=np.int64), n2)
            i2 = np.tile(np.arange(n2, dtype=np.int64), n1)
        keys = {a: c[i1] for a, c in v1.keys.items()}
        for a, c in v2.keys.items():
            if a not in keys:
                keys[a] = c[i2]
        r1, r2 = self._rows(i1), self._rows(i2)
        c1, c2 = v1.c[r1], v2.c[r2]
        c = c1 * c2
        l = q = None
        if degree >= 1:
            l1, l2 = v1.l[r1], v2.l[r2]
            l = self._cat([l1 * c2[:, None], c1[:, None] * l2], 1)
            if degree == 2:
                q1, q2 = v1.q[r1], v2.q[r2]
                cross = l1[:, :, None] * l2[:, None, :]
                top = self._cat([q1 * c2[:, None, None], cross], 2)
                bot = self._cat(
                    [cross.swapaxes(1, 2), q2 * c1[:, None, None]], 2
                )
                q = self._cat([top, bot], 1)
        feats = v1.feats + v2.feats if degree >= 1 else []
        return _View(keys=keys, c=c, l=l, q=q, feats=feats, degree=degree)

    def _feature_values(self, view: _View, attr: str):
        """Per-row (scaled) feature values for ``attr``, in backend dtype."""
        if attr not in view.keys:
            raise AssertionError(f"feature {attr} not present below its node")
        vals = self.attr_values[attr].astype(np.float64)[
            np.asarray(view.keys[attr])
        ]
        if self.scale is not None:
            vals = self.scale.transform(attr, vals)
        if self.backend == "torch":
            return torch.as_tensor(vals, dtype=self.dtype, device=self.device)
        return np.asarray(vals, dtype=self.dtype)

    def _extend_with_feature(self, view: _View, attr: str, degree: int) -> _View:
        x = self._feature_values(view, attr)
        c, l = view.c, view.l
        l_new = self._cat([(x * c)[:, None], l], 1)
        q_new = None
        if degree == 2:
            xl = x[:, None] * l
            top = self._cat([(x * x * c)[:, None, None], xl[:, None, :]], 2)
            bot = self._cat([xl[:, :, None], view.q], 2)
            q_new = self._cat([top, bot], 1)
        return _View(
            keys=view.keys,
            c=view.c,
            l=l_new,
            q=q_new,
            feats=[attr] + view.feats,
            degree=degree,
        )

    def _aggregate_out(
        self, view: _View, attr: str, keep: FrozenSet[str], degree: int
    ) -> _View:
        if attr not in view.keys:
            raise AssertionError(
                f"variable {attr} does not occur in any relation below its "
                "node — invalid variable order"
            )
        # live group attributes are never aggregated out: they stay among
        # the grouping keys, so the root is keyed by them.
        drop = set() if attr in keep else {attr}
        remaining = sorted(set(view.keys) - drop)
        return self._group_rows(view, remaining, degree)

    def _extend_and_group(
        self, view: _View, attr: str, keep: FrozenSet[str], degree: int
    ) -> _View:
        """The fused node: :meth:`_extend_with_feature` +
        :meth:`_aggregate_out` in ONE ``segment_view`` kernel launch — the
        extended ``[N, k+1, k+1]`` tensor never materializes.  Grouping is
        bit-compatible with the host path (same segment ids, same sorted
        group order), so the view equals the unfused one."""
        x = self._feature_values(view, attr)
        drop = set() if attr in keep else {attr}
        remaining = sorted(set(view.keys) - drop)
        seg, num, keys, order = self._group_ids(view, remaining)
        c, l, q = kernel_ops.segment_view(
            view.c,
            x,
            view.l,
            view.q if degree == 2 else None,
            seg,
            num,
            degree=degree,
            # _group_ids numbers only groups that occur: as many groups as
            # rows means one row each, and the sort's order lists them
            order=order if num == view.num_rows else None,
        )
        return _View(
            keys=keys,
            c=c,
            l=l,
            q=q,
            feats=[attr] + view.feats,
            degree=degree,
        )

    def _group_ids(
        self, view: _View, remaining: Sequence[str]
    ) -> Tuple[object, int, Dict[str, np.ndarray], Optional[object]]:
        """Segment ids + surviving key columns for GROUP BY ``remaining``,
        and the rows in group order where the device sort gives them (else
        None).

        Group numbering is canonical — ascending packed-key order over the
        (sorted) ``remaining`` attributes — whichever path computes it: the
        host ``np.unique`` or the device sort (``group_ids_device``), which
        is bit-compatible and keeps the per-row ids on the device."""
        n = view.num_rows
        if not remaining:
            return np.zeros((n,), dtype=np.int32), 1, {}, None
        doms = [self.domains[a] for a in remaining]
        # group_key, not composite_key: a GROUP BY only needs within-call
        # injectivity, and wide keys would overflow the strict radix.
        key = group_key([view.keys[a] for a in remaining], doms)
        order = None
        if self.device_grouping and n > 0:
            seg, num, first, order = kernel_ops.group_ids_device(
                key, self.device, with_order=True
            )
        else:
            uniq, first, inv = np.unique(
                key, return_index=True, return_inverse=True
            )
            seg = inv.astype(np.int32)
            num = len(uniq)
        keys = {a: view.keys[a][first] for a in remaining}
        return seg, num, keys, order

    def _group_rows(
        self, view: _View, remaining: Sequence[str], degree: int
    ) -> _View:
        """GROUP BY ``remaining`` over a view's rows (segment-sum of every
        block)."""
        seg, num, keys, order = self._group_ids(view, remaining)
        if self.use_node_kernels and view.num_rows > 0:
            # one multi-block kernel launch instead of a scatter per block
            c, l, q = kernel_ops.segment_blocks(
                view.c,
                view.l if degree >= 1 else None,
                view.q if degree == 2 else None,
                seg,
                num,
                degree=degree,
                order=order if num == view.num_rows else None,
            )
        else:
            c = self._segment_sum(view.c, seg, num)
            l = self._segment_sum(view.l, seg, num) if degree >= 1 else None
            q = self._segment_sum(view.q, seg, num) if degree == 2 else None
        return _View(
            keys=keys, c=c, l=l, q=q, feats=view.feats, degree=degree
        )

    def _segment_sum(self, data, seg, num: int):
        if self.backend == "torch":
            return segment_sum_torch(data, seg, num)
        out = np.zeros((num,) + data.shape[1:], dtype=data.dtype)
        np.add.at(out, seg, data)
        return out


def cofactors_factorized(
    store: StoreReads,
    vorder: VariableOrder,
    features: Sequence[str],
    backend: str = "torch",
    dtype=None,
    scale=None,
    use_node_kernels: Optional[bool] = None,
    device="cuda",
) -> Cofactors:
    """Convenience wrapper: cofactors over the factorized join (paper §4.3)."""
    return FactorizedEngine(
        store,
        vorder,
        features,
        backend=backend,
        dtype=dtype,
        scale=scale,
        use_node_kernels=use_node_kernels,
        device=device,
    ).cofactors()


def grouped_cofactors_factorized(
    store: StoreReads,
    vorder: VariableOrder,
    features: Sequence[str],
    group_by: Sequence[str],
    backend: str = "torch",
    dtype=None,
    scale=None,
    use_node_kernels: Optional[bool] = None,
    device="cuda",
) -> GroupedView:
    """Convenience wrapper: GROUP BY ``group_by`` cofactors over the
    factorized join."""
    return FactorizedEngine(
        store,
        vorder,
        features,
        backend=backend,
        dtype=dtype,
        scale=scale,
        group_by=group_by,
        use_node_kernels=use_node_kernels,
        device=device,
    ).grouped_cofactors()
