"""Functional dependencies: catalog, reduction, and closed-form recovery.

Abo Khamis et al. ("Learning Models over Relational Data using Sparse
Tensors and Functional Dependencies") and AC/DC observe that a functional
dependency ``f → g`` between dictionary-encoded attributes makes the whole
one-hot block of ``g`` *redundant*: on every join row the one-hot vector of
``g`` is a fixed linear image of the one-hot vector of ``f``,

    x_g = R x_f          R[j, i] = 1  iff  map[i] = j,

so the model can be reparametrized onto the strictly smaller space

    gamma_f = theta_f + R^T theta_g        (theta_g dropped entirely)

without changing any prediction.  The fit term of least squares and of
every GLM depends on theta only through the linear predictor, hence only
through gamma — training can run over the reduced parameters, with the
engine issuing **fewer GROUP BY queries** (no per-``g`` vector, no pair
involving ``g``) and the solver factoring a **smaller Gram/Hessian**.

The ridge penalty does see the split.  Minimizing
``||theta_f||^2 + ||theta_g||^2`` subject to the reparametrization, for a
fixed gamma, is a tiny quadratic program with the closed-form solution

    theta_g = (I + R R^T)^{-1} R gamma
    theta_f = gamma - R^T theta_g

and residual penalty ``gamma^T (I + R^T R)^{-1} gamma``.  Training over
gamma with the *generalized* ridge ``lambda * (I + R^T R)^{-1}`` on the
reduced block and recovering the dropped coefficients with the formulas
above is therefore **exactly** equivalent to the full solve — the
coefficients match to numerical precision, not approximately.

This module is deliberately free of engine imports (the ``Store`` owns the
catalog; ``categorical``/``regression``/``glm`` consume reductions), so it
sits below everything else in the dependency order:

* verification     — :func:`witnessed_mapping` / :func:`extend_mapping`
                     build ``map`` arrays from relations that contain both
                     attributes (every natural-join row projects into such
                     a relation, so a per-relation check is join-sound).
* reduction        — :func:`reduction_plan` picks, per categorical list,
                     which attributes are functionally determined by an
                     earlier one (FD chains compose) and carries the maps.
* penalty/recovery — :func:`penalty_blocks` (the generalized ridge blocks)
                     and :func:`recover_blocks` (the closed form above,
                     with all dependents of one root solved jointly).
* expansion        — :func:`expand_cat_cofactors` reconstructs the *full*
                     categorical cofactor blocks from the reduced ones,
                     purely through the FD maps (used by tests and by
                     callers that need the assembled full matrix).
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

if TYPE_CHECKING:  # pragma: no cover
    from .categorical import CatCofactors
    from .relation import Relation

__all__ = [
    "FDReduction",
    "FunctionalDependency",
    "apply_penalty_blocks",
    "compose_maps",
    "expand_cat_cofactors",
    "extend_mapping",
    "penalty_blocks",
    "recover_blocks",
    "recover_theta_blocks",
    "reduction_plan",
    "witnessed_mapping",
]


@dataclasses.dataclass
class FunctionalDependency:
    """``lhs → rhs`` with its witnessed id mapping.

    ``mapping[i]`` is the rhs dictionary id determined by lhs id ``i``, or
    −1 when id ``i`` never co-occurs with rhs in any witnessing relation
    (such ids cannot survive the natural join, so −1 entries never carry
    data).  ``source`` records how the FD entered the catalog: declared
    FDs are contracts (violating them is an error), inferred FDs are
    data-derived and silently dropped when an append falsifies them.
    """

    lhs: str
    rhs: str
    mapping: np.ndarray  # int64 [D_lhs]
    source: str  # "declared" | "inferred"


@dataclasses.dataclass
class FDReduction:
    """The reduction of one categorical attribute list under an FD catalog.

    ``order``   : the caller's full categorical list (solution layout).
    ``kept``    : the subsequence actually aggregated/solved over.
    ``dropped`` : attr -> (kept root, map root-id -> attr-id); chains are
                  pre-composed onto a kept root.
    ``domains`` : full dictionary domain of every attribute in ``order``.
    """

    order: List[str]
    kept: List[str]
    dropped: Dict[str, Tuple[str, np.ndarray]]
    domains: Dict[str, int]

    @property
    def is_trivial(self) -> bool:
        return not self.dropped

    def signature(self) -> tuple:
        """Hashable structural identity — which attributes are dropped via
        which roots.  Deliberately excludes the map *contents*: appends may
        extend a mapping with new ids without changing the reduction, and
        cached reduced aggregates stay valid under such extensions (the
        reduced blocks never depend on the maps; only expansion/recovery
        do, and they read the then-current maps)."""
        return (
            tuple(self.kept),
            tuple((g, self.dropped[g][0]) for g in self.order if g in self.dropped),
        )

    def root_deps(self) -> Dict[str, List[str]]:
        """kept root -> its dropped dependents (in ``order`` order)."""
        out: Dict[str, List[str]] = {}
        for g in self.order:
            if g in self.dropped:
                out.setdefault(self.dropped[g][0], []).append(g)
        return out


# ---------------------------------------------------------------------------
# Verification
# ---------------------------------------------------------------------------

def extend_mapping(mapping: np.ndarray, l: np.ndarray, r: np.ndarray) -> bool:
    """Fold observed ``(l, r)`` id pairs into ``mapping`` in place.

    Returns False (mapping only partially extended — callers must work on
    a copy) when the pairs conflict with each other or with existing
    entries; True when ``l → r`` remains a function.
    """
    if len(l) == 0:
        return True
    order = np.lexsort((r, l))
    ls, rs = l[order], r[order]
    same_l = ls[1:] == ls[:-1]
    if np.any(same_l & (rs[1:] != rs[:-1])):
        return False
    uniq_l, first = np.unique(ls, return_index=True)
    uniq_r = rs[first]
    cur = mapping[uniq_l]
    if np.any((cur >= 0) & (cur != uniq_r)):
        return False
    mapping[uniq_l] = np.where(cur >= 0, cur, uniq_r)
    return True


def witnessed_mapping(
    relations: Iterable["Relation"],
    lhs: str,
    rhs: str,
    domain: int,
) -> Optional[np.ndarray]:
    """Verify ``lhs → rhs`` against every relation containing both as key
    attributes; return the mapping, or None when no relation witnesses the
    pair or any witness violates functionality.

    Soundness for the join: every natural-join row, projected onto a
    witnessing relation's attributes, IS a tuple of that relation — so an
    FD that holds in each witness holds on the full join result.
    """
    mapping = np.full(max(int(domain), 1), -1, dtype=np.int64)
    witnessed = False
    for rel in relations:
        if lhs not in rel.keys or rhs not in rel.keys:
            continue
        witnessed = True
        l = rel.keys[lhs].astype(np.int64)
        r = rel.keys[rhs].astype(np.int64)
        if len(l) and int(l.max()) >= len(mapping):
            grown = np.full(int(l.max()) + 1, -1, dtype=np.int64)
            grown[: len(mapping)] = mapping
            mapping = grown
        if not extend_mapping(mapping, l, r):
            return None
    return mapping if witnessed else None


def compose_maps(m1: np.ndarray, m2: np.ndarray) -> np.ndarray:
    """``f → g`` composed with ``g → h``: out[i] = m2[m1[i]], −1-propagating."""
    out = np.full(len(m1), -1, dtype=np.int64)
    valid = (m1 >= 0) & (m1 < len(m2))
    out[valid] = m2[m1[valid]]
    return out


# ---------------------------------------------------------------------------
# Reduction planning
# ---------------------------------------------------------------------------

def _fd_adjacency(
    fds: Dict[Tuple[str, str], FunctionalDependency]
) -> Dict[str, List[Tuple[str, np.ndarray]]]:
    """lhs -> [(rhs, mapping)] — built once per plan, shared by every
    BFS (``reduction_plan`` probes |kept|·|order| pairs; rebuilding the
    adjacency inside each probe made planning quadratic in catalog size)."""
    adj: Dict[str, List[Tuple[str, np.ndarray]]] = {}
    for (l, r), fd in fds.items():
        adj.setdefault(l, []).append((r, fd.mapping))
    return adj


def _path_map(
    adj: Dict[str, List[Tuple[str, np.ndarray]]], src: str, dst: str
) -> Optional[np.ndarray]:
    """Composed map along any FD path src → … → dst (BFS, shortest first)."""
    frontier: List[Tuple[str, Optional[np.ndarray]]] = [(src, None)]
    seen = {src}
    while frontier:
        nxt: List[Tuple[str, Optional[np.ndarray]]] = []
        for node, acc in frontier:
            for r, m in adj.get(node, ()):
                composed = m if acc is None else compose_maps(acc, m)
                if r == dst:
                    return composed
                if r not in seen:
                    seen.add(r)
                    nxt.append((r, composed))
        frontier = nxt
    return None


def reduction_plan(
    fds: Dict[Tuple[str, str], FunctionalDependency],
    order: Sequence[str],
    domains: Dict[str, int],
) -> FDReduction:
    """Plan the reduction of ``order`` under the catalog: scan in order,
    keeping an attribute unless an already-kept one determines it (possibly
    through an FD chain whose intermediates need not be in ``order``).
    Scanning in order makes earlier attributes the canonical roots, so two
    attributes that determine each other (a bijection) keep the first and
    drop the second."""
    order = list(order)
    adj = _fd_adjacency(fds)
    kept: List[str] = []
    dropped: Dict[str, Tuple[str, np.ndarray]] = {}
    for attr in order:
        root: Optional[Tuple[str, np.ndarray]] = None
        for k in kept:
            m = _path_map(adj, k, attr)
            if m is not None:
                d_k = int(domains[k])
                if len(m) < d_k:
                    m = np.concatenate(
                        [m, np.full(d_k - len(m), -1, dtype=np.int64)]
                    )
                root = (k, m[:d_k])
                break
        if root is not None:
            dropped[attr] = root
        else:
            kept.append(attr)
    return FDReduction(
        order=order,
        kept=kept,
        dropped=dropped,
        domains={a: int(domains[a]) for a in order},
    )


# ---------------------------------------------------------------------------
# Generalized ridge + closed-form recovery
# ---------------------------------------------------------------------------

def _onehot_map(m: np.ndarray, d_dep: int) -> np.ndarray:
    """V [D_root, D_dep] with V[i, m[i]] = 1 on valid entries (V = R^T)."""
    v = np.zeros((len(m), d_dep), dtype=np.float64)
    valid = np.nonzero(m >= 0)[0]
    v[valid, m[valid]] = 1.0
    return v


def penalty_blocks(red: FDReduction) -> Dict[str, np.ndarray]:
    """Per-root generalized ridge blocks: root f -> (I + Σ_g R_g^T R_g)^{-1}.

    Solving over gamma with ``ridge * P_f`` on the root block (plain ridge
    elsewhere) makes the reduced problem *exactly* the full ridge problem
    after the inner minimization over the dropped coefficients — see the
    module docstring.  Roots without dependents are absent (plain ridge).
    """
    out: Dict[str, np.ndarray] = {}
    for root, deps in red.root_deps().items():
        d_f = red.domains[root]
        m_sum = np.zeros((d_f, d_f), dtype=np.float64)
        for g in deps:
            v = _onehot_map(red.dropped[g][1], red.domains[g])
            m_sum += v @ v.T
        out[root] = np.linalg.inv(np.eye(d_f) + m_sum)
    return out


def recover_blocks(
    gamma: Dict[str, np.ndarray], red: FDReduction
) -> Dict[str, np.ndarray]:
    """Closed-form recovery of every attribute's coefficients from the
    reduced solution.

    ``gamma`` maps each kept attribute to its reduced coefficient block;
    the result maps every attribute in ``red.order`` to its full-model
    block: dropped attributes via theta_g = (I + R R^T)^{-1} R gamma (all
    dependents of one root solved jointly — their cross-terms R_g R_h^T
    are not diagonal), kept roots via theta_f = gamma - R^T theta_g.
    """
    def _norm(f: str) -> np.ndarray:
        g = np.asarray(gamma[f], dtype=np.float64)
        d_f = red.domains[f]
        if len(g) < d_f:  # solver saw a smaller (pre-append) domain
            g = np.concatenate([g, np.zeros(d_f - len(g))])
        return g.copy()

    out: Dict[str, np.ndarray] = {f: _norm(f) for f in red.kept}
    for root, deps in red.root_deps().items():
        g_f = out[root]
        vs = [_onehot_map(red.dropped[g][1], red.domains[g]) for g in deps]
        r_stack = np.concatenate([v.T for v in vs], axis=0)  # [ΣD_g, D_f]
        a = np.eye(r_stack.shape[0]) + r_stack @ r_stack.T
        theta_deps = np.linalg.solve(a, r_stack @ g_f)
        out[root] = g_f - r_stack.T @ theta_deps
        off = 0
        for g in deps:
            d_g = red.domains[g]
            out[g] = theta_deps[off : off + d_g]
            off += d_g
    return out


def apply_penalty_blocks(
    pen: np.ndarray,
    red: FDReduction,
    layout: Sequence[Tuple[str, int, int]],
    ridge: float,
) -> np.ndarray:
    """Overwrite the kept-root diagonal blocks of a base penalty matrix
    with the generalized ridge.

    ``pen`` is the caller's plain-ridge base (any square slice of the θ
    layout); ``layout`` gives ``(attr, offset, width)`` for each KEPT
    categorical block inside it.  Roots without dependents keep the base
    penalty.  A width that drifted from the reduction-time domain (an
    append grew it) embeds the block into an identity — uncovered ids
    have no dependents, so plain ridge is exact for them.  Shared by the
    linear-regression and GLM solvers so the subtle part lives once.
    """
    blocks = penalty_blocks(red)
    for attr, off, width in layout:
        blk = blocks.get(attr)
        if blk is None:
            continue
        if blk.shape[0] != width:
            emb = np.eye(width)
            k = min(width, blk.shape[0])
            emb[:k, :k] = blk[:k, :k]
            blk = emb
        pen[off : off + width, off : off + width] = ridge * blk
    return pen


def recover_theta_blocks(
    theta: np.ndarray,
    red: FDReduction,
    layout: Sequence[Tuple[str, int, int]],
    full_domains: Dict[str, int],
) -> List[Tuple[str, np.ndarray]]:
    """Closed-form recovery from a solved reduced θ vector.

    ``layout`` locates each kept block inside ``theta`` (same triples as
    :func:`apply_penalty_blocks`); the result lists ``(attr, block)`` for
    EVERY attribute in ``red.order``, each block padded to
    ``full_domains[attr]`` (a solver may have seen a smaller pre-append
    domain).  The caller splices them into its own full layout.
    """
    gamma = {attr: theta[off : off + width] for attr, off, width in layout}
    blocks = recover_blocks(gamma, red)
    out: List[Tuple[str, np.ndarray]] = []
    for attr in red.order:
        blk = blocks[attr]
        d = int(full_domains[attr])
        if len(blk) < d:
            blk = np.concatenate([blk, np.zeros(d - len(blk))])
        out.append((attr, blk))
    return out


# ---------------------------------------------------------------------------
# Aggregate-level expansion
# ---------------------------------------------------------------------------

def expand_cat_cofactors(cof: "CatCofactors", red: FDReduction) -> "CatCofactors":
    """Reconstruct the FULL categorical cofactors from reduced ones.

    Every block of a dropped attribute ``g`` (root ``f``) is a deterministic
    image of a kept block under the FD map — per-category counts/sums
    aggregate along the map, pair blocks re-coordinate through it — so the
    expansion touches no data, only the already-computed reduced aggregates:
    O(D_f + nnz) per block.
    """
    from .categorical import CatCofactors, SparseCounts, coalesce_counts

    if red.is_trivial:
        return cof
    if list(cof.cat) != list(red.kept):
        raise ValueError(
            f"reduced cofactors cover {cof.cat}, reduction kept {red.kept}"
        )
    domains = {}
    for a in red.order:
        domains[a] = (
            max(red.domains[a], cof.domains[a])
            if a in cof.domains
            else red.domains[a]
        )

    def checked_map(attr: str) -> Tuple[str, np.ndarray]:
        if attr in red.dropped:
            root, m = red.dropped[attr]
        else:  # kept: identity over the (possibly append-grown) domain
            root, m = attr, np.arange(domains[attr], dtype=np.int64)
        d_root = domains[root]
        if len(m) < d_root:  # append grew the root domain past the map
            m = np.concatenate([m, np.full(d_root - len(m), -1, np.int64)])
        counts = cof.cat_count[root]
        bad = (m[: len(counts)] < 0) & (counts != 0)
        if np.any(bad):
            raise ValueError(
                f"FD map {root}→{attr} lacks entries for observed "
                f"categories {np.nonzero(bad)[0].tolist()[:5]}"
            )
        return root, m

    cat_count: Dict[str, np.ndarray] = {}
    cat_cont: Dict[str, np.ndarray] = {}
    for a in red.order:
        if a in red.kept:
            cat_count[a] = cof.cat_count[a]
            cat_cont[a] = cof.cat_cont[a]
            continue
        root, m = checked_map(a)
        counts = cof.cat_count[root]
        sums = cof.cat_cont[root]
        valid = np.nonzero(m[: len(counts)] >= 0)[0]
        tgt = m[valid]
        cc = np.zeros(domains[a], dtype=np.float64)
        np.add.at(cc, tgt, counts[valid])
        cs = np.zeros((domains[a], sums.shape[1]), dtype=np.float64)
        np.add.at(cs, tgt, sums[valid])
        cat_count[a] = cc
        cat_cont[a] = cs

    def root_pair_coo(ra: str, rb: str) -> SparseCounts:
        """COO of the (ra, rb) kept pair, oriented rows=ra, cols=rb."""
        if (ra, rb) in cof.cat_cat:
            return cof.cat_cat[(ra, rb)]
        coo = cof.cat_cat[(rb, ra)]
        return SparseCounts(
            coo.cols, coo.rows, coo.vals, (coo.shape[1], coo.shape[0])
        )

    cat_cat: Dict[Tuple[str, str], SparseCounts] = {}
    for i in range(len(red.order)):
        for j in range(i + 1, len(red.order)):
            a, b = red.order[i], red.order[j]
            if a not in red.dropped and b not in red.dropped:
                # kept-kept: the stored COO is already canonical — no
                # identity-map re-coalesce needed (kept preserves the
                # relative order of red.order, so orientation matches)
                cat_cat[(a, b)] = cof.cat_cat[(a, b)]
                continue
            root_a, m_a = checked_map(a)
            root_b, m_b = checked_map(b)
            shape = (domains[a], domains[b])
            if root_a == root_b:
                # joint distribution of (a, b) is carried entirely by the
                # shared root's per-category counts
                counts = cof.cat_count[root_a]
                n = len(counts)
                valid = np.nonzero((m_a[:n] >= 0) & (m_b[:n] >= 0))[0]
                cat_cat[(a, b)] = coalesce_counts(
                    m_a[valid], m_b[valid], counts[valid], shape
                )
            else:
                coo = root_pair_coo(root_a, root_b)
                rows = m_a[coo.rows]
                cols = m_b[coo.cols]
                keep = (rows >= 0) & (cols >= 0)
                if np.any(~keep & (coo.vals != 0)):
                    raise ValueError(
                        f"FD maps for ({a}, {b}) lack entries for observed "
                        "co-occurrences"
                    )
                cat_cat[(a, b)] = coalesce_counts(
                    rows[keep], cols[keep], coo.vals[keep], shape
                )
    return CatCofactors(
        count=cof.count,
        lin=cof.lin,
        quad=cof.quad,
        cont=list(cof.cont),
        cat=list(red.order),
        domains=domains,
        cat_count=cat_count,
        cat_cont=cat_cont,
        cat_cat=cat_cat,
    )
