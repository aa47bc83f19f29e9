"""Generalized linear models over the compressed factorized join.

Least squares factors through fixed degree-≤2 cofactors; a GLM's
log-likelihood does not — the nonlinearity (σ for logistic, exp for
Poisson) must be evaluated at each distinct linear predictor value.  The
factorized counterpart (AC/DC's GLM setting) is **row compression**: group
the join result by its distinct feature combination and keep per-group
sufficient statistics

    counts[g] = SUM(1)        GROUP BY features      (group multiplicity)
    ysum[g]   = SUM(y)        GROUP BY features      (label sufficient stat)

which are exactly the aggregates the factorized engine already pushes
through the join — ``FactorizedEngine(group_by=features)`` computes them in
one pass without materializing the flat join.  Every training iteration
then costs O(G·p) for G distinct rows instead of O(m·p); over joins with
categorical keys, G ≪ m (the benchmark's regime).

Categorical features never one-hot expand: the linear predictor gathers
per-category coefficients (``theta[offset_c + id]``) and the gradient
scatter-adds back — a [G, Σ D_c] one-hot matrix exists on neither path.

Two solvers, mirroring ``gd.py``:

* ``irls``  — host fp64 Newton/IRLS with the Hessian assembled block-wise
  from the same grouped statistics (scatter-added, never via a one-hot
  matrix); quadratically convergent, the accuracy reference.
* ``gd``    — float32 on ``GLMConfig.device`` (``"cuda"`` unless the
  caller asks for the CPU), in chunks of predicated steps as ``gd.py``'s
  BGD runs, with an adaptive α gated on the NLL, for large p where an
  O(p³) solve per step is the bottleneck.

The compression runs on the factorized engine's backend: ``"numpy"``
(float64 host, the default) or ``"torch"`` (float32 on ``device``, through
the segment kernels); both return the same float64 design, since counts
and label sums are integers well inside float32's exact range for 0/1
labels.

``fit_glm_onehot`` is the dense one-hot baseline (tests oracle + the slow
side of ``bench_categorical``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .factorize import FactorizedEngine
from .gd import run_predicated
from .store import Store
from .variable_order import VariableOrder

__all__ = [
    "CompressedDesign",
    "GLMConfig",
    "GLMResult",
    "compressed_design_factorized",
    "compressed_design_materialized",
    "fit_glm",
    "fit_glm_onehot",
    "glm_predict_raw",
    "glm_regression",
]


@dataclasses.dataclass(frozen=True)
class GLMConfig:
    family: str = "logistic"  # "logistic" | "poisson"
    ridge: float = 1e-6  # L2 on all coefficients except the intercept
    solver: str = "irls"  # "irls" | "gd"
    max_iter: int = 100  # Newton iterations (irls)
    tol: float = 1e-12  # convergence: mean |grad| per row (irls)
    gd_alpha0: float = 0.5  # α on the per-row-normalized gradient (gd)
    gd_eps: float = 1e-7  # mean-|gradient| stopping threshold (gd)
    gd_max_iter: int = 100_000
    # "fp32": plain fp32 reductions.  "pairs": fp32 compute with the NLL
    # and gradient reductions accumulated in two-float (hi, lo) pairs —
    # ~fp64-precision sums without native fp64 (TPUs have none), closing
    # the gap to IRLS on large compressed designs where the fp32 NLL floor
    # stalls the adaptive-α accept test.
    gd_accum: str = "fp32"
    device: str = "cuda"  # the GD solver's device (irls runs on the host)


@dataclasses.dataclass
class CompressedDesign:
    """The factorized join compressed to distinct feature rows.

    ``cont``     : [G, k] continuous feature values per distinct row
    ``cat_ids``  : [G, n_cat] dictionary ids per distinct row
    ``counts``   : [G] multiplicity of the row in the join result
    ``ysum``     : [G] sum of the label over the row's group
    """

    cont: np.ndarray
    cat_ids: np.ndarray
    counts: np.ndarray
    ysum: np.ndarray
    cont_names: List[str]
    cat_names: List[str]
    domains: Dict[str, int]
    label: str

    @property
    def num_rows(self) -> int:
        return int(self.counts.shape[0])

    @property
    def total_rows(self) -> float:
        return float(self.counts.sum())

    @property
    def num_params(self) -> int:
        return (
            1
            + len(self.cont_names)
            + sum(self.domains[c] for c in self.cat_names)
        )

    def param_names(self) -> List[str]:
        names = ["intercept"] + list(self.cont_names)
        for c in self.cat_names:
            names.extend(f"{c}={g}" for g in range(self.domains[c]))
        return names

    def cat_offsets(self) -> np.ndarray:
        """Start index of each categorical block inside θ."""
        off = 1 + len(self.cont_names)
        out = []
        for c in self.cat_names:
            out.append(off)
            off += self.domains[c]
        return np.asarray(out, dtype=np.int64)

    def offset_ids(self) -> np.ndarray:
        """[G, n_cat] ids pre-shifted into θ coordinates — one gather of
        ``theta[offset_ids]`` evaluates every categorical contribution."""
        if not self.cat_names:
            return np.zeros((self.num_rows, 0), dtype=np.int64)
        return self.cat_ids.astype(np.int64) + self.cat_offsets()[None, :]

    def linpred(self, theta: np.ndarray) -> np.ndarray:
        """η_g = θ₀ + x_g·θ_cont + Σ_c θ_c[id_{g,c}] — no one-hot."""
        eta = theta[0] + self.cont @ theta[1 : 1 + len(self.cont_names)]
        if self.cat_names:
            eta = eta + theta[self.offset_ids()].sum(axis=1)
        return eta


# ---------------------------------------------------------------------------
# Compression
# ---------------------------------------------------------------------------

def compressed_design_factorized(
    store: Store,
    vorder: VariableOrder,
    cont: Sequence[str],
    cat: Sequence[str],
    label: str,
    backend: str = "numpy",
    use_view_cache: Optional[bool] = None,
    device="cuda",
) -> CompressedDesign:
    """One factorized GROUP BY over *all* feature attributes: the engine
    carries count and Σy per distinct feature combination to the root —
    O(factorization size), flat join never materialized.  The descent
    shares the store's persistent view cache with the cofactor paths, so
    an IRLS re-solve (or a design over a feature subset already swept)
    starts from cached subtree views; ``use_view_cache=False`` opts out.
    ``backend="torch"`` runs the traversal in float32 on ``device``."""
    cont, cat = list(cont), list(cat)
    g = FactorizedEngine(
        store,
        vorder,
        [label],
        backend=backend,
        group_by=cont + cat,
        use_view_cache=use_view_cache,
        device=device,
    ).grouped_cofactors()
    x = (
        np.stack([g.keys[f] for f in cont], axis=1)
        if cont
        else np.zeros((g.num_groups, 0))
    )
    ids = (
        np.stack([g.ids(c) for c in cat], axis=1)
        if cat
        else np.zeros((g.num_groups, 0), dtype=np.int64)
    )
    return CompressedDesign(
        cont=x,
        cat_ids=ids,
        counts=g.count,
        ysum=g.lin[:, 0],
        cont_names=cont,
        cat_names=cat,
        domains={c: store.attr_domain(c) for c in cat},
        label=label,
    )


def compressed_design_materialized(
    store: Store,
    cont: Sequence[str],
    cat: Sequence[str],
    label: str,
    relations: Optional[Sequence[str]] = None,
) -> CompressedDesign:
    """Oracle path: materialize the join, then np.unique the feature rows."""
    cont, cat = list(cont), list(cat)
    joined = store.materialize_join(relations)
    m = joined.num_rows
    feats = np.column_stack(
        [joined.column(f).astype(np.float64) for f in cont + cat]
    ) if (cont or cat) else np.zeros((m, 0))
    y = joined.column(label).astype(np.float64)
    uniq, inv = np.unique(feats, axis=0, return_inverse=True)
    counts = np.bincount(inv, minlength=len(uniq)).astype(np.float64)
    ysum = np.bincount(inv, weights=y, minlength=len(uniq))
    return CompressedDesign(
        cont=uniq[:, : len(cont)],
        cat_ids=uniq[:, len(cont) :].astype(np.int64),
        counts=counts,
        ysum=ysum,
        cont_names=cont,
        cat_names=cat,
        domains={c: store.attr_domain(c) for c in cat},
        label=label,
    )


# ---------------------------------------------------------------------------
# Families
# ---------------------------------------------------------------------------

def _sigmoid(eta: np.ndarray) -> np.ndarray:
    out = np.empty_like(eta)
    pos = eta >= 0
    out[pos] = 1.0 / (1.0 + np.exp(-eta[pos]))
    e = np.exp(eta[~pos])
    out[~pos] = e / (1.0 + e)
    return out


def _family_stats(
    family: str, eta: np.ndarray, counts: np.ndarray, ysum: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, float]:
    """(dL/dη per group, IRLS weights per group, negative log-likelihood)."""
    if family == "logistic":
        p = _sigmoid(eta)
        grad = counts * p - ysum
        w = np.maximum(counts * p * (1.0 - p), 1e-12)
        # log(1+e^η) evaluated stably
        softplus = np.where(eta > 30, eta, np.log1p(np.exp(np.minimum(eta, 30))))
        nll = float((counts * softplus - ysum * eta).sum())
    elif family == "poisson":
        mu = np.exp(np.minimum(eta, 30))
        grad = counts * mu - ysum
        w = np.maximum(counts * mu, 1e-12)
        nll = float((counts * mu - ysum * eta).sum())
    else:
        raise ValueError(f"unknown GLM family {family!r}")
    return grad, w, nll


# ---------------------------------------------------------------------------
# Solvers
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class GLMResult:
    theta: np.ndarray  # [p] in param_names() order
    iterations: int
    converged: bool
    nll: float  # penalized negative log-likelihood at θ
    config: GLMConfig
    names: List[str]
    seconds_compress: float = 0.0
    seconds_fit: float = 0.0

    def coef(self, name: str) -> float:
        return float(self.theta[self.names.index(name)])


def _grad_theta(
    design: CompressedDesign, grad_eta: np.ndarray, oid: np.ndarray
) -> np.ndarray:
    """Scatter dL/dη back through the (never-materialized) design."""
    p = design.num_params
    k = len(design.cont_names)
    g = np.zeros(p, dtype=np.float64)
    g[0] = grad_eta.sum()
    g[1 : 1 + k] = design.cont.T @ grad_eta
    if design.cat_names:
        np.add.at(g, oid, grad_eta[:, None])
    return g


def _hessian(
    design: CompressedDesign, w: np.ndarray, oid: np.ndarray
) -> np.ndarray:
    """X^T W X assembled block-wise from grouped statistics — the weighted
    version of ``CatCofactors.matrix``, rebuilt each IRLS step because W
    depends on θ.  Still no one-hot matrix: every categorical block is a
    scatter-add over the G compressed rows."""
    p = design.num_params
    k = len(design.cont_names)
    x = design.cont
    wx = w[:, None] * x
    h = np.zeros((p, p), dtype=np.float64)
    h[0, 0] = w.sum()
    h[0, 1 : 1 + k] = wx.sum(axis=0)
    h[1 : 1 + k, 1 : 1 + k] = x.T @ wx
    ncat = len(design.cat_names)
    for i in range(ncat):
        col = oid[:, i]
        np.add.at(h[0], col, w)  # intercept × cat
        np.add.at(h, (col, col), w)  # diagonal block
        for j in range(k):  # cont × cat
            np.add.at(h[1 + j], col, wx[:, j])
        for j in range(i + 1, ncat):  # cat × cat (upper)
            np.add.at(h, (col, oid[:, j]), w)
    iu = np.triu_indices(p, 1)
    h[(iu[1], iu[0])] = h[iu]  # mirror the upper triangle
    return h


def fit_glm(
    design: CompressedDesign,
    config: Optional[GLMConfig] = None,
    penalty: Optional[np.ndarray] = None,
) -> GLMResult:
    """Train a GLM on the compressed representation.

    ``penalty``, when given, is a full [p, p] penalty matrix replacing the
    default ``diag(0, ridge, …, ridge)`` — the generalized ridge of the
    FD-reduced parameter space (see ``repro.core.fd``): the penalized NLL
    gains ``0.5·θᵀ·penalty·θ``, its gradient ``penalty·θ``, the Hessian
    ``penalty``.  The intercept row/column should be zero to keep it
    unpenalized."""
    cfg = config or GLMConfig()
    t0 = time.perf_counter()
    if cfg.solver == "irls":
        res = _fit_irls(design, cfg, penalty=penalty)
    elif cfg.solver == "gd":
        res = _fit_gd(design, cfg, penalty=penalty)
    else:
        raise ValueError(f"unknown solver {cfg.solver!r}")
    res.seconds_fit = time.perf_counter() - t0
    return res


def _penalty(cfg: GLMConfig, theta: np.ndarray) -> float:
    """Plain ridge penalty value (intercept-free) — the scalar twin of
    ``_default_penalty``, kept as the reference formula for tests."""
    return 0.5 * cfg.ridge * float(theta[1:] @ theta[1:])


def _default_penalty(cfg: GLMConfig, p: int) -> np.ndarray:
    pen = np.full(p, cfg.ridge)
    pen[0] = 0.0  # intercept unpenalized
    return np.diag(pen)


def _fit_irls(
    design: CompressedDesign,
    cfg: GLMConfig,
    penalty: Optional[np.ndarray] = None,
) -> GLMResult:
    p = design.num_params
    oid = design.offset_ids()
    theta = np.zeros(p, dtype=np.float64)
    pen = penalty if penalty is not None else _default_penalty(cfg, p)
    m = max(design.total_rows, 1.0)

    def pen_val(t: np.ndarray) -> float:
        return 0.5 * float(t @ (pen @ t))

    eta = design.linpred(theta)
    grad_eta, w, nll = _family_stats(
        cfg.family, eta, design.counts, design.ysum
    )
    nll += pen_val(theta)
    # the gradient is carried through the loop: an accepted full Newton
    # step hands its candidate gradient to the next iteration, so the
    # common path costs ONE _grad_theta + pen matvec per iteration.
    grad = _grad_theta(design, grad_eta, oid) + pen @ theta
    converged = False
    it = 0
    for it in range(1, cfg.max_iter + 1):  # noqa: B007 — `it` is read after the loop (iterations=it)
        if np.abs(grad).max() / m < cfg.tol:
            converged = True
            break
        h = _hessian(design, w, oid) + pen
        # tiny jitter keeps the solve well-posed when a category is empty
        h[np.diag_indices(p)] += 1e-10
        step = np.linalg.solve(h, grad)
        # full Newton step first: accept on NLL decrease OR on gradient
        # contraction.  Near the optimum the per-step NLL decrease is far
        # below fp64 resolution of the total, so an NLL-only gate starts
        # rejecting (or accepting ~zero-length backtracked variants of)
        # genuinely contracting steps on rounding noise — two formulations
        # of the same problem (e.g. the FD-reduced and the full solve)
        # would then stop ~1e-8 apart; gating on ∇ runs both to the
        # numerical floor, where they agree to ~1e-12.
        cand = theta - step
        g2, w2, nll2 = _family_stats(
            cfg.family, design.linpred(cand), design.counts, design.ysum
        )
        nll2 += pen_val(cand)
        grad_cand = _grad_theta(design, g2, oid) + pen @ cand
        if nll2 <= nll + 1e-15 or (
            np.abs(grad_cand).max() < np.abs(grad).max()
        ):
            theta, grad_eta, w, nll, grad = cand, g2, w2, nll2, grad_cand
            continue
        # overshoot: backtracking line search on the penalized NLL
        scale = 0.5
        for _ in range(29):
            cand = theta - scale * step
            g2, w2, nll2 = _family_stats(
                cfg.family, design.linpred(cand), design.counts, design.ysum
            )
            nll2 += pen_val(cand)
            if nll2 <= nll + 1e-15:
                theta, grad_eta, w, nll = cand, g2, w2, nll2
                grad = _grad_theta(design, g2, oid) + pen @ cand
                break
            scale *= 0.5
        else:  # no improving step in either gate — at numerical precision
            converged = True
            break
    return GLMResult(
        theta=theta,
        iterations=it,
        converged=converged,
        nll=nll,
        config=cfg,
        names=design.param_names(),
    )


def _two_sum(a, b):
    """Knuth's error-free transformation: s + err == a + b exactly (each
    ``+`` / ``-`` one rounded operation, as eager tensor ops are: never
    compile this into fused code that may contract or reassociate)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _pow2(n: int) -> int:
    """The least power of two ≥ ``n`` (1 for ``n`` ≤ 1)."""
    return 1 << max(n - 1, 0).bit_length()


def _pairwise_sum2(v: torch.Tensor):
    """Compensated pairwise reduction of ``v`` along axis 0.

    Returns an (hi, lo) two-float pair whose exact sum carries ~2× the
    significand of one float — the mixed-precision accumulator for the GD
    solver (fp32 per-element compute, fp64-grade sums).  ``v`` is padded
    once with zeros to the next power of two: the reference pads each odd
    level with one zero, which pairs the same elements, so the tree (and
    every bit of the result) is the same, and no level needs a
    concatenation.  The tree has ⌈log₂ G⌉ levels; each level's exact
    two-sum errors accumulate in ``lo`` (they are ~eps·|terms|, so their
    own fp32 sum is harmless)."""
    n = v.shape[0]
    size = _pow2(n)
    if size != n:
        v = torch.cat([v, v.new_zeros((size - n,) + tuple(v.shape[1:]))])
    hi = v
    lo = torch.zeros_like(v)
    while hi.shape[0] > 1:
        s, e = _two_sum(hi[0::2], hi[1::2])
        lo = lo[0::2] + lo[1::2] + e
        hi = s
    return hi[0], lo[0]


def _fit_gd(
    design: CompressedDesign,
    cfg: GLMConfig,
    penalty: Optional[np.ndarray] = None,
) -> GLMResult:
    """GD in float32 on ``cfg.device``, mirroring ``gd.py``'s loop but
    adapted to a non-quadratic objective: the adaptive α decision
    gates on the penalized NLL (accept if it decreased, else revert and
    shrink α) and convergence is the per-row mean |gradient| — gating on
    Σ|α·grad| as in least squares lets α collapse masquerade as
    convergence once the objective is not quadratic.  The steps run in
    chunks of predicated steps (``gd.run_predicated``): once the stop
    condition holds a step leaves the whole carry as it was, so the
    iteration count is exact and the host reads one flag per chunk.

    Continuous columns are scaled to (x − avg)/max|·| internally — the
    paper's §3.3 convergence prerequisite, weighted by group counts since
    compressed rows carry multiplicity — and θ is rescaled back exactly
    before returning (one-hot coordinates need no scaling).  The ridge
    penalty applies to the *scaled* coefficients here, so with ridge > 0
    the GD optimum differs from IRLS's by O(ridge); IRLS is the accuracy
    reference, GD the large-p path.

    With ``cfg.gd_accum == "pairs"`` the NLL and the dense gradient
    reductions accumulate in two-float (hi, lo) pairs and the accept test
    compares NLL *pairs*: near the optimum the true per-step decrease is
    far below fp32 resolution of the total NLL, so the plain-fp32 gate
    rejects genuinely improving steps and α collapses at the fp32 floor —
    the pair comparison keeps resolving descent ~2³⁰× finer at the same
    fp32 element compute.  The categorical gradient is an ``index_add_``
    per categorical column; on a GPU its float32 adds run in a varying
    order."""
    nll_grad, avg, mx = _gd_objective(design, cfg, penalty)
    f32 = dict(dtype=torch.float32, device=torch.device(cfg.device))
    k = len(design.cont_names)
    m = max(design.total_rows, 1.0)

    def running(carry):
        _, _, _, _, alpha, it, converged = carry
        return (~converged) & (it < cfg.gd_max_iter) & (alpha > 1e-15)

    def step(carry):
        # carry holds (nll pair, g) AT theta, so each step costs ONE
        # nll_grad: the candidate's evaluation becomes the next step's
        # current one.
        theta, nll_hi, nll_lo, g, alpha, it, _ = carry
        cand = theta - alpha * g / m
        nh_c, nl_c, g_c = nll_grad(cand)
        # pair comparison: (nh_c + nl_c) < (nh + nl) evaluated on the
        # residuals so the lo parts are not absorbed by the hi rounding
        ok = (nh_c - nll_hi) + (nl_c - nll_lo) < 0.0
        g_new = torch.where(ok, g_c, g)
        return (
            torch.where(ok, cand, theta),
            torch.where(ok, nh_c, nll_hi),
            torch.where(ok, nl_c, nll_lo),
            g_new,
            torch.where(ok, alpha * 1.05, alpha / 3.0),
            it + 1,
            torch.sum(torch.abs(g_new)) / m < cfg.gd_eps,
        )

    theta0 = torch.zeros((design.num_params,), **f32)
    nh0, nl0, g0 = nll_grad(theta0)
    carry = (
        theta0,
        nh0,
        nl0,
        g0,
        torch.tensor(cfg.gd_alpha0, **f32),
        torch.zeros((), dtype=torch.int32, device=f32["device"]),
        torch.zeros((), dtype=torch.bool, device=f32["device"]),
    )
    theta, _, _, _, _, it, converged = run_predicated(carry, running, step)
    theta_np = theta.cpu().numpy().astype(np.float64)
    if k:  # invert the internal scaling: η is identical by construction
        theta_np[0] -= float((theta_np[1 : 1 + k] / mx) @ avg)
        theta_np[1 : 1 + k] /= mx
    _, _, nll = _family_stats(
        cfg.family, design.linpred(theta_np), design.counts, design.ysum
    )
    if penalty is None:
        pen_final = _penalty(cfg, theta_np)
    else:
        pen_final = 0.5 * float(theta_np @ (penalty @ theta_np))
    return GLMResult(
        theta=theta_np,
        iterations=int(it),
        converged=bool(converged),
        nll=nll + pen_final,
        config=cfg,
        names=design.param_names(),
    )


def _gd_objective(
    design: CompressedDesign,
    cfg: GLMConfig,
    penalty: Optional[np.ndarray] = None,
):
    """The GD solver's objective on ``cfg.device``: (nll_grad, avg, mx).
    ``nll_grad(theta)`` takes float32 θ in the scaled coordinates, where
    continuous column j is (x − avg[j]) / mx[j], and returns (nll_hi,
    nll_lo, g): the penalized NLL as a two-float pair (lo ≡ 0 with
    ``gd_accum="fp32"``) and its gradient."""
    if cfg.gd_accum not in ("fp32", "pairs"):
        raise ValueError(f"unknown gd_accum {cfg.gd_accum!r}")
    device = torch.device(cfg.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the GD solver runs on device='cuda' by default and no CUDA "
            "device is available; set GLMConfig.device='cpu' to run on the CPU"
        )
    pairs = cfg.gd_accum == "pairs"
    f32 = dict(dtype=torch.float32, device=device)
    p = design.num_params
    k = len(design.cont_names)
    n = design.num_rows
    m = max(design.total_rows, 1.0)
    avg = (design.counts @ design.cont) / m if k else np.zeros(0)
    mx = (
        np.maximum(np.abs(design.cont - avg).max(axis=0), 1e-12)
        if k
        else np.zeros(0)
    )
    cont = torch.as_tensor((design.cont - avg) / mx, **f32)
    counts = torch.as_tensor(design.counts, **f32)
    ysum = torch.as_tensor(design.ysum, **f32)
    oid = torch.as_tensor(design.offset_ids(), device=device)
    oid_cols = [oid[:, c].contiguous() for c in range(oid.shape[1])]
    if penalty is None:
        # plain ridge stays a vector: a dense [p, p] matvec per iteration
        # (and the matrix itself) would be O(p²) for nothing on the large-p
        # workloads this solver exists for
        ridge_vec = torch.full((p,), cfg.ridge, **f32)
        ridge_vec[0] = 0.0

        def pen_grad(theta):
            return ridge_vec * theta

        def pen_quad(theta):
            return 0.5 * cfg.ridge * torch.sum(theta[1:] ** 2)

    else:
        pen_mat = torch.as_tensor(penalty, **f32)

        def pen_grad(theta):
            return pen_mat @ theta

        def pen_quad(theta):
            return 0.5 * theta @ (pen_mat @ theta)

    family = cfg.family
    if family not in ("logistic", "poisson"):
        raise ValueError(f"unknown GLM family {family!r}")
    # the pairwise tree's input, [NLL terms, dL/dη, x·dL/dη] a row, padded
    # once with zero rows to a power of two: each step writes rows [0, n)
    stack = torch.zeros((_pow2(n), 2 + k), **f32) if pairs else None

    def nll_grad(theta):
        """Returns (nll_hi, nll_lo, g): the penalized NLL as a two-float
        pair (lo ≡ 0 on the plain fp32 path) plus the gradient."""
        eta = theta[0] + cont @ theta[1 : 1 + k]
        if oid_cols:
            eta = eta + theta[oid].sum(dim=1)
        if family == "logistic":
            grad_eta = counts * torch.sigmoid(eta) - ysum
            terms = counts * torch.nn.functional.softplus(eta) - ysum * eta
        else:
            mu = torch.exp(torch.clamp(eta, max=30.0))
            grad_eta = counts * mu - ysum
            terms = counts * mu - ysum * eta
        g = torch.zeros((p,), **f32)
        if pairs:
            stack[:n, 0] = terms
            stack[:n, 1] = grad_eta
            stack[:n, 2:] = cont * grad_eta[:, None]
            hi, lo = _pairwise_sum2(stack)
            nll_hi, nll_lo = hi[0], lo[0]
            g[: 1 + k] = hi[1:] + lo[1:]
        else:
            nll_hi, nll_lo = torch.sum(terms), torch.zeros((), **f32)
            g[0] = grad_eta.sum()
            g[1 : 1 + k] = cont.T @ grad_eta
        for col in oid_cols:
            g.index_add_(0, col, grad_eta)
        g = g + pen_grad(theta)
        nll_hi, err = _two_sum(nll_hi, pen_quad(theta))
        return nll_hi, nll_lo + err, g

    return nll_grad, avg, mx


def fit_glm_onehot(
    x: np.ndarray, y: np.ndarray, config: Optional[GLMConfig] = None
) -> GLMResult:
    """Dense one-hot baseline: Newton over the materialized [m, p-1] design
    (intercept added internally).  The oracle the compressed path must match
    — and the memory/runtime wall it avoids.

    Implemented as the degenerate compression: one group per ROW (counts
    all ones, any one-hot columns treated as plain continuous features), so
    both sides of every oracle comparison run the SAME ``_fit_irls`` loop
    and the comparison isolates exactly what the compressed path adds —
    grouping and the sparse categorical gather/scatter."""
    cfg = config or GLMConfig()
    m, k = x.shape
    design = CompressedDesign(
        cont=x.astype(np.float64),
        cat_ids=np.zeros((m, 0), dtype=np.int64),
        counts=np.ones(m, dtype=np.float64),
        ysum=np.asarray(y, dtype=np.float64),
        cont_names=[f"x{i}" for i in range(k)],
        cat_names=[],
        domains={},
        label="y",
    )
    return _fit_irls(design, cfg)


# ---------------------------------------------------------------------------
# Pipeline + prediction
# ---------------------------------------------------------------------------

def glm_predict_raw(
    theta: np.ndarray,
    cont: np.ndarray,
    cat_ids: np.ndarray,
    design: CompressedDesign,
    family: str,
) -> np.ndarray:
    """Mean response for raw feature columns (cont [n, k], cat_ids [n, c])
    under the layout of ``design``.  ``family`` is required — pass the one
    the model was trained with (``GLMResult.config.family``); a silent
    default would make a Poisson model predict through a sigmoid."""
    k = len(design.cont_names)
    eta = theta[0] + cont @ theta[1 : 1 + k]
    if design.cat_names:
        oid = cat_ids.astype(np.int64) + design.cat_offsets()[None, :]
        eta = eta + theta[oid].sum(axis=1)
    if family == "logistic":
        return _sigmoid(eta)
    if family == "poisson":
        return np.exp(eta)
    raise ValueError(f"unknown GLM family {family!r}")


def _fd_layout(design: CompressedDesign):
    """(attr, offset, width) of each kept categorical block inside θ —
    the layout handle ``repro.core.fd``'s shared penalty/recovery helpers
    consume."""
    offs = design.cat_offsets()
    return [
        (c, int(offs[i]), design.domains[c])
        for i, c in enumerate(design.cat_names)
    ]


def _fd_penalty_matrix(design: CompressedDesign, red, ridge: float) -> np.ndarray:
    """Generalized ridge over the reduced design's θ layout: plain ridge on
    continuous coordinates and on kept blocks without dependents, the
    per-root ``(I + Σ RᵀR)^{-1}`` block (scaled by ridge) on roots that
    absorbed dropped attributes, zero on the intercept."""
    from .fd import apply_penalty_blocks

    p = design.num_params
    pen = np.full(p, ridge)
    pen[0] = 0.0
    return apply_penalty_blocks(np.diag(pen), red, _fd_layout(design), ridge)


def _fd_expand_result(
    res: GLMResult, design: CompressedDesign, red, full_domains: Dict[str, int]
) -> GLMResult:
    """Recover the dropped attributes' coefficients in closed form and
    re-assemble θ/names in the FULL categorical layout — indistinguishable
    from an unreduced fit."""
    from .fd import recover_theta_blocks

    k = len(design.cont_names)
    parts = [res.theta[: 1 + k]]
    names = ["intercept"] + list(design.cont_names)
    for c, blk in recover_theta_blocks(
        res.theta, red, _fd_layout(design), full_domains
    ):
        parts.append(blk)
        names.extend(f"{c}={g}" for g in range(len(blk)))
    res.theta = np.concatenate(parts)
    res.names = names
    return res


def glm_regression(
    store: Store,
    vorder: Optional[VariableOrder],
    cont: Sequence[str],
    cat: Sequence[str],
    label: str,
    config: Optional[GLMConfig] = None,
    factorized: bool = True,
    backend: str = "numpy",
    use_fds: bool = True,
) -> GLMResult:
    """End-to-end GLM training: compress the join (factorized GROUP BY or
    materialized oracle), then fit — the ``linear_regression`` analogue for
    the categorical/GLM workload.  ``config.device`` is where a
    ``backend="torch"`` compression and the GD solver run.

    ``use_fds=True`` (the default; a no-op unless FDs are registered on the
    store) trains over the FD-reduced parameter space: functionally
    determined categorical attributes are dropped from the GROUP BY and
    from θ (the compression yields the same groups — the dropped ids are a
    function of the kept ones — but IRLS factors a strictly smaller
    Hessian), the ridge becomes the generalized per-root penalty, and the
    dropped coefficients are recovered in closed form afterwards, so the
    returned θ/names match the full fit exactly."""
    cfg = config or GLMConfig()
    cont, cat = list(cont), list(cat)
    red = store.fd_reduction(cat) if use_fds else None
    if red is not None and red.is_trivial:
        red = None
    fit_cat = list(red.kept) if red is not None else cat
    t0 = time.perf_counter()
    if factorized:
        if vorder is None:
            raise ValueError("factorized mode requires a variable order")
        design = compressed_design_factorized(
            store, vorder, cont, fit_cat, label, backend=backend,
            device=cfg.device,
        )
    else:
        design = compressed_design_materialized(store, cont, fit_cat, label)
    t1 = time.perf_counter()
    penalty = (
        _fd_penalty_matrix(design, red, cfg.ridge) if red is not None else None
    )
    res = fit_glm(design, cfg, penalty=penalty)
    if red is not None:
        full_domains = {c: store.attr_domain(c) for c in red.order}
        res = _fd_expand_result(res, design, red, full_domains)
    res.seconds_compress = t1 - t0
    return res
