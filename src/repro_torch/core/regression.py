"""End-to-end in-database linear regression (paper §4.5, Table 2).

``linear_regression`` mirrors the paper's ``linearRegression(...)``:
scale features → compute cofactors (factorized or materialized) → batch
gradient descent on the cofactor matrix → rescale θ.  The six benchmark
versions of Table 2 are provided as named configurations.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .api import StoreReads
from .categorical import (
    cat_cofactors_factorized,
    cat_cofactors_materialized,
    onehot_design_matrix,
)
from .cofactor import cofactors_factorized, design_matrix
from .fd import apply_penalty_blocks, recover_theta_blocks
from .gd import GDConfig, GDResult, bgd_cofactor, bgd_data, solve_cofactor
from .scaling import ScaleFactors, compute_scale_factors, predict, rescale_theta
from .variable_order import VariableOrder

__all__ = ["RegressionConfig", "RegressionResult", "VERSIONS", "linear_regression"]


@dataclasses.dataclass(frozen=True)
class RegressionConfig:
    """One row of the paper's Table 2 'version' column, plus the pipeline
    routing knobs."""

    name: str = "v1"
    factorized: bool = True  # fact vs noPre
    eps: float = 1e-6  # version 3: 1e-8
    alpha_strategy: str = "paper"  # version 4/5: "revert"
    theta0_mode: str = "avg_label"  # versions 5/6: "theta0_conv"
    ridge: float = 0.006
    max_iter: int = 200_000
    solver: str = "bgd"  # "bgd" | "closed_form" (beyond-paper)
    # -- pipeline routing ---------------------------------------------------
    backend: str = "torch"  # engine value math: "torch" | "numpy"
    device: str = "cuda"  # torch engine, the kernels and BGD
    # moments kernel for the scale factors; on the categorical materialized
    # path, the multi_segment_gram kernel for the grouped blocks
    use_kernel: bool = False
    categorical: Tuple[str, ...] = ()  # subset of features, sparse blocks
    use_fds: bool = True  # FD-reduced categorical solve
    # fused per-node traversal kernels (repro_torch.kernels.segment_view);
    # None = engine default (on for the torch backend, off for numpy)
    use_node_kernels: Optional[bool] = None

    def gd(self) -> GDConfig:
        return GDConfig(
            eps=self.eps,
            ridge=self.ridge,
            max_iter=self.max_iter,
            alpha_strategy=self.alpha_strategy,
            device=self.device,
        )


#: The paper's Table 2 versions, reproduced as configurations.
VERSIONS: Dict[str, RegressionConfig] = {
    "v1": RegressionConfig(name="v1 fact"),
    "v2": RegressionConfig(name="v2 noPre", factorized=False),
    "v3": RegressionConfig(name="v3 fact,eps", eps=1e-8),
    "v4": RegressionConfig(name="v4 fact,alpha", alpha_strategy="revert"),
    "v5": RegressionConfig(
        name="v5 fact,alpha,theta0",
        alpha_strategy="revert",
        theta0_mode="theta0_conv",
    ),
    "v6": RegressionConfig(
        name="v6 noPre,theta0", factorized=False, theta0_mode="theta0_conv"
    ),
    # beyond-paper: exact closed-form solve on the factorized cofactors
    "closed": RegressionConfig(
        name="closed-form fact", solver="closed_form", theta0_mode="exact"
    ),
}


@dataclasses.dataclass
class RegressionResult:
    theta: np.ndarray  # in ORIGINAL units: [intercept, features..., label=-1]
    theta_conv: np.ndarray  # in scaled units
    factors: Optional[ScaleFactors]  # None on the categorical path
    iterations: int
    seconds_scale: float
    seconds_cofactor: float
    seconds_gd: float
    config: RegressionConfig
    names: Optional[List[str]] = None  # categorical path: assembled θ layout

    @property
    def seconds_total(self) -> float:
        return self.seconds_scale + self.seconds_cofactor + self.seconds_gd

    def evaluate(
        self,
        store: StoreReads,
        features: Sequence[str],
        label: str,
        categorical: Sequence[str] = (),
    ) -> Dict[str, float]:
        """Average absolute / relative error over the joined data (paper §5).
        With ``categorical`` the design matrix is the dense one-hot one (a
        test-size oracle: it has ``Σ D_c`` columns per row)."""
        joined = store.materialize_join()
        if categorical:
            x, _ = onehot_design_matrix(
                joined,
                [f for f in features if f not in categorical],
                list(categorical),
                {c: store.attr_domain(c) for c in categorical},
            )
        else:
            x = design_matrix(joined, features)
        y = joined.column(label).astype(np.float64)
        pred = predict(x, self.theta)
        abs_err = np.abs(y - pred)
        denom = np.where(np.abs(y) < 1e-9, np.nan, np.abs(y))
        rel = abs_err / denom
        return {
            "avg_abs_err": float(abs_err.mean()),
            "avg_rel_err": float(np.nanmean(rel)),
            "rmse": float(np.sqrt((abs_err**2).mean())),
        }


def linear_regression(
    store: StoreReads,
    vorder: Optional[VariableOrder],
    features: Sequence[str],
    label: str,
    config: Optional[RegressionConfig] = None,
) -> RegressionResult:
    """The paper's ``linearRegression(...)`` pipeline.  All routing lives on
    :class:`RegressionConfig`; its ``device`` (``"cuda"`` by default) is
    where the torch engine, the kernels and BGD run.

    ``categorical`` declares a subset of ``features`` as categorical: their
    cofactor blocks become group-by aggregates (sparse, one-hot-free — see
    ``repro_torch.core.categorical``) and θ gains one coefficient per
    category in ``RegressionResult.names`` order.  Routed through the
    closed-form or BGD solver on the assembled matrix; features are used
    unscaled (pair with ``solver='closed_form'`` — the default
    ``VERSIONS['closed']`` — unless the continuous columns are pre-scaled).
    """
    cfg = config or VERSIONS["v1"]
    features = list(features)
    if cfg.factorized and vorder is None:
        raise ValueError("factorized mode requires a variable order")
    if cfg.categorical:
        return _linear_regression_categorical(
            store, vorder, features, label, cfg
        )

    t0 = time.perf_counter()
    factors = compute_scale_factors(
        store, features, label, use_kernel=cfg.use_kernel, device=cfg.device
    )
    t1 = time.perf_counter()

    cols = features + [label]  # cofactor ordering: [intercept] + cols
    if cfg.factorized:
        cof = cofactors_factorized(
            store,
            vorder,
            cols,
            backend=cfg.backend,
            scale=factors,
            use_node_kernels=cfg.use_node_kernels,
            device=cfg.device,
        )
        cof_matrix = cof.matrix()
        t2 = time.perf_counter()
        if cfg.solver == "closed_form":
            theta_conv = solve_cofactor(cof_matrix, ridge=cfg.ridge)
            iters = 0
        else:
            res: GDResult = bgd_cofactor(cof_matrix, cfg.gd())
            theta_conv, iters = res.theta, res.iterations
    else:
        # noPre: materialize the join, rescan the data every GD iteration.
        joined = store.materialize_join()
        x = design_matrix(joined, cols, scale=factors)
        z = np.concatenate([np.ones((x.shape[0], 1)), x], axis=1)
        t2 = time.perf_counter()
        if cfg.solver == "closed_form":
            theta_conv = solve_cofactor(z.T @ z, ridge=cfg.ridge)
            iters = 0
        else:
            res = bgd_data(z, cfg.gd())
            theta_conv, iters = res.theta, res.iterations
    t3 = time.perf_counter()

    theta = rescale_theta(theta_conv, factors, mode=cfg.theta0_mode)
    return RegressionResult(
        theta=theta,
        theta_conv=theta_conv,
        factors=factors,
        iterations=iters,
        seconds_scale=t1 - t0,
        seconds_cofactor=t2 - t1,
        seconds_gd=t3 - t2,
        config=cfg,
    )


def _linear_regression_categorical(
    store: StoreReads,
    vorder: Optional[VariableOrder],
    features: List[str],
    label: str,
    cfg: RegressionConfig,
) -> RegressionResult:
    """Least squares with categorical features over the sparse cofactor
    algebra: assemble the one-hot cofactor matrix from grouped aggregates
    (never the one-hot data) and hand it to the same solvers.

    With ``use_fds=True`` (a no-op unless the store has FDs covering
    ``categorical``), the solve runs over the FD-reduced parameter space:
    determined attributes are dropped before the engine traversal (fewer
    GROUP BY queries, smaller assembled Gram), the ridge becomes the
    generalized per-root penalty of ``repro_torch.core.fd``, and the dropped
    coefficients are recovered in closed form — θ and ``names`` come back
    in the full layout, bit-for-bit the same convention as the unreduced
    path and equal to it to numerical precision."""
    categorical = list(cfg.categorical)
    missing = set(categorical) - set(features)
    if missing:
        raise ValueError(
            f"categorical attributes {sorted(missing)} not in features"
        )
    cont = [f for f in features if f not in categorical] + [label]

    red = store.fd_reduction(categorical) if cfg.use_fds else None
    if red is not None and red.is_trivial:
        red = None
    run_cat = list(red.kept) if red is not None else categorical

    t0 = time.perf_counter()
    if cfg.factorized:
        cof = cat_cofactors_factorized(
            store,
            vorder,
            cont,
            run_cat,
            backend=cfg.backend,
            use_node_kernels=cfg.use_node_kernels,
            device=cfg.device,
        )
    else:
        cof = cat_cofactors_materialized(
            store, cont, run_cat, use_kernel=cfg.use_kernel, device=cfg.device
        )
    mat, names = cof.regression_matrix(label)
    t1 = time.perf_counter()

    penalty = None
    layout = None
    if red is not None:
        # kept-block layout inside [intercept, cont\label, kept blocks,
        # label] — shared by the penalty assembly and the recovery below
        layout = []
        off = 1 + (len(cont) - 1)  # intercept + continuous (label removed)
        for c in cof.cat:
            layout.append((c, off, cof.domains[c]))
            off += cof.domains[c]
        # generalized ridge: the paper's flat 0.006·θ on everything except
        # the per-root blocks, which carry ridge·(I + Σ RᵀR)^{-1} so the
        # reduced optimum maps exactly onto the full one (repro_torch.core.fd).
        p = mat.shape[0]
        penalty = apply_penalty_blocks(
            cfg.ridge * np.eye(p - 1), red, layout, cfg.ridge
        )

    if cfg.solver == "closed_form":
        theta = solve_cofactor(mat, ridge=cfg.ridge, penalty=penalty)
        iters = 0
    else:
        bgd_pen = None
        if penalty is not None:
            bgd_pen = np.zeros((mat.shape[0], mat.shape[0]))
            bgd_pen[: -1, : -1] = penalty
        res: GDResult = bgd_cofactor(mat, cfg.gd(), penalty=bgd_pen)
        theta, iters = res.theta, res.iterations

    if red is not None:
        # closed-form recovery of the dropped blocks, then reassembly in
        # the FULL layout [intercept, cont\label, all cats in caller
        # order, label] — indistinguishable from the unreduced solve.
        full_domains = {c: store.attr_domain(c) for c in red.order}
        parts = [theta[: 1 + (len(cont) - 1)]]
        names = ["intercept"] + [f for f in cont if f != label]
        for c, blk in recover_theta_blocks(theta, red, layout, full_domains):
            parts.append(blk)
            names.extend(f"{c}={g}" for g in range(len(blk)))
        parts.append(theta[-1:])  # θ_label = −1
        names.append(label)
        theta = np.concatenate(parts)
    t2 = time.perf_counter()
    return RegressionResult(
        theta=theta,
        theta_conv=theta,  # unscaled path: converged θ IS the final θ
        factors=None,
        iterations=iters,
        seconds_scale=0.0,
        seconds_cofactor=t1 - t0,
        seconds_gd=t2 - t1,
        config=cfg,
        names=names,
    )
