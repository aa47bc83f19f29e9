"""End-to-end in-database linear regression (paper §4.5, Table 2).

``linear_regression`` mirrors the paper's ``linearRegression(...)``:
scale features → compute cofactors (factorized or materialized) → batch
gradient descent on the cofactor matrix → rescale θ.  The six benchmark
versions of Table 2 are provided as named configurations.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from .api import StoreReads
from .cofactor import cofactors_factorized, design_matrix
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
    device: str = "cuda"  # torch engine, moments kernel and BGD
    use_kernel: bool = False  # moments kernel for the scale factors
    categorical: Tuple[str, ...] = ()  # not part of this port yet
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
    factors: Optional[ScaleFactors]
    iterations: int
    seconds_scale: float
    seconds_cofactor: float
    seconds_gd: float
    config: RegressionConfig

    @property
    def seconds_total(self) -> float:
        return self.seconds_scale + self.seconds_cofactor + self.seconds_gd

    def evaluate(
        self, store: StoreReads, features: Sequence[str], label: str
    ) -> Dict[str, float]:
        """Average absolute / relative error over the joined data (paper §5)."""
        joined = store.materialize_join()
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
    where the torch engine, the moments kernel and BGD run."""
    cfg = config or VERSIONS["v1"]
    features = list(features)
    if cfg.factorized and vorder is None:
        raise ValueError("factorized mode requires a variable order")
    if cfg.categorical:
        raise NotImplementedError(
            "categorical features are not part of the PyTorch port yet"
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
