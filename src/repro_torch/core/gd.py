"""Batch gradient descent on a precomputed cofactor matrix (paper §3.4, §4.4).

The data-dependent part of the least-squares gradient factors as

    S_j = Σ_k θ_k · Cofactor[k, j]

so once the cofactor matrix is known every BGD step is a single [p, p] @ [p]
matvec — **independent of the number of training rows m**.  The procedure:

* θ has one entry per feature plus the intercept plus the label; the label's
  coefficient is *fixed to −1* (paper §3.2).
* update:  ε_j = α · (S_j + 0.006·θ_j)   (ridge term, paper §4.4)
* α starts at 0.003 and is divided by 3 whenever Σ_j |ε_j| grew relative to
  the previous iteration (paper version 1); stop when Σ_j |ε_j| < ε_threshold
  (1e-6; version 3 uses 1e-8), when α < 1e-15, or at the iteration cap.
* version 4's "alternative adjustment": on an increase the step is
  *reverted* before shrinking α, and α grows by 5% on successful steps.

The loop stays on the device.  It runs in chunks of predicated steps: each
step computes the stop condition first and, once it holds, leaves θ, α, the
previous update sum, the converged flag and the iteration count exactly as
they were — what the JAX package's ``lax.while_loop`` does by not running
the body — so the host reads one flag per chunk, not per step, and the
iteration count is exact.  ``bgd_data`` is the non-factorized ("noPre")
baseline: the same update, with S recomputed from the materialized data
every iteration.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

__all__ = ["GDConfig", "GDResult", "bgd_cofactor", "bgd_data", "solve_cofactor"]

#: predicated steps between host reads of the stop flag
_CHUNK = 128


@dataclasses.dataclass(frozen=True)
class GDConfig:
    alpha0: float = 0.003
    eps: float = 1e-6  # version 3 sets 1e-8
    ridge: float = 0.006  # the paper's fixed 0.006·θ_j ridge term
    max_iter: int = 200_000  # paper caps at 1e8; configurable
    alpha_min: float = 1e-15
    alpha_strategy: str = "paper"  # "paper" (v1) | "revert" (v4)
    alpha_grow: float = 1.05  # only used by the "revert" strategy
    dtype: torch.dtype = torch.float32
    device: str = "cuda"


@dataclasses.dataclass
class GDResult:
    theta: np.ndarray  # full vector [p]: [intercept, features..., label=-1]
    iterations: int
    alpha: float
    last_update: float

    def trainable(self) -> np.ndarray:
        return self.theta[:-1]


def _run_loop(step_fn: Callable, p: int, cfg: GDConfig):
    """Chunked, predicated descent.  Carry: (θ, α, prev_sum, it, converged)."""
    if cfg.alpha_strategy not in ("paper", "revert"):
        raise ValueError(f"unknown alpha_strategy {cfg.alpha_strategy}")
    like = dict(dtype=cfg.dtype, device=cfg.device)
    theta = torch.zeros((p,), **like)
    theta[-1] = -1.0
    alpha = torch.tensor(cfg.alpha0, **like)
    prev = torch.tensor(float("inf"), **like)
    it = torch.zeros((), dtype=torch.int32, device=cfg.device)
    converged = torch.zeros((), dtype=torch.bool, device=cfg.device)

    def running():
        return (~converged) & (it < cfg.max_iter) & (alpha > cfg.alpha_min)

    while bool(running()):  # one host sync per chunk
        for _ in range(_CHUNK):
            active = running()
            eps_vec = step_fn(theta, alpha)
            cur = torch.sum(torch.abs(eps_vec))
            increase = cur > prev
            if cfg.alpha_strategy == "paper":
                theta_new = theta - eps_vec
                alpha_new = torch.where(increase, alpha / 3.0, alpha)
                prev_new = cur
            else:
                theta_new = torch.where(increase, theta, theta - eps_vec)
                alpha_new = torch.where(
                    increase, alpha / 3.0, alpha * cfg.alpha_grow
                )
                prev_new = torch.where(increase, prev, cur)
            theta = torch.where(active, theta_new, theta)
            alpha = torch.where(active, alpha_new, alpha)
            prev = torch.where(active, prev_new, prev)
            converged = torch.where(active, cur < cfg.eps, converged)
            it = it + active.to(torch.int32)
    return theta, alpha, prev, it


def _result(theta, alpha, last, it) -> GDResult:
    return GDResult(
        theta=theta.cpu().numpy().astype(np.float64),
        iterations=int(it),
        alpha=float(alpha),
        last_update=float(last),
    )


def _trainable(p: int, cfg: GDConfig) -> torch.Tensor:
    t = torch.ones((p,), dtype=cfg.dtype, device=cfg.device)
    t[-1] = 0.0
    return t


def bgd_cofactor(
    cof_matrix: np.ndarray,
    cfg: Optional[GDConfig] = None,
    penalty: Optional[np.ndarray] = None,
) -> GDResult:
    """BGD on a cofactor matrix ordered [intercept, features..., label].

    ``penalty``, when given, is a full [p, p] penalty matrix replacing the
    scalar ``cfg.ridge * θ`` term with ``penalty @ θ``.  Its label
    row/column must be zero (θ_label is pinned to −1)."""
    cfg = cfg or GDConfig()
    cof = torch.as_tensor(
        np.asarray(cof_matrix), dtype=cfg.dtype, device=cfg.device
    )
    p = cof.shape[0]
    trainable = _trainable(p, cfg)
    if penalty is None:

        def step(theta, alpha):
            s = cof @ theta  # the whole data scan, collapsed to one matvec
            return alpha * (s + cfg.ridge * theta) * trainable

    else:
        pen = torch.as_tensor(
            np.asarray(penalty), dtype=cfg.dtype, device=cfg.device
        )

        def step(theta, alpha):
            s = cof @ theta
            return alpha * (s + pen @ theta) * trainable

    return _result(*_run_loop(step, p, cfg))


def bgd_data(z: np.ndarray, cfg: Optional[GDConfig] = None) -> GDResult:
    """Non-factorized BGD over the materialized design matrix
    z = [1, x_1..x_n, y] per row — the paper's ``noPre`` baseline."""
    cfg = cfg or GDConfig()
    zt = torch.as_tensor(np.asarray(z), dtype=cfg.dtype, device=cfg.device)
    p = zt.shape[1]
    trainable = _trainable(p, cfg)

    def step(theta, alpha):
        s = zt.T @ (zt @ theta)  # full data scan, every iteration (noPre)
        return alpha * (s + cfg.ridge * theta) * trainable

    return _result(*_run_loop(step, p, cfg))


def solve_cofactor(
    cof_matrix: np.ndarray,
    ridge: float = 0.0,
    penalty: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Closed-form ridge solve of the normal equations, in float64 on the
    host.

    With ordering [intercept, features..., label] and θ_label = −1, the
    stationarity condition  C_tt·θ_t + ridge·θ_t = C_t,label  is a (p−1)
    linear system.  Returns the full θ vector.  ``penalty`` replaces
    ``ridge·I`` with an arbitrary [p−1, p−1] penalty matrix.
    """
    cof = np.asarray(cof_matrix, dtype=np.float64)
    p = cof.shape[0]
    pen = penalty if penalty is not None else ridge * np.eye(p - 1)
    ctt = cof[: p - 1, : p - 1] + pen
    rhs = cof[: p - 1, p - 1]
    theta_t = np.linalg.solve(ctt, rhs)
    return np.concatenate([theta_t, [-1.0]])
