"""Feature scaling on a variable order (paper §3.3, §4.2) and θ rescaling.

``compute_scale_factors`` mirrors the paper's ``scaleFeatures(...)``:

* For every feature column, the average and max-absolute value are computed
  over the **union of all relations containing that column** (not over the
  join!) so every occurrence is scaled by the same factors and equi-joins
  survive rescaling.
* Rescaling is **lazy**: base columns are never rewritten — consumers apply
  ``ScaleFactors.transform`` at value-access time (the factorized engine at
  feature extension, the materialized path at design-matrix extraction).
* Each union reduction is one pass: the store's float64 moments by default,
  or the fused ``moments`` CUDA kernel with ``use_kernel``.

Label convention: the label is **mean-centered but not max-scaled**, which
makes the paper's version-1 rescaling agree with the exact closed-form
inversion of §3.3 and makes versions 5/6 produce the "huge error" the paper
reports.

θ ordering everywhere: [intercept, features..., label].
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..kernels import ops as kops
from .api import StoreReads

__all__ = ["ScaleFactors", "compute_scale_factors", "rescale_theta", "predict"]


@dataclasses.dataclass
class ScaleFactors:
    """Per-column (avg, max|·|) — the paper's ``scaleFactors`` struct."""

    avg: Dict[str, float]
    max: Dict[str, float]
    features: List[str]
    label: str

    def __contains__(self, attr: str) -> bool:
        return attr in self.avg

    def transform(self, attr: str, x: np.ndarray):
        """Apply (x − avg)/max — the paper's x_conv (lazy view semantics)."""
        if attr not in self.avg:
            return x
        return (x - self.avg[attr]) / self.max[attr]


def _union_moments(
    store: StoreReads, col: str, use_kernel: bool = False, device="cuda"
):
    """avg and max|x| of ``col`` over the union of relations containing it.

    Key attributes participate through their dense numeric encoding.  The
    default path reads the store's float64 moments; ``use_kernel`` runs a
    fresh float32 pass of the ``moments`` kernel over the column on
    ``device`` (the plain PyTorch version when ``device`` is the CPU)."""
    if not use_kernel:
        s, mx, cnt = store.column_moments(col)
        return s / cnt, mx
    chunks = [
        rel.column(col).astype(np.float64)
        for rel in store.relations()
        if col in rel.values or col in rel.keys
    ]
    if not chunks:
        raise ValueError(f"column {col} not found in any relation")
    allv = np.concatenate(chunks)
    x = torch.as_tensor(allv, dtype=torch.float32, device=device)
    s, mx, cnt = kops.moments(x)
    return float(s) / float(cnt), float(mx)


def compute_scale_factors(
    store: StoreReads,
    features: Sequence[str],
    label: str,
    use_kernel: bool = False,
    device="cuda",
) -> ScaleFactors:
    """Compute per-feature scale factors (paper §4.2).  One union-reduction
    per column; the intercept is never rescaled; the label is centered
    only.  ``device`` is where the ``use_kernel`` pass runs."""
    avg: Dict[str, float] = {}
    mx: Dict[str, float] = {}
    for col in list(features) + [label]:
        a, m = _union_moments(store, col, use_kernel=use_kernel, device=device)
        avg[col] = a
        mx[col] = m if (m > 0 and col != label) else 1.0
    return ScaleFactors(avg=avg, max=mx, features=list(features), label=label)


def rescale_theta(
    theta_conv: np.ndarray, factors: ScaleFactors, mode: str = "exact"
) -> np.ndarray:
    """Invert feature scaling on converged θ (paper §3.3 / §4.5).

    Modes:
      * ``exact``       — closed-form inversion of §3.3:
                          θ_j = θ_j,conv / max_j;
                          θ₀ = avg_y + θ₀,conv − Σ θ_j·avg_j.
      * ``avg_label``   — paper versions 1–4: θ₀ = avg_y − Σ θ_j·avg_j.
      * ``theta0_conv`` — paper versions 5/6: θ₀ = θ₀,conv − Σ θ_j·avg_j.
    """
    theta_conv = np.asarray(theta_conv, dtype=np.float64)
    feats = factors.features
    theta = theta_conv.copy()
    for j, f in enumerate(feats):
        theta[1 + j] = theta_conv[1 + j] / factors.max[f]
    correction = sum(
        theta[1 + j] * factors.avg[f] for j, f in enumerate(feats)
    )
    avg_y = factors.avg[factors.label]
    if mode == "exact":
        theta[0] = avg_y + theta_conv[0] - correction
    elif mode == "avg_label":
        theta[0] = avg_y - correction
    elif mode == "theta0_conv":
        theta[0] = theta_conv[0] - correction
    else:
        raise ValueError(f"unknown rescale mode {mode}")
    return theta


def predict(x: np.ndarray, theta: np.ndarray) -> np.ndarray:
    """h_θ(x) for a [m, n] feature matrix and θ = [intercept, feats..., label]."""
    n = x.shape[1]
    return theta[0] + x @ theta[1 : 1 + n]
