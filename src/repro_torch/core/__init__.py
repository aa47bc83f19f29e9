"""Core factorized-learning engine, in PyTorch.

Layering (paper section in parentheses):

* ``relation`` / ``store``      — columnar in-memory database (§4, HyPer role)
* ``variable_order``            — extended variable orders (§2.2, §4.1)
* ``factorize``                 — degree-≤2 aggregate pushdown (§2.3, §4.3)
* ``cofactor``                  — design matrices of the materialized path
* ``gd``                        — BGD on cofactor matrices (§4.4)
* ``scaling``                   — feature scaling + θ rescale (§3.3, §4.2)
* ``regression``                — the full pipeline + Table-2 versions (§4.5)
* ``api``                       — the ``StoreReads`` Protocol
"""

from .api import StoreReads
from .cofactor import (
    Cofactors,
    cofactors_factorized,
    design_matrix,
    iter_design_chunks,
)
from .factorize import (
    AggregateBlock,
    AggregateQuery,
    FactorizedEngine,
    GroupedView,
    grouped_cofactors_factorized,
)
from .gd import GDConfig, GDResult, bgd_cofactor, bgd_data, solve_cofactor
from .regression import (
    VERSIONS,
    RegressionConfig,
    RegressionResult,
    linear_regression,
)
from .relation import Dictionary, Relation
from .scaling import (
    ScaleFactors,
    compute_scale_factors,
    predict,
    rescale_theta,
)
from .store import Store, StoreSnapshot
from .variable_order import (
    INTERCEPT,
    VariableOrder,
    validate,
    variable_order_from_store,
)

__all__ = [
    "AggregateBlock",
    "AggregateQuery",
    "Cofactors",
    "Dictionary",
    "FactorizedEngine",
    "GDConfig",
    "GDResult",
    "GroupedView",
    "INTERCEPT",
    "Relation",
    "RegressionConfig",
    "RegressionResult",
    "ScaleFactors",
    "Store",
    "StoreReads",
    "StoreSnapshot",
    "VariableOrder",
    "VERSIONS",
    "bgd_cofactor",
    "bgd_data",
    "cofactors_factorized",
    "compute_scale_factors",
    "design_matrix",
    "grouped_cofactors_factorized",
    "iter_design_chunks",
    "linear_regression",
    "predict",
    "rescale_theta",
    "solve_cofactor",
    "validate",
    "variable_order_from_store",
]
