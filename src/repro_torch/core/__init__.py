"""Core factorized-learning engine, in PyTorch.

Layering (paper section in parentheses):

* ``relation`` / ``store``      — columnar in-memory database (§4, HyPer role)
* ``variable_order``            — extended variable orders (§2.2, §4.1)
* ``factorize``                 — degree-≤2 aggregate pushdown (§2.3, §4.3)
* ``cofactor``                  — factorized vs materialized cofactors (§3.4)
* ``gd``                        — BGD on cofactor matrices (§4.4)
* ``scaling``                   — feature scaling + θ rescale (§3.3, §4.2)
* ``regression``                — the full pipeline + Table-2 versions (§4.5)
* ``fd``                        — functional dependencies: catalog,
                                  FD-reduced solving, closed-form recovery
* ``categorical``               — sparse categorical cofactors (AC/DC-style)
* ``api``                       — the ``StoreReads`` Protocol
"""

from .api import StoreReads
from .categorical import (
    CatCofactors,
    SparseCounts,
    cat_cofactors_factorized,
    cat_cofactors_from_arrays,
    cat_cofactors_materialized,
    cat_cofactors_per_pass,
    onehot_design_matrix,
)
from .cofactor import (
    Cofactors,
    cofactors_factorized,
    cofactors_from_matrix,
    cofactors_grouped,
    cofactors_materialized,
    cofactors_row_engine,
    cofactors_streaming,
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
from .fd import (
    FDReduction,
    FunctionalDependency,
    expand_cat_cofactors,
    penalty_blocks,
    recover_blocks,
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
    "CatCofactors",
    "Cofactors",
    "Dictionary",
    "FDReduction",
    "FactorizedEngine",
    "FunctionalDependency",
    "GDConfig",
    "GDResult",
    "GroupedView",
    "INTERCEPT",
    "Relation",
    "RegressionConfig",
    "RegressionResult",
    "ScaleFactors",
    "SparseCounts",
    "Store",
    "StoreReads",
    "StoreSnapshot",
    "VariableOrder",
    "VERSIONS",
    "bgd_cofactor",
    "bgd_data",
    "cat_cofactors_factorized",
    "cat_cofactors_from_arrays",
    "cat_cofactors_materialized",
    "cat_cofactors_per_pass",
    "cofactors_factorized",
    "cofactors_from_matrix",
    "cofactors_grouped",
    "cofactors_materialized",
    "cofactors_row_engine",
    "cofactors_streaming",
    "compute_scale_factors",
    "design_matrix",
    "expand_cat_cofactors",
    "grouped_cofactors_factorized",
    "iter_design_chunks",
    "linear_regression",
    "onehot_design_matrix",
    "penalty_blocks",
    "predict",
    "recover_blocks",
    "rescale_theta",
    "solve_cofactor",
    "validate",
    "variable_order_from_store",
]
