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
* ``glm``                       — logistic/Poisson over the compressed join
                                  (host float64 IRLS, float32 GD on the device)
* ``polynomial``                — beyond-paper degree-d extension (§6 outlook),
                                  float64 aggregates on the device
* ``view_cache``                — persistent cross-batch per-node view cache
                                  (store-owned, delta-maintained under append)
* ``delta_log``                 — pending-append log behind lazy maintenance
                                  (O(delta) writes, read-time draining)
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
from .delta_log import DeltaLog, RelationLog
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
from .glm import (
    CompressedDesign,
    GLMConfig,
    GLMResult,
    compressed_design_factorized,
    compressed_design_materialized,
    fit_glm,
    fit_glm_onehot,
    glm_regression,
)
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
from .view_cache import ViewCache, ViewKey

__all__ = [
    "AggregateBlock",
    "AggregateQuery",
    "CatCofactors",
    "Cofactors",
    "CompressedDesign",
    "DeltaLog",
    "Dictionary",
    "FDReduction",
    "FactorizedEngine",
    "FunctionalDependency",
    "GDConfig",
    "GDResult",
    "GLMConfig",
    "GLMResult",
    "GroupedView",
    "INTERCEPT",
    "Relation",
    "RelationLog",
    "RegressionConfig",
    "RegressionResult",
    "ScaleFactors",
    "SparseCounts",
    "Store",
    "StoreReads",
    "StoreSnapshot",
    "VariableOrder",
    "VERSIONS",
    "ViewCache",
    "ViewKey",
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
    "compressed_design_factorized",
    "compressed_design_materialized",
    "compute_scale_factors",
    "design_matrix",
    "expand_cat_cofactors",
    "fit_glm",
    "fit_glm_onehot",
    "glm_regression",
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
