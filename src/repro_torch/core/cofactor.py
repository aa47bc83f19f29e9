"""Design matrices of the materialized ("noPre") path (paper §3.4).

``design_matrix`` extracts the [m, k] feature matrix of a flat join, with
lazy rescaling; ``iter_design_chunks`` streams it in row slices.  The
factorized path lives in ``factorize`` (re-exported here).  The JAX
package's Gram-kernel cofactor baselines (``cofactors_materialized``,
``cofactors_streaming``, ``cofactors_grouped``, ``cofactors_row_engine``)
are not part of this port yet.
"""

from __future__ import annotations

from typing import Iterator, Sequence

import numpy as np

from .factorize import Cofactors, cofactors_factorized
from .relation import Relation

__all__ = [
    "Cofactors",
    "cofactors_factorized",
    "design_matrix",
    "iter_design_chunks",
]


def design_matrix(
    joined: Relation, features: Sequence[str], scale=None
) -> np.ndarray:
    """Extract the [m, k] feature matrix from a materialized join, applying
    lazy view rescaling (paper §4.2) when ``scale`` is given — the one-chunk
    case of ``iter_design_chunks``."""
    m = joined.num_rows
    if m == 0:
        return np.zeros((0, len(features)))
    return next(iter_design_chunks(joined, features, m, scale=scale))


def iter_design_chunks(
    joined: Relation,
    features: Sequence[str],
    chunk_rows: int,
    scale=None,
) -> Iterator[np.ndarray]:
    """Yield the design matrix of ``joined`` in [≤chunk_rows, k] slices
    without ever stacking the full [m, k] matrix."""
    if chunk_rows <= 0:
        raise ValueError(f"chunk_rows must be positive, got {chunk_rows}")
    m = joined.num_rows
    cols = [joined.column(f) for f in features]
    for lo in range(0, m, chunk_rows):
        hi = min(lo + chunk_rows, m)
        chunk = []
        for f, c in zip(features, cols):
            part = c[lo:hi].astype(np.float64)
            if scale is not None:
                part = scale.transform(f, part)
            chunk.append(part)
        if chunk:
            yield np.stack(chunk, axis=1)
        else:
            yield np.zeros((hi - lo, 0))
