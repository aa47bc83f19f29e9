"""Cofactor matrices: factorized vs. materialized ("noPre") paths (paper §3.4).

Three engines, mirroring the paper's evaluation matrix:

* ``cofactors_factorized`` (re-exported)  — one pass over the factorized join
  (the paper's ``fact`` versions), O(factorization size).
* ``cofactors_materialized``              — flat join then Gram matrix
  X^T X (the ``noPre`` baseline), O(|D|^rho*); through the hand-written
  ``gram`` kernel when ``use_kernel=True``.
* ``cofactors_row_engine``                — row-at-a-time interpreted loop,
  the *disk-row-engine proxy* standing in for PostgreSQL in the
  engine-comparison benchmark (Fig. 9 analogue).  Never used for training.

Streaming / incremental paths (union commutativity, Prop. 4.1):

* ``cofactors_streaming``  — accumulates X^T X chunk-by-chunk through the
  ``gram`` kernel and folds the per-chunk ``Cofactors`` with ``__add__``,
  so arbitrarily large design matrices never sit on the device at once.
  ``cofactors_materialized(..., chunk_rows=N)`` routes the noPre path
  through it.
* ``cofactors_grouped``    — per-group cofactors of a partition labeling in
  ONE fused pass via the ``segment_gram`` kernel (u = [1, x] makes u·u^T
  carry count/lin/quad together); the groups sum back to the global
  cofactors with ``__add__``.

The Gram paths run on ``device`` (``"cuda"`` unless the caller asks for
the CPU, where the kernels' plain PyTorch versions run): the design matrix
moves there as float32, and the ``[K, K]`` results come back as float64
host arrays, as the JAX package's do.
"""

from __future__ import annotations

from typing import Iterable, Iterator, List, Optional, Sequence, Union

import numpy as np
import torch

from ..kernels import ops as kernel_ops
from .api import StoreReads
from .factorize import Cofactors, cofactors_factorized
from .relation import Relation

__all__ = [
    "Cofactors",
    "cofactors_factorized",
    "cofactors_from_matrix",
    "cofactors_grouped",
    "cofactors_materialized",
    "cofactors_row_engine",
    "cofactors_streaming",
    "design_matrix",
    "iter_design_chunks",
]


def _device(device) -> torch.device:
    """``device`` as a torch device; the CUDA default raises without a GPU
    (there is no fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the Gram paths run on device='cuda' by default and no CUDA "
            "device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def _host64(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().astype(np.float64)


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


def cofactors_from_matrix(
    x: np.ndarray,
    features: Sequence[str],
    use_kernel: bool = False,
    device="cuda",
) -> Cofactors:
    """Gram-matrix cofactors of an already-materialized design matrix, in
    float32 on ``device``: through the ``gram`` kernel with ``use_kernel``,
    else as one plain ``x.T @ x`` (the product the JAX package leaves to
    XLA)."""
    m = x.shape[0]
    xt = torch.as_tensor(np.asarray(x), dtype=torch.float32, device=_device(device))
    quad = kernel_ops.gram(xt) if use_kernel else xt.T @ xt
    return Cofactors(
        count=float(m),
        lin=_host64(xt.sum(dim=0)),
        quad=_host64(quad),
        features=list(features),
    )


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


def cofactors_streaming(
    chunks: Union[np.ndarray, Iterable[np.ndarray]],
    features: Sequence[str],
    chunk_rows: Optional[int] = None,
    use_kernel: bool = True,
    device="cuda",
) -> Cofactors:
    """Fold an arbitrarily long stream of design-matrix row chunks into one
    ``Cofactors`` — each chunk's Gram runs through the ``gram`` kernel
    (``use_kernel=False``: a plain product) and the per-chunk aggregates sum
    via ``Cofactors.__add__``.  Peak device memory is one chunk plus the
    k×k accumulator, independent of the total row count.

    ``chunks`` is either an iterable of [m_i, k] arrays or a single [m, k]
    matrix together with ``chunk_rows`` (split on the host, streamed to the
    device chunk-by-chunk).
    """
    features = list(features)
    if isinstance(chunks, np.ndarray):
        if chunk_rows is None:
            raise ValueError("chunk_rows required when passing one matrix")
        if chunk_rows <= 0:
            raise ValueError(f"chunk_rows must be positive, got {chunk_rows}")
        m = chunks.shape[0]
        x = chunks
        chunks = (
            x[lo : min(lo + chunk_rows, m)] for lo in range(0, m, chunk_rows)
        )
    k = len(features)
    total = Cofactors(
        count=0.0,
        lin=np.zeros((k,), dtype=np.float64),
        quad=np.zeros((k, k), dtype=np.float64),
        features=features,
    )
    for chunk in chunks:
        if chunk.shape[1] != k:
            raise ValueError(
                f"chunk has {chunk.shape[1]} columns, expected {k} features"
            )
        if chunk.shape[0] == 0:
            continue
        total = total + cofactors_from_matrix(
            chunk, features, use_kernel=use_kernel, device=device
        )
    return total


def cofactors_grouped(
    x: np.ndarray,
    seg: np.ndarray,
    num_groups: int,
    features: Sequence[str],
    use_kernel: bool = True,
    device="cuda",
) -> List[Cofactors]:
    """Per-group cofactors of a partition labeling in one fused pass.

    Appends the intercept column (u = [1, x]) and runs the ``segment_gram``
    kernel on ``device``, whose [G, k+1, k+1] output carries every group's
    count / lin / quad at once.  Summing the returned list with
    ``Cofactors.__add__`` reproduces the global cofactors.  Out-of-range
    segment ids contribute to no group on both paths (``use_kernel=False``
    is the float64 host oracle).
    """
    m, k = x.shape
    u = np.concatenate([np.ones((m, 1), dtype=np.float64), x], axis=1)
    if use_kernel:
        dev = _device(device)
        blocks = _host64(
            kernel_ops.segment_gram(
                torch.as_tensor(u, dtype=torch.float32, device=dev),
                torch.as_tensor(np.asarray(seg), device=dev),
                num_groups,
            )
        )
    else:
        seg = np.asarray(seg)
        keep = (seg >= 0) & (seg < num_groups)
        blocks = np.zeros((num_groups, k + 1, k + 1), dtype=np.float64)
        uk = u[keep]
        np.add.at(blocks, seg[keep], uk[:, :, None] * uk[:, None, :])
    return [
        Cofactors(
            count=float(b[0, 0]),
            lin=b[0, 1:].copy(),
            quad=b[1:, 1:].copy(),
            features=list(features),
        )
        for b in blocks
    ]


def cofactors_materialized(
    store: StoreReads,
    features: Sequence[str],
    relations: Optional[Sequence[str]] = None,
    use_kernel: bool = False,
    scale=None,
    chunk_rows: Optional[int] = None,
    device="cuda",
) -> Cofactors:
    """The non-factorized ("noPre") path: flat join, then X^T X on
    ``device``.  With ``chunk_rows`` the Gram accumulates through
    ``cofactors_streaming`` so only one chunk of the design matrix is
    resident at a time."""
    joined = store.materialize_join(relations)
    if chunk_rows is not None:
        return cofactors_streaming(
            iter_design_chunks(joined, features, chunk_rows, scale=scale),
            features,
            use_kernel=use_kernel,
            device=device,
        )
    x = design_matrix(joined, features, scale=scale)
    return cofactors_from_matrix(x, features, use_kernel=use_kernel, device=device)


def cofactors_row_engine(
    store: StoreReads,
    features: Sequence[str],
    relations: Optional[Sequence[str]] = None,
    scale=None,
) -> Cofactors:
    """Row-at-a-time interpreted engine (disk-row-engine proxy for Fig. 9).

    Deliberately tuple-oriented: iterates Python-level rows and accumulates
    scalar products, the way a Volcano-style executor touches data.  Runs on
    the host in float64; it has no device.
    """
    joined = store.materialize_join(relations)
    x = design_matrix(joined, features, scale=scale)
    k = len(features)
    quad = [[0.0] * k for _ in range(k)]
    lin = [0.0] * k
    m = 0
    for row in x:  # noqa: B007 — intentionally interpreted
        m += 1
        for i in range(k):
            xi = float(row[i])
            lin[i] += xi
            for j in range(i, k):
                quad[i][j] += xi * float(row[j])
    quad_np = np.asarray(quad)
    quad_np = quad_np + np.triu(quad_np, 1).T  # symmetry (paper: half computed)
    return Cofactors(
        count=float(m),
        lin=np.asarray(lin),
        quad=quad_np,
        features=list(features),
    )
