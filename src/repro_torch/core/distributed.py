"""Distributed cofactor computation — the paper's algebra as the mesh plan.

Proposition 4.1's *commutativity with union* — partition the data, compute
per-partition cofactors, sum — **is** data parallelism.  This module maps it
onto a ``torch.distributed`` device mesh (PyTorch port of the JAX package's
``core/distributed.py``, which uses ``shard_map`` and ``psum``):

* each shard over the mesh's data dims holds a horizontal partition of the
  (largest) fact relation plus replicas of the small dimension relations —
  the layout a distributed in-memory DBMS would choose;
* every shard runs the same Gram/cofactor computation on its rows, through
  the hand-written kernels (``kernels.ops.gram``, kernel 5, and
  ``kernels.ops.multi_segment_gram``, kernel 7, on a CUDA mesh);
* one ``all_reduce(SUM)`` over each named data dim's process group produces
  the global cofactor matrix.  The matrix is tiny (p×p, p = #feats + 2), so
  the collective is latency- not bandwidth-bound.

``mesh`` is a :class:`torch.distributed.device_mesh.DeviceMesh` with
``mesh_dim_names``; ``data_axes`` names its dims.  The caller brings up the
process group (NCCL for a ``cuda`` mesh, gloo for a ``cpu`` one) and every
rank calls the same function with the same host arrays.  Rows are split as
``P(data_axes, None)`` splits them: zero-padded to a multiple of the shard
count, the r-th contiguous block to shard r, shards numbered row-major over
``data_axes`` in the order given; ranks that differ only along other dims
hold the same shard, and the sums run over ``data_axes`` alone.  Tensors on
a CUDA mesh stay on the card: the local sums and the all-reduces run there
(a group whose backend is not NCCL raises), and only the p×p results come
back to the host, in float64.

``sharded_gram`` is the building block; ``sharded_cofactors`` applies it to
a partitioned design matrix.  ``partitioned_cofactors_host`` demonstrates
the same algebra without a mesh (host-side partition + sum, float64) and is
used by tests as the oracle.

Incremental maintenance composes with the same algebra: an *append* of new
rows Δ is a union, so ``incremental_sharded_cofactors`` computes the delta
cofactors of Δ per shard (one all-reduce) and folds them into the previous
global cofactors with ``Cofactors.__add__`` — no rescan of the historical
data.  The sharded paths consume already-extracted arrays, so they are
agnostic to the store's view cache.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..kernels import ops as kernel_ops
from .categorical import CatCofactors, SparseCounts, cat_cofactors_from_arrays
from .factorize import Cofactors

__all__ = [
    "sharded_gram",
    "sharded_cofactors",
    "sharded_cat_cofactors",
    "partitioned_cofactors_host",
    "incremental_sharded_cofactors",
    "incremental_sharded_cat_cofactors",
]


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _groups(mesh, data_axes: Sequence[str], device: torch.device) -> List:
    """The process group of each named data dim; a CUDA mesh needs NCCL."""
    groups = [mesh.get_group(mesh_dim=a) for a in data_axes]
    if device.type == "cuda":
        for a, g in zip(data_axes, groups):
            backend = str(dist.get_backend(g))
            if "nccl" not in backend:
                raise ValueError(
                    f"mesh dim {a!r} reduces CUDA tensors over a {backend!r} "
                    "group; a CUDA mesh needs the NCCL backend"
                )
    return groups


def _shard(mesh, data_axes: Sequence[str]) -> Tuple[int, int]:
    """(this rank's shard, the shard count): row-major over ``data_axes``."""
    names = list(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    index, count = 0, 1
    for a in data_axes:
        size = mesh.size(names.index(a))
        index = index * size + coord[names.index(a)]
        count *= size
    return index, count


def _psum(t: torch.Tensor, groups) -> torch.Tensor:
    """Sum ``t`` in place over every group in turn (the sum over the data
    dims, as one ``psum`` over them)."""
    for g in groups:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=g)
    return t


def _local_rows(m: int, mesh, data_axes) -> Tuple[int, int, int]:
    """(first row, end row, padded rows) of this rank's block: ``m`` rows
    zero-padded to a multiple of the shard count, split in equal blocks."""
    index, count = _shard(mesh, data_axes)
    per = -(-m // count)
    lo = min(index * per, m)
    return lo, min(lo + per, m), per


def _design_block(x: np.ndarray, lo: int, hi: int, per: int) -> np.ndarray:
    """``[per, 1 + k]`` float32: the true-row indicator (the intercept
    column: zero on padded rows, which would corrupt the count otherwise)
    and rows ``lo:hi`` of ``x``, zero-padded."""
    u = np.zeros((per, 1 + x.shape[1]), dtype=np.float32)
    u[: hi - lo, 0] = 1.0
    u[: hi - lo, 1:] = x[lo:hi]
    return u


def sharded_gram(z: torch.Tensor, mesh, data_axes: Sequence[str]) -> torch.Tensor:
    """Global Gram ZᵀZ with rows sharded over ``data_axes`` of ``mesh``:
    ``z`` is this rank's block of rows (on the mesh's device); returns the
    ``[K, K]`` sum over the shards, the same on every rank.

    The per-shard Gram (kernel 5 on a CUDA tensor) is followed by one
    all-reduce a data dim — the paper's union-commutativity, executed as a
    collective."""
    axes = tuple(data_axes)
    groups = _groups(mesh, axes, z.device)
    return _psum(kernel_ops.gram(z), groups)


def sharded_cofactors(
    z: np.ndarray,
    features: Sequence[str],
    mesh,
    data_axes: Sequence[str] = ("data",),
) -> Cofactors:
    """Cofactors of a design matrix ``z`` (WITHOUT intercept column) sharded
    over the mesh's data dims.  Pads rows with zeros to a shard multiple —
    zero rows contribute nothing to any cofactor (union with empty data)."""
    axes = tuple(data_axes)
    device = _mesh_device(mesh)
    m = z.shape[0]
    lo, hi, per = _local_rows(m, mesh, axes)
    zz = torch.from_numpy(_design_block(z, lo, hi, per)).to(device)
    gram = sharded_gram(zz, mesh, axes).cpu().numpy().astype(np.float64)
    return Cofactors(
        count=float(gram[0, 0]),
        lin=gram[0, 1:],
        quad=gram[1:, 1:],
        features=list(features),
    )


def incremental_sharded_cofactors(
    base: Cofactors,
    z_delta: np.ndarray,
    mesh=None,
    data_axes: Sequence[str] = ("data",),
) -> Cofactors:
    """Fold an appended row batch into existing global cofactors.

    ``base`` holds the cofactors of all rows seen so far; ``z_delta`` is the
    design matrix (WITHOUT intercept column) of the newly appended rows only.
    The delta cofactors are computed over the mesh when one is given (each
    shard sees a horizontal slice of Δ, one all-reduce sums them) and on
    the host otherwise; union commutativity makes ``base + delta`` exact.

    Precision: the mesh path accumulates each delta in fp32 on the device
    (~1e-7 relative per delta), so its rounding flows into the long-lived
    base — the host path (``mesh=None``) is fp64 and matches the fp64
    maintenance policy of ``Store.append``.  Prefer the host path for
    accumulators that must survive many appends; use the mesh path when
    delta volume, not accumulation lifetime, is the bottleneck.
    """
    if z_delta.shape[0] == 0:
        return base
    if mesh is None:
        delta = partitioned_cofactors_host(z_delta, base.features, 1)
    else:
        delta = sharded_cofactors(z_delta, base.features, mesh, data_axes)
    return base + delta


def sharded_cat_cofactors(
    x_cont: np.ndarray,
    cat_ids: np.ndarray,
    cont: Sequence[str],
    cat: Sequence[str],
    domains: dict,
    mesh,
    data_axes: Sequence[str] = ("data",),
    fd=None,  # Optional[repro_torch.core.fd.FDReduction]
) -> CatCofactors:
    """Categorical cofactors with rows sharded over the mesh's data dims.

    ``fd`` (an ``FDReduction`` over ``cat``) drops functionally-determined
    attributes first: the blocks and the all-reduces then cover only the
    kept attributes — expand with ``repro_torch.core.fd.expand_cat_cofactors``
    when the full blocks are needed.

    Same union-commutativity as ``sharded_cofactors``, extended to the
    grouped blocks, and never a one-hot column: every shard takes u = [1 |
    x] over its rows (the 1 the true-row indicator) and computes uᵀu with
    kernel 5, every attribute's per-category row of blocks [Σ 1, Σ x] as
    row 0 of its grouped Grams of u with kernel 7 (one read of u for all
    attributes), and each pair's dense [D_c, D_d] co-occurrence counts by a
    scatter of the indicator.  Three all-reduces (Gram, the per-category
    rows, the pair counts) reduce the shards, independent of |cat|.  Padded
    rows carry id −1 and a zero u, so they add nothing to any block, and
    zero weight to the pair counts.
    """
    cont, cat = list(cont), list(cat)
    if fd is not None and fd.dropped:
        kept_idx = [cat.index(c) for c in fd.kept]
        return sharded_cat_cofactors(
            x_cont,
            cat_ids[:, kept_idx],
            cont,
            list(fd.kept),
            {c: domains[c] for c in fd.kept},
            mesh,
            data_axes,
        )
    axes = tuple(data_axes)
    device = _mesh_device(mesh)
    groups = _groups(mesh, axes, device)
    m = x_cont.shape[0]
    for i, c in enumerate(cat):
        if len(cat_ids) == 0:
            continue
        lo, hi = int(cat_ids[:, i].min()), int(cat_ids[:, i].max())
        if lo < 0 or hi >= int(domains[c]):
            raise ValueError(
                f"category ids of {c!r} span [{lo}, {hi}], outside domain "
                f"[0, {int(domains[c])}) — out-of-range one-hot rows are "
                "all zeros and would be silently dropped (negative ids are "
                "reserved for internal shard padding)"
            )
    lo, hi, per = _local_rows(m, mesh, axes)
    ids = np.full((per, len(cat)), -1, dtype=np.int32)
    ids[: hi - lo] = cat_ids[lo:hi]
    u = torch.from_numpy(_design_block(x_cont, lo, hi, per)).to(device)
    ids = torch.from_numpy(ids).to(device)
    doms = [int(domains[c]) for c in cat]
    offs = np.concatenate([[0], np.cumsum(doms)]).astype(int)

    gram = kernel_ops.gram(u)
    blocks = kernel_ops.multi_segment_gram(u, ids, doms)
    hu = torch.cat([b[:, 0, :] for b in blocks])
    ind = u[:, 0]
    pairs = []
    for i in range(len(cat)):
        for j in range(i + 1, len(cat)):
            key = ids[:, i].clamp(min=0).long() * doms[j] + ids[:, j].clamp(min=0).long()
            pairs.append(ind.new_zeros(doms[i] * doms[j]).index_add_(0, key, ind))
    hh = torch.cat(pairs) if pairs else ind.new_zeros(0)
    for t in (gram, hu, hh):
        _psum(t, groups)

    gram = gram.cpu().numpy().astype(np.float64)
    hu = hu.cpu().numpy().astype(np.float64)
    hh = hh.cpu().numpy().astype(np.float64)
    cat_count = {c: hu[offs[i] : offs[i + 1], 0] for i, c in enumerate(cat)}
    cat_cont = {c: hu[offs[i] : offs[i + 1], 1:] for i, c in enumerate(cat)}
    cat_cat = {}
    start = 0
    for i in range(len(cat)):
        for j in range(i + 1, len(cat)):
            size = doms[i] * doms[j]
            cat_cat[(cat[i], cat[j])] = SparseCounts.from_dense(
                hh[start : start + size].reshape(doms[i], doms[j])
            )
            start += size
    return CatCofactors(
        count=float(gram[0, 0]),
        lin=gram[0, 1:],
        quad=gram[1:, 1:],
        cont=cont,
        cat=cat,
        domains={c: int(domains[c]) for c in cat},
        cat_count=cat_count,
        cat_cont=cat_cont,
        cat_cat=cat_cat,
    )


def incremental_sharded_cat_cofactors(
    base: CatCofactors,
    x_delta: np.ndarray,
    ids_delta: np.ndarray,
    mesh=None,
    data_axes: Sequence[str] = ("data",),
) -> CatCofactors:
    """Fold appended rows into existing categorical cofactors — the
    categorical twin of ``incremental_sharded_cofactors`` (same precision
    trade-off: mesh path accumulates fp32, host path fp64).  Unseen
    category ids in the delta grow the domains: the delta blocks are built
    at the grown size and ``__add__`` zero-pads ``base`` up to match."""
    if x_delta.shape[0] == 0:
        return base
    domains = {
        c: max(base.domains[c], int(ids_delta[:, i].max()) + 1)
        for i, c in enumerate(base.cat)
    }
    if mesh is None:
        delta = cat_cofactors_from_arrays(
            x_delta, ids_delta, base.cont, base.cat, domains
        )
    else:
        delta = sharded_cat_cofactors(
            x_delta, ids_delta, base.cont, base.cat, domains,
            mesh, data_axes,
        )
    return base + delta


def partitioned_cofactors_host(
    z: np.ndarray, features: Sequence[str], num_parts: int
) -> Cofactors:
    """Host-side demonstration of union commutativity (test oracle)."""
    parts = np.array_split(z, num_parts, axis=0)
    out: Optional[Cofactors] = None
    for part in parts:
        ones = np.ones((part.shape[0],))
        cof = Cofactors(
            count=float(part.shape[0]),
            lin=part.T @ ones,
            quad=part.T @ part,
            features=list(features),
        )
        out = cof if out is None else out + cof
    assert out is not None
    return out
