"""Public entry points of the kernel layer.

Each function dispatches on where its tensors lie: a CUDA tensor goes to
the hand-written CUDA kernel (``segment_view`` / ``moments`` / ``gram`` /
``segment_gram`` modules), which launches or raises; a CPU tensor goes to
the plain PyTorch version in ``ref``.  There is no fallback from one to the
other.

Unlike the TPU wrappers there is no padding to block multiples: the CUDA
kernels take any row count.  The segment-view family accumulates straight
into a ``[G, W]`` output in device memory, whatever its size.  The grouped
Grams keep the TPU wrappers' budget contract, as a shared-memory budget
(``smem_budget``, default and cap ``SMEM_ACC_BYTES``): ``segment_gram``
processes groups in chunks whose ``[G_chunk, K(K+1)/2]`` accumulator fits
it, with ids rebased per chunk, and ``multi_segment_gram`` falls back to one
``segment_gram`` per column when the fused ``[ΣG, K(K+1)/2]`` accumulator
does not fit.  Both paths (kernel and plain version) chunk alike, and both
refuse a width whose single group exceeds the budget (K > 313 in float32,
K > 221 in float64 at the default).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from . import gram as _gram
from . import moments as _moments
from . import ref
from . import segment_gram as _sg
from . import segment_view as _sv

__all__ = [
    "SMEM_ACC_BYTES",
    "fast_device_grouping",
    "gram",
    "group_ids_device",
    "launch_counts",
    "moments",
    "multi_segment_gram",
    "on_gpu",
    "reset_launch_counts",
    "segment_blocks",
    "segment_gram",
    "segment_view",
]

SMEM_ACC_BYTES = _sg.SMEM_ACC_BYTES
_COUNTERS = (_sv.launches, _moments.launches, _gram.launches, _sg.launches)


def on_gpu() -> bool:
    return torch.cuda.is_available()


def launch_counts() -> dict:
    """Launches of every CUDA kernel since the last reset."""
    out = {}
    for counts in _COUNTERS:
        out.update(counts)
    return out


def reset_launch_counts() -> None:
    for counts in _COUNTERS:
        for name in counts:
            counts[name] = 0


def _seg_ids(seg, device: torch.device) -> torch.Tensor:
    seg = torch.as_tensor(seg, device=device)
    return seg if seg.dtype == torch.int32 else seg.to(torch.int32)


def segment_view(
    c: torch.Tensor,
    x: torch.Tensor,
    l: torch.Tensor,
    q: Optional[torch.Tensor],
    seg,
    num_groups: int,
    *,
    degree: int = 2,
):
    """Fused traversal node: extend a view's blocks with feature ``x`` AND
    GROUP BY in one pass — ``(c [M], l [M, k], q [M, k, k])`` plus segment
    ids become ``(c' [G], l' [G, k+1], q' [G, k+1, k+1])`` with the feature
    prepended (``q'`` None at degree 1).  ``seg`` may be a host array; it
    moves to ``c``'s device.  Returns blocks in ``c``'s dtype."""
    if degree not in (1, 2):
        raise ValueError(f"segment_view needs degree 1 or 2, got {degree}")
    seg = _seg_ids(seg, c.device)
    q = q.contiguous() if degree == 2 else None
    impl = _sv.segment_view if c.is_cuda else ref.segment_view_ref
    return impl(
        c.contiguous(), x.contiguous(), l.contiguous(), q, seg, num_groups,
        degree=degree,
    )


def segment_blocks(
    c: torch.Tensor,
    l: Optional[torch.Tensor],
    q: Optional[torch.Tensor],
    seg,
    num_groups: int,
    *,
    degree: int = 2,
):
    """Segment-reduce ALL of a view's blocks in one call: c [M] (+ l [M, k]
    + q [M, k, k] per ``degree``).  Returns ``(c', l', q')`` with Nones
    past ``degree``, in ``c``'s dtype."""
    if degree not in (0, 1, 2):
        raise ValueError(f"segment_blocks needs degree 0, 1 or 2, got {degree}")
    seg = _seg_ids(seg, c.device)
    impl = _sv.segment_blocks if c.is_cuda else ref.segment_blocks_ref
    return impl(c, l, q, seg, num_groups, degree=degree)


def moments(x: torch.Tensor):
    """(Σx, max|x|, count) for a 1-D column in one fused pass."""
    impl = _moments.moments if x.is_cuda else ref.moments_ref
    return impl(x.contiguous())


def _gram_input(x: torch.Tensor) -> torch.Tensor:
    if x.dim() != 2:
        raise ValueError(f"expected an [M, K] matrix, got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"gram kernels take float32 or float64, got {x.dtype}")
    return x.contiguous()


def gram(x: torch.Tensor) -> torch.Tensor:
    """``XᵀX`` for any ``[M, K]`` float32/float64 matrix: a symmetric
    ``[K, K]`` in ``x``'s dtype."""
    x = _gram_input(x)
    impl = _gram.gram if x.is_cuda else ref.gram_ref
    return impl(x)


def _group_budget(x: torch.Tensor, smem_budget: Optional[int]) -> tuple:
    """(budget bytes, accumulator bytes per group) of the grouped Grams."""
    budget = min(smem_budget or SMEM_ACC_BYTES, SMEM_ACC_BYTES)
    k = x.shape[1]
    return budget, max(k * (k + 1) // 2 * x.element_size(), 1)


def segment_gram(
    x: torch.Tensor,
    seg,
    num_groups: int,
    *,
    smem_budget: Optional[int] = None,
) -> torch.Tensor:
    """Per-group Gram ``out[g] = Σ_{seg=g} x xᵀ`` for any ``[M, K]`` and
    segment ids ``seg [M]`` (a host array moves to ``x``'s device): ``[G, K,
    K]`` in ``x``'s dtype.  Ids outside ``[0, G)`` add nothing.  When the
    ``[G, K(K+1)/2]`` accumulator exceeds the budget, groups are processed
    in chunks with ids rebased per chunk."""
    x = _gram_input(x)
    seg = _seg_ids(seg, x.device).contiguous()
    num_groups = int(num_groups)
    budget, per_group = _group_budget(x, smem_budget)
    if per_group > budget:
        raise ValueError(
            f"one group's accumulator ({per_group} bytes at K = {x.shape[1]}) "
            f"exceeds the {budget}-byte budget"
        )
    g_chunk = min(num_groups, budget // per_group)
    impl = _sg.segment_gram if x.is_cuda else ref.segment_gram_ref
    if g_chunk >= num_groups:
        return impl(x, seg, num_groups)
    outs = []
    for g0 in range(0, num_groups, g_chunk):
        gn = min(g_chunk, num_groups - g0)
        inside = (seg >= g0) & (seg < g0 + gn)
        rebased = torch.where(inside, seg - g0, -1).to(torch.int32)
        outs.append(impl(x, rebased, gn))
    return torch.cat(outs, dim=0)


def multi_segment_gram(
    x: torch.Tensor,
    segs,
    num_groups: Sequence[int],
    *,
    smem_budget: Optional[int] = None,
) -> List[torch.Tensor]:
    """Per-group Grams for SEVERAL segment-id columns from one read of
    ``x``: ``segs [M, n_seg]``, column ``i``'s ids in ``[0, num_groups[i])``.
    Returns a list of ``[G_i, K, K]`` in ``x``'s dtype.  If the fused
    ``[ΣG, K(K+1)/2]`` accumulator exceeds the budget, falls back to one
    (chunked) ``segment_gram`` per column."""
    x = _gram_input(x)
    num_groups = [int(g) for g in num_groups]
    segs = _seg_ids(segs, x.device)
    if segs.dim() != 2 or segs.shape[1] != len(num_groups):
        raise ValueError(
            f"segs shape {tuple(segs.shape)} does not match "
            f"{len(num_groups)} group counts"
        )
    if not num_groups:
        return []
    budget, per_group = _group_budget(x, smem_budget)
    if sum(num_groups) * per_group > budget:
        return [
            segment_gram(x, segs[:, i], g, smem_budget=smem_budget)
            for i, g in enumerate(num_groups)
        ]
    impl = _sg.multi_segment_gram if x.is_cuda else ref.multi_segment_gram_ref
    return impl(x, segs.contiguous(), num_groups)


def fast_device_grouping(device) -> bool:
    """Whether :func:`group_ids_device` should replace host ``np.unique``
    for tensors on ``device``: on a GPU the sort runs on the card and the
    per-row ids never travel back to the host; on the CPU numpy is faster."""
    return torch.device(device).type == "cuda"


def group_ids_device(key, device=None) -> tuple:
    """Tensor GROUP BY ids: stable sort + adjacent-difference run detection
    instead of host ``np.unique``.  Returns ``(seg, num_groups, first)``
    bit-compatible with ``np.unique(key, return_index=True,
    return_inverse=True)`` — groups numbered in ascending key order, ``seg``
    an int32 tensor on ``device`` and ``first`` (host int64 array) the first
    occurrence of each group.  int64 keys stay int64."""
    key = torch.as_tensor(key, device=device)
    n = key.shape[0]
    if n == 0:
        empty = torch.zeros((0,), dtype=torch.int32, device=key.device)
        return empty, 0, np.zeros((0,), dtype=np.int64)
    sk, order = torch.sort(key, stable=True)
    start = torch.ones(n, dtype=torch.bool, device=key.device)
    start[1:] = sk[1:] != sk[:-1]
    gid = torch.cumsum(start, 0) - 1
    inv = torch.empty_like(gid).scatter_(0, order, gid)
    first = order[start].cpu().numpy().astype(np.int64)
    return inv.to(torch.int32), int(first.shape[0]), first
