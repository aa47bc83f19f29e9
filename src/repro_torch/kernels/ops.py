"""Public entry points of the kernel layer.

Each function dispatches on where its tensors lie: a CUDA tensor goes to
the hand-written CUDA kernel (``segment_view`` / ``moments`` modules), which
launches or raises; a CPU tensor goes to the plain PyTorch version in
``ref``.  There is no fallback from one to the other.

Unlike the TPU wrappers there is no padding to block multiples and no
group chunking: the CUDA kernels take any row count and accumulate straight
into a ``[G, W]`` output in device memory, whatever its size.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import moments as _moments
from . import ref
from . import segment_view as _sv

__all__ = [
    "fast_device_grouping",
    "group_ids_device",
    "launch_counts",
    "moments",
    "on_gpu",
    "reset_launch_counts",
    "segment_blocks",
    "segment_view",
]


def on_gpu() -> bool:
    return torch.cuda.is_available()


def launch_counts() -> dict:
    """Launches of every CUDA kernel since the last reset."""
    return {**_sv.launches, **_moments.launches}


def reset_launch_counts() -> None:
    for counts in (_sv.launches, _moments.launches):
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
