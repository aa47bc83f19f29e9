"""ctypes wrappers of the grouped Gram kernels (``csrc/segment_gram.cu``).

* :func:`segment_gram` — ``out[g] = Σ_{seg=g} x xᵀ`` through
  ``segment_gram_*``.  Replaces ``segment_gram_kernel_call`` of
  ``repro/kernels/segment_gram.py``.
* :func:`multi_segment_gram` — the grouped Grams of several segment-id
  columns from one read of ``x`` through ``multi_segment_gram_*``.
  Replaces ``multi_segment_gram_kernel_call``.

The functions take CUDA tensors only and raise on anything else; their
plain PyTorch versions with the same signatures are
``repro_torch.kernels.ref.segment_gram_ref`` / ``multi_segment_gram_ref``.
One launch holds the ``[ΣG, K(K+1)/2]`` accumulator in the shared memory
of a crew of up to 8 CTAs that read the same rows, each holding its share
of the triangle entries of every group, and a hot band (at most 256
groups) in several copies (:func:`plan`, the mirror of ``plan`` in the
source); an accumulator that no crew holds raises (``ops`` chunks the
groups by ``plan()["most"]`` so that it does not).  The group counts go to
the kernel as arguments.  Outputs are allocated here and the kernels run
on the current stream without synchronising.  ``launches`` counts the
launches of each kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence

import torch

from . import _build
from .segment_view import _SUFFIX, _check_lead

__all__ = [
    "GROUP_BYTES",
    "MAX_BANDS",
    "kernel_plan",
    "launches",
    "multi_segment_gram",
    "plan",
    "segment_gram",
]

#: launches per kernel since the last reset (chip_smoke.py zeroes and reads)
launches = {"segment_gram": 0, "multi_segment_gram": 0}

# the launch's shared-memory layout (the constants of csrc/segment_gram.cu)
_SMEM_BLOCK = 232_448  # what one block may have on sm_90
_BAR_BYTES = 128  # the stages' mbarriers
_RING_BYTES = 48_000  # the stages hold at most this
_MAX_SPLIT = 8
_MAX_STAGES = 8
_MAX_ROWS = 128
_HOT_GROUPS = 256  # a band this small is hot: kept in copies
_MAX_COPIES = 16

#: id columns one launch takes (``multi_segment_gram`` falls back to one
#: launch a column past it)
MAX_BANDS = 32

#: the most accumulator one group may have (its K(K+1)/2 values): chunking
#: cannot go below one group
GROUP_BYTES = 192 * 1024

_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_ARGTYPES = {
    # (x, seg, m, k, g, split, compact, out, stream)
    "segment_gram": [_P, _P, _I64, _I32, _I64, _I32, _P, _P, _P],
    # (x, segs, m, k, n_seg, groups, split, compact, out, stream)
    "multi_segment_gram": [_P, _P, _I64, _I32, _I32, _P, _I32, _P, _P, _P],
}
_PLAN_KEYS = ("split", "entries", "stages", "rows", "copies", "most", "chunks", "smem")


def _acc_len(groups: Sequence[int], e: int, copies: int) -> int:
    """Values of the accumulator (``acc_len`` in the source)."""
    return sum(g * (e | 1) * copies if g <= _HOT_GROUPS and copies > 1 else g * e
               for g in groups)


def plan(k: int, groups, elem: int) -> dict:
    """The launch of a grouped Gram of width ``k`` over id columns of
    ``groups`` groups (a count, or a list of one count a column) and
    ``elem``-byte values (``plan`` in the source): the least ``split`` (1–8 CTAs reading
    the same rows) whose CTAs hold their ``entries`` of the triangle
    (``ceil(k(k+1)/2 / split)`` each) for every group beside their
    ``stages`` (one a team of threads) of ``rows`` rows each; ``most``
    groups fit one launch, and ``chunks`` launches cover the groups (1: one
    launch; else the widest split's plan); in one launch, ``copies`` (16,
    8, 4, 2 or 1: the most that fit) of each hot band; ``smem`` the dynamic
    shared memory of a CTA."""
    counts = (int(groups),) if isinstance(groups, int) else tuple(int(g) for g in groups)
    return dict(_plan(k, counts, elem))


@functools.lru_cache(maxsize=256)
def _plan(k: int, groups: tuple, elem: int) -> dict:
    n_seg, total = len(groups), sum(groups)
    nt = k * (k + 1) // 2
    row_bytes = k * elem + 4 * n_seg
    out = dict.fromkeys(_PLAN_KEYS, 0)
    for c in range(1, _MAX_SPLIT + 1):
        e = -(-nt // c)
        stages, rows = _MAX_STAGES, 0
        while stages >= 1:
            rows = min(_RING_BYTES // stages // row_bytes // 4 * 4, _MAX_ROWS)
            if rows >= 4:
                break
            stages //= 2
        if rows < 4:  # a row wider than the ring
            continue
        ring = stages * rows * row_bytes
        avail = (_SMEM_BLOCK - _BAR_BYTES - ring) // elem
        most = (avail - 3) // max(e, 1)
        if most < 1:
            continue
        copies, n = 1, min(total, most) * e
        if total <= most:
            copies = _MAX_COPIES if any(g <= _HOT_GROUPS for g in groups) else 1
            while copies > 1 and _acc_len(groups, e, copies) + 3 > avail:
                copies //= 2
            n = _acc_len(groups, e, copies)
        out = dict(split=c, entries=e, stages=stages, rows=rows, copies=copies,
                   most=most, chunks=-(-total // most) if total > most else 1,
                   smem=_BAR_BYTES + ring + (n + 3) // 4 * 4 * elem)
        if total <= most:
            break
    return out


def kernel_plan(k: int, groups, elem: int) -> dict:
    """The built library's own :func:`plan` (``segment_gram_plan``)."""
    groups = [int(groups)] if isinstance(groups, int) else [int(g) for g in groups]
    fn = _build.function("segment_gram", "segment_gram_plan",
                         [_I32, _I32, _P, _I32, _P])
    counts = (ctypes.c_int64 * len(groups))(*groups)
    out = (ctypes.c_int64 * len(_PLAN_KEYS))()
    err = fn(k, len(groups), ctypes.addressof(counts), elem, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"segment_gram_plan failed: cudaError_t {err}")
    return dict(zip(_PLAN_KEYS, out))


def _check_ids(segs: torch.Tensor, like: torch.Tensor, shape) -> None:
    if segs.dtype != torch.int32 or segs.device != like.device:
        raise ValueError(f"segment ids must be int32 on {like.device}")
    if tuple(segs.shape) != tuple(shape) or not segs.is_contiguous():
        raise ValueError(f"segment ids must be a contiguous {list(shape)} tensor")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` at a 16-byte aligned address (the stages' bulk copies need it;
    a fresh allocation is)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _run(kernel: str, x: torch.Tensor, segs: torch.Tensor,
         groups: List[int]) -> torch.Tensor:
    """One launch over all bands: the ``[ΣG, K, K]`` grouped Grams."""
    m, k = x.shape
    total = sum(groups)
    if len(groups) > MAX_BANDS:
        raise ValueError(f"{kernel}: {len(groups)} id columns, at most {MAX_BANDS}")
    p = plan(k, groups, x.element_size())
    if p["chunks"] != 1:
        raise ValueError(
            f"{kernel}: a [{total}, {k * (k + 1) // 2}] accumulator does not fit "
            "one launch; chunk the groups"
        )
    out_shape = (total, k, k)
    if m == 0 or k == 0 or total == 0:
        return torch.zeros(out_shape, dtype=x.dtype, device=x.device)
    slab = (total * p["entries"] + 3) // 4 * 4
    compact = torch.empty(p["split"] * slab, dtype=x.dtype, device=x.device)
    out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    fn = _build.function(
        "segment_gram", f"{kernel}_{_SUFFIX[x.dtype]}", _ARGTYPES[kernel]
    )
    if kernel == "segment_gram":
        args = (total,)
    else:
        counts = (ctypes.c_int64 * len(groups))(*groups)
        args = (len(groups), ctypes.addressof(counts))
    err = fn(
        _aligned(x).data_ptr(), _aligned(segs).data_ptr(), m, k, *args,
        p["split"], compact.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError_t {err}")
    launches[kernel] += 1
    return out


def segment_gram(
    x: torch.Tensor, seg: torch.Tensor, num_groups: int
) -> torch.Tensor:
    """Per-group Gram of a contiguous ``[M, K]`` float32/float64 matrix and
    int32 ``seg [M]``: ``[G, K, K]`` in ``x``'s dtype; ids outside
    ``[0, G)`` add nothing."""
    _check_lead("x", x, 2)
    _check_ids(seg, x, (x.shape[0],))
    return _run("segment_gram", x, seg, [int(num_groups)])


def multi_segment_gram(
    x: torch.Tensor, segs: torch.Tensor, num_groups: Sequence[int]
) -> List[torch.Tensor]:
    """Grouped Grams for every column of int32 ``segs [M, n_seg]`` from one
    read of ``x``: a list of ``[G_i, K, K]`` (views into one band-offset
    ``[ΣG, K, K]`` result); column ``i``'s ids outside ``[0, G_i)`` add
    nothing."""
    _check_lead("x", x, 2)
    groups = [int(g) for g in num_groups]
    _check_ids(segs, x, (x.shape[0], len(groups)))
    if not groups:
        return []
    out = _run("multi_segment_gram", x, segs, groups)
    bounds = [0]
    for g in groups:
        bounds.append(bounds[-1] + g)
    return [out[bounds[i] : bounds[i + 1]] for i in range(len(groups))]
