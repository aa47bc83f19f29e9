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
The kernels accumulate the K(K+1)/2 distinct entries of each group in a
per-block shared-memory accumulator; ``[ΣG, K(K+1)/2]`` must fit
``SMEM_ACC_BYTES`` (``ops`` chunks groups so that it does) and a larger
one raises.
Outputs are allocated here and the kernels run on the current stream
without synchronising.  ``launches`` counts the launches of each kernel.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence

import torch

from . import _build
from .segment_view import _SUFFIX, _check_lead

__all__ = ["SMEM_ACC_BYTES", "launches", "multi_segment_gram", "segment_gram"]

#: launches per kernel since the last reset (chip_smoke.py zeroes and reads)
launches = {"segment_gram": 0, "multi_segment_gram": 0}

#: largest per-block shared-memory accumulator the kernels use (of the
#: 227 KB a Hopper block may have; the rest stays free for the runtime)
SMEM_ACC_BYTES = 192 * 1024

_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_ARGTYPES = {
    # (x, seg, m, k, g, bands, compact, out, stream)
    "segment_gram": [_P, _P, _I64, _I32, _I64, _P, _P, _P, _P],
    # (x, segs, m, k, n_seg, bands, total, compact, out, stream)
    "multi_segment_gram": [_P, _P, _I64, _I32, _I32, _P, _I64, _P, _P, _P],
}


def _check_ids(segs: torch.Tensor, like: torch.Tensor, shape) -> None:
    if segs.dtype != torch.int32 or segs.device != like.device:
        raise ValueError(f"segment ids must be int32 on {like.device}")
    if tuple(segs.shape) != tuple(shape) or not segs.is_contiguous():
        raise ValueError(f"segment ids must be a contiguous {list(shape)} tensor")


def _run(kernel: str, x: torch.Tensor, segs: torch.Tensor,
         groups: List[int]) -> torch.Tensor:
    """One launch over all bands: the ``[ΣG, K, K]`` grouped Grams."""
    m, k = x.shape
    total = sum(groups)
    acc_bytes = total * k * (k + 1) // 2 * x.element_size()
    if acc_bytes > SMEM_ACC_BYTES:
        raise ValueError(
            f"{kernel}: a [{total}, {k * (k + 1) // 2}] accumulator "
            f"({acc_bytes} bytes) exceeds SMEM_ACC_BYTES; chunk the groups"
        )
    out_shape = (total, k, k)
    if m == 0 or k == 0 or total == 0:
        return torch.zeros(out_shape, dtype=x.dtype, device=x.device)
    offsets = [sum(groups[:i]) for i in range(len(groups))]
    bands = torch.tensor(groups + offsets, dtype=torch.int64).to(x.device)
    compact = torch.zeros(
        (total, k * (k + 1) // 2), dtype=x.dtype, device=x.device
    )
    out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    fn = _build.function(
        "segment_gram", f"{kernel}_{_SUFFIX[x.dtype]}", _ARGTYPES[kernel]
    )
    if kernel == "segment_gram":
        args = (total, bands.data_ptr())
    else:
        args = (len(groups), bands.data_ptr(), total)
    err = fn(
        x.data_ptr(), segs.data_ptr(), m, k, *args,
        compact.data_ptr(), out.data_ptr(),
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
