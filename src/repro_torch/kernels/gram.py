"""ctypes wrapper of the Gram kernel (``csrc/gram.cu``).

:func:`gram` computes ``XᵀX`` of an ``[M, K]`` matrix through ``gram_*``.
Replaces ``gram_kernel_call`` of ``repro/kernels/gram.py``.

The function takes a CUDA tensor only and raises on anything else; its
plain PyTorch version with the same signature is
``repro_torch.kernels.ref.gram_ref``.  The output and the per-row-range
scratch are allocated here and the kernel runs on the current stream
without synchronising.  ``launches`` counts its launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .segment_view import _SUFFIX, _check_lead

__all__ = ["gram", "launches", "num_parts"]

#: launches since the last reset (chip_smoke.py zeroes and reads)
launches = {"gram": 0}

_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# (x, m, k, parts, partial, out, stream)
_ARGTYPES = [_P, _I64, _I32, _I32, _P, _P, _P]

_SMS = 132  # H100 SXM streaming multiprocessors
_SMALL_K = 8  # widths the kernel keeps in registers (csrc/gram.cu)


def num_parts(m: int, k: int) -> int:
    """Row ranges the kernel splits ``m`` rows into: one per block of 256
    rows up to 8 blocks per SM for K ≤ 8; for the tiled path enough splits
    that the upper 32×32 tiles times the splits fill about 4 blocks per SM,
    each split keeping at least 32 rows."""
    if k <= _SMALL_K:
        return max(1, min(-(-m // 256), 8 * _SMS))
    tiles = -(-k // 32)
    upper = tiles * (tiles + 1) // 2
    return max(1, min(-(-m // 32), -(-4 * _SMS // upper)))


def gram(x: torch.Tensor) -> torch.Tensor:
    """``XᵀX`` of a contiguous ``[M, K]`` float32/float64 CUDA matrix, as a
    symmetric ``[K, K]`` tensor of the same dtype."""
    _check_lead("x", x, 2)
    m, k = x.shape
    if m == 0 or k == 0:
        return torch.zeros((k, k), dtype=x.dtype, device=x.device)
    parts = num_parts(m, k)
    partial = torch.empty(
        (parts, k * (k + 1) // 2), dtype=x.dtype, device=x.device
    )
    out = torch.empty((k, k), dtype=x.dtype, device=x.device)
    fn = _build.function("gram", f"gram_{_SUFFIX[x.dtype]}", _ARGTYPES)
    err = fn(
        x.data_ptr(), m, k, parts, partial.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"gram launch failed: cudaError_t {err}")
    launches["gram"] += 1
    return out
