"""ctypes wrapper of the feature-scaling moments kernel (``csrc/moments.cu``).

:func:`moments` returns ``(Σx, max|x|, count)`` of a column in one kernel
pass; it replaces ``moments_kernel_call`` of ``repro/kernels/moments.py``.
It takes a contiguous 1-D CUDA tensor only; its plain PyTorch version is
``repro_torch.kernels.ref.moments_ref``.  ``launches`` counts launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build

__all__ = ["launches", "moments"]

#: launches since the last reset (chip_smoke.py zeroes and reads)
launches = {"moments": 0}

_P = ctypes.c_void_p
# (x, m, sum_out, max_out, stream)
_ARGTYPES = [_P, ctypes.c_int64, _P, _P, _P]
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def moments(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """``(Σx, max|x|, count)`` of a column; the sums are 0-d tensors in
    ``x``'s dtype, accumulated in that dtype."""
    if not x.is_cuda:
        raise ValueError(f"CUDA kernel called on a {x.device} tensor")
    if x.dtype not in _SUFFIX:
        raise ValueError(f"unsupported dtype {x.dtype} (float32 / float64)")
    if x.dim() != 1 or not x.is_contiguous():
        raise ValueError("x must be a contiguous 1-D tensor")
    m = x.shape[0]
    out = torch.zeros(2, dtype=x.dtype, device=x.device)
    if m:
        fn = _build.function("moments", f"moments_{_SUFFIX[x.dtype]}", _ARGTYPES)
        err = fn(
            x.data_ptr(), m, out.data_ptr(), out[1:].data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
        if err != 0:
            raise RuntimeError(f"moments launch failed: cudaError_t {err}")
        launches["moments"] += 1
    return out[0], out[1], m
