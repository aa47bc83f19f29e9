"""ctypes wrapper of the flash-attention kernel (``csrc/flash.cu``).

:func:`flash_attention` runs online-softmax attention over the model's
``[B, S, H, D]`` layout through ``flash_attention_bf16`` (tensor cores) or
``flash_attention_f32``.  Replaces ``flash_kernel_call`` of
``repro/kernels/flash.py``.

The function takes CUDA tensors only and raises on anything else; its plain
PyTorch version with the same signature is
``repro_torch.kernels.ref.flash_attention_ref``, and ``ops.flash_attention``
checks shapes, dtypes and head dims before either.  The output is allocated
here and the kernel runs on the current stream without synchronising.
``launches`` counts its launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

__all__ = ["flash_attention", "launches"]

#: launches since the last reset (chip_smoke.py zeroes and reads)
launches = {"flash": 0}

_P, _I32 = ctypes.c_void_p, ctypes.c_int
# (q, k, v, out, b, sq, sk, h, kh, d, causal, window, kv_len, stream)
_ARGTYPES = [_P, _P, _P, _P] + [_I32] * 9 + [_P]
_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}


def _operand(name: str, t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned (the kernel loads 16 bytes at a
    time) on ``like``'s device."""
    if not t.is_cuda or t.device != like.device:
        raise ValueError(f"flash: {name} must be a CUDA tensor on {like.device}")
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool,
    window: Optional[int],
    kv_len: int,
) -> torch.Tensor:
    """q ``[B, Sq, H, D]``, k / v ``[B, Sk, KH, D]`` bf16 or float32 CUDA
    tensors (shapes already checked by ``ops.flash_attention``) →
    ``[B, Sq, H, D]`` in q's dtype."""
    if q.dtype not in _SUFFIX:
        raise ValueError(f"flash: unsupported dtype {q.dtype}")
    q = _operand("q", q, q)
    k, v = _operand("k", k, q), _operand("v", v, q)
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn = _build.function("flash", f"flash_attention_{_SUFFIX[q.dtype]}", _ARGTYPES)
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, sq, sk, h, kh, d, int(causal), window or 0, kv_len,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash launch failed: cudaError_t {err}")
    launches["flash"] += 1
    return out
