"""ctypes wrappers of the fused traversal-node kernels (``csrc/segment_view.cu``).

* :func:`segment_view` — extend a view's blocks with feature ``x`` and
  GROUP BY in one kernel: ``segment_view2_*`` at degree 2,
  ``segment_view1_*`` at degree 1.  Replaces ``segment_view_kernel_call``
  and ``segment_view1_kernel_call`` of ``repro/kernels/segment_view.py``.
* :func:`segment_blocks` — segment-sum a view's c|l|q blocks packed side
  by side through one ``segment_reduce_*`` launch.  Replaces
  ``segment_reduce_kernel_call``.

The functions take CUDA tensors only and raise on anything else; their
plain PyTorch versions with the same signatures are
``repro_torch.kernels.ref.segment_view_ref`` / ``segment_blocks_ref``.
Outputs are allocated here (``torch.zeros``) and the kernels run on the
current stream without synchronising.  ``launches`` counts the launches of
each kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

__all__ = [
    "expand_view_sums",
    "launches",
    "pack_blocks",
    "segment_blocks",
    "segment_reduce",
    "segment_view",
    "unpack_blocks",
]

#: launches per kernel since the last reset (chip_smoke.py zeroes and reads)
launches = {"segment_view": 0, "segment_view1": 0, "segment_reduce": 0}

_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_ARGTYPES = {
    # (c, x, l, q, seg, m, k, g, out, stream)
    "segment_view2": [_P, _P, _P, _P, _P, _I64, _I32, _I64, _P, _P],
    # (c, x, l, seg, m, k, g, out, stream)
    "segment_view1": [_P, _P, _P, _P, _I64, _I32, _I64, _P, _P],
    # (data, seg, m, w, g, out, stream)
    "segment_reduce": [_P, _P, _I64, _I32, _I64, _P, _P],
}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _check_lead(name: str, t: torch.Tensor, ndim: int) -> None:
    """The tensor that sets device and dtype for a launch."""
    if not t.is_cuda:
        raise ValueError(f"{name}: CUDA kernel called on a {t.device} tensor")
    if t.dtype not in _SUFFIX:
        raise ValueError(f"{name}: unsupported dtype {t.dtype}")
    if t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {ndim}-D tensor")


def _check(name: str, t, like: torch.Tensor, shape) -> None:
    if t is None or not t.is_cuda or t.device != like.device:
        raise ValueError(f"{name}: expected a tensor on {like.device}")
    if t.dtype != like.dtype:
        raise ValueError(f"{name}: dtype {t.dtype} differs from {like.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def _check_seg(seg: torch.Tensor, like: torch.Tensor, m: int) -> None:
    if seg.dtype != torch.int32 or seg.device != like.device:
        raise ValueError(f"seg must be int32 on {like.device}")
    if tuple(seg.shape) != (m,) or not seg.is_contiguous():
        raise ValueError(f"seg must be a contiguous [{m}] tensor")


def _launch(kernel: str, dtype: torch.dtype, device, *args) -> None:
    symbol = {"segment_view": "segment_view2"}.get(kernel, kernel)
    fn = _build.function(
        "segment_view", f"{symbol}_{_SUFFIX[dtype]}", _ARGTYPES[symbol]
    )
    err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed: cudaError_t {err}")
    launches[kernel] += 1


def segment_view(
    c: torch.Tensor,
    x: torch.Tensor,
    l: torch.Tensor,
    q: Optional[torch.Tensor],
    seg: torch.Tensor,
    num_groups: int,
    degree: int = 2,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Fused extend-and-group: ``(c [M], l [M, k], q [M, k, k])``, feature
    ``x [M]`` and int32 ``seg [M]`` become ``(c' [G], l' [G, k+1],
    q' [G, k+1, k+1])`` (``q'`` None at degree 1), feature prepended."""
    if degree not in (1, 2):
        raise ValueError(f"segment_view needs degree 1 or 2, got {degree}")
    _check_lead("c", c, 1)
    m = c.shape[0]
    _check_seg(seg, c, m)
    if l.dim() != 2:
        raise ValueError(f"l must be [M, k], got {tuple(l.shape)}")
    k = l.shape[1]
    _check("x", x, c, (m,))
    _check("l", l, c, (m, k))
    g = int(num_groups)
    if degree == 2:
        _check("q", q, c, (m, k, k))
        w = 3 + 2 * k + k * k
    else:
        w = k + 2
    s = torch.zeros((g, w), dtype=c.dtype, device=c.device)
    if m:
        ptrs = [c.data_ptr(), x.data_ptr(), l.data_ptr()]
        if degree == 2:
            ptrs.append(q.data_ptr())
        _launch(
            "segment_view" if degree == 2 else "segment_view1",
            c.dtype, c.device, *ptrs, seg.data_ptr(), m, k, g, s.data_ptr(),
        )
    return expand_view_sums(s, k, degree)


def expand_view_sums(s: torch.Tensor, k: int, degree: int):
    """The view blocks ``(c', l', q')`` from the kernels' per-group sums:
    ``[G, k+2]`` rows ``[c, xc, l]`` at degree 1, ``[G, 3+2k+k²]`` rows
    ``[c, xc, x·xc, l, x·l, q]`` at degree 2 (the packed bordered matrix,
    rebuilt at G size)."""
    c_new = s[:, 0].contiguous()
    if degree == 1:
        return c_new, s[:, 1:].contiguous(), None
    g = s.shape[0]
    sxc, sx2c = s[:, 1], s[:, 2]
    sl, sxl = s[:, 3 : 3 + k], s[:, 3 + k : 3 + 2 * k]
    l_new = torch.cat([sxc[:, None], sl], dim=1)
    q_new = torch.empty((g, k + 1, k + 1), dtype=s.dtype, device=s.device)
    q_new[:, 0, 0] = sx2c
    q_new[:, 0, 1:] = sxl
    q_new[:, 1:, 0] = sxl
    q_new[:, 1:, 1:] = s[:, 3 + 2 * k :].reshape(g, k, k)
    return c_new, l_new, q_new


def segment_reduce(
    data: torch.Tensor, seg: torch.Tensor, num_groups: int
) -> torch.Tensor:
    """Segmented sum of the rows of a contiguous ``[M, W]`` payload:
    ``[G, W]``."""
    _check_lead("data", data, 2)
    m, w = data.shape
    _check_seg(seg, data, m)
    g = int(num_groups)
    out = torch.zeros((g, w), dtype=data.dtype, device=data.device)
    if m and w:
        _launch(
            "segment_reduce", data.dtype, data.device,
            data.data_ptr(), seg.data_ptr(), m, w, g, out.data_ptr(),
        )
    return out


def segment_blocks(
    c: torch.Tensor,
    l: Optional[torch.Tensor],
    q: Optional[torch.Tensor],
    seg: torch.Tensor,
    num_groups: int,
    degree: int = 2,
):
    """Segment-sum all of a view's blocks in one kernel launch: c [M]
    (+ l [M, k] + q [M, k, k] per ``degree``) packed side by side into one
    payload.  Returns ``(c', l', q')`` with Nones past ``degree``."""
    k = l.shape[1] if degree >= 1 else 0
    out = segment_reduce(pack_blocks(c, l, q, degree), seg, num_groups)
    return unpack_blocks(out, k, degree)


def pack_blocks(c, l, q, degree: int) -> torch.Tensor:
    """A view's blocks side by side as one contiguous ``[M, W]``
    payload: ``c | l | q`` up to ``degree``."""
    parts = [c[:, None]]
    if degree >= 1:
        parts.append(l)
    if degree == 2:
        parts.append(q.reshape(c.shape[0], l.shape[1] ** 2))
    parts = [p for p in parts if p.shape[1]]
    if len(parts) == 1:  # c alone (k = 0): a view, no copy
        return parts[0].contiguous()
    return torch.cat(parts, dim=1)


def unpack_blocks(out: torch.Tensor, k: int, degree: int):
    """``(c', l', q')`` from the ``[G, W]`` sums of a packed payload."""
    g = out.shape[0]
    c_new = out[:, 0].contiguous()
    l_new = out[:, 1 : 1 + k].contiguous() if degree >= 1 else None
    q_new = None
    if degree == 2:
        q_new = out[:, 1 + k :].reshape(g, k, k).contiguous()
    return c_new, l_new, q_new
