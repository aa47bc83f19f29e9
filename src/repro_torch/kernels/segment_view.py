"""ctypes wrappers of the fused traversal-node kernels (``csrc/segment_view.cu``).

* :func:`segment_view` — extend a view's blocks with feature ``x`` and
  GROUP BY in one kernel: ``segment_view2_*`` at degree 2,
  ``segment_view1_*`` at degree 1.  Replaces ``segment_view_kernel_call``
  and ``segment_view1_kernel_call`` of ``repro/kernels/segment_view.py``.
* :func:`segment_blocks` — segment-sum a view's c, l and q blocks through
  one ``segment_blocks_*`` launch.  Replaces ``segment_reduce_kernel_call``.

Degree 2, degree 1 and the blocks take one of two paths per call
(:func:`plan`, the mirror of ``plan`` in the source): A, one row per group,
when the caller passes ``order`` (each group's row, so the ids are a
permutation): one thread per group gathers its row and stores it into
``torch.empty`` blocks; C otherwise: warp-combined vector atomics into a
zeroed ``[G, Wp]`` accumulator, then a finishing kernel.

The functions take CUDA tensors only and raise on anything else; their
plain PyTorch versions with the same signatures are
``repro_torch.kernels.ref.segment_view_ref`` / ``segment_blocks_ref``.
Outputs are allocated here and the kernels run on the current stream
without synchronising.  ``launches`` counts the calls that launched each
kernel (path C's finishing kernel rides in the same count).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

__all__ = [
    "KERNEL_NAMES",
    "PATHS",
    "kernel_plan",
    "launches",
    "plan",
    "segment_blocks",
    "segment_view",
    "width",
]

#: launches per kernel since the last reset (chip_smoke.py zeroes and reads)
launches = {"segment_view": 0, "segment_view1": 0, "segment_reduce": 0}

#: the paths of every payload, by the number the library uses
PATHS = ("one_row", "atomic")
#: prefixes of the device kernels' names, as a profiler reports them
KERNEL_NAMES = {
    "segment_view": ("seg_store<float, 0>", "seg_atomic<float, 0>",
                     "seg_finish<float, 0>"),
    "segment_view1": ("seg_store<float, 1>", "seg_atomic<float, 1>",
                      "seg_finish<float, 1>"),
    "segment_reduce": ("seg_store<float, 2>", "seg_atomic<float, 2>",
                       "seg_finish<float, 2>"),
}
_PAYLOAD = {"view": 0, "view1": 1, "blocks": 2}

_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_ARGTYPES = {
    # (c, x, l, q, seg, order, m, k, g, path, out_c, out_l, out_q, acc, stream)
    "segment_view2": [_P] * 6 + [_I64, _I32, _I64, _I32] + [_P] * 5,
    # (c, x, l, seg, order, m, k, g, path, out_c, out_l, acc, stream)
    "segment_view1": [_P] * 5 + [_I64, _I32, _I64, _I32] + [_P] * 4,
    # (c, l, q, seg, order, m, k, degree, g, path, out_c, out_l, out_q, acc,
    #  stream)
    "segment_blocks": [_P] * 5 + [_I64, _I32, _I32, _I64, _I32] + [_P] * 5,
}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_fns = {}  # (symbol, dtype) -> the loaded C function


def width(payload: str, k: int, degree: int) -> int:
    """Entries of one compact row: ``[c, xc, x·xc, l, x·l, q]`` (view,
    degree 2), ``[c, xc, l]`` (view1, degree 1) or ``[c, l, q]`` up to
    ``degree`` (blocks)."""
    if payload == "view":
        return 3 + 2 * k + k * k
    if payload == "view1":
        return 2 + k
    return 1 + (k if degree >= 1 else 0) + (k * k if degree == 2 else 0)


def plan(payload: str, k: int, degree: int, one_row: bool) -> dict:
    """The path of a degree-2 (``payload="view"``), degree-1 (``"view1"``)
    or blocks call and its layout (``plan`` in ``segment_view.cu``): ``path`` (A ``one_row`` when
    the caller passes each group's row, else C ``atomic``), the compact
    ``width`` W and its ``padded`` width (a multiple of 4, path C's
    accumulator rows)."""
    w = width(payload, k, degree)
    return dict(path=PATHS[0 if one_row else 1], width=w, padded=(w + 3) // 4 * 4)


def kernel_plan(payload: str, k: int, degree: int, one_row: bool) -> dict:
    """The built library's own :func:`plan` (``segment_view_plan``)."""
    fn = _build.function("segment_view", "segment_view_plan",
                         [_I32, _I32, _I32, _I32, _P])
    out = (ctypes.c_int * 3)()
    err = fn(_PAYLOAD[payload], k, degree, int(one_row), ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"segment_view_plan failed: cudaError_t {err}")
    return dict(path=PATHS[out[0]], width=out[1], padded=out[2])


def _check_lead(name: str, t: torch.Tensor, ndim: int) -> None:
    """The tensor that sets device and dtype for a launch."""
    if not t.is_cuda:
        raise ValueError(f"{name}: CUDA kernel called on a {t.device} tensor")
    if t.dtype not in _SUFFIX or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {ndim}-D float32 or "
                         f"float64 tensor, got {t.dtype} {tuple(t.shape)}")


# the checks below compare device indices (ints): cheaper than devices on a
# path whose host work is its whole cost


def _check(name: str, t, like: torch.Tensor, shape) -> None:
    if t is None or t.shape != shape:
        raise ValueError(f"{name}: expected shape {tuple(shape)}")
    if shape[-1] and (t.get_device() != like.get_device() or t.dtype is not like.dtype
                      or not t.is_contiguous()):  # a zero-width block is never read
        raise ValueError(f"{name}: expected a contiguous {like.dtype} tensor on "
                         f"{like.device}")


def _check_ids(name: str, t: torch.Tensor, device: int, m: int) -> int:
    """The pointer of ids ``t`` (int32 ``[m]`` on ``device``, contiguous)."""
    if (t.dtype is not torch.int32 or t.get_device() != device or t.shape != (m,)
            or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous int32 [{m}] tensor on cuda:{device}")
    return t.data_ptr()


def _function(symbol: str, dtype: torch.dtype):
    """The C function ``symbol`` for ``dtype``, resolved once."""
    fn = _fns.get((symbol, dtype))
    if fn is None:
        fn = _fns[symbol, dtype] = _build.function(
            "segment_view", f"{symbol}_{_SUFFIX[dtype]}", _ARGTYPES[symbol]
        )
    return fn


def _launch(kernel: str, symbol: str, like: torch.Tensor, *args) -> None:
    err = _function(symbol, like.dtype)(
        *args, torch.cuda.current_stream(like.get_device()).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed: cudaError_t {err}")
    launches[kernel] += 1


def _run(kernel, symbol, c, ptrs, seg, order, dims, g, w, shapes):
    """Check the ids, allocate and launch a degree-2 (``ptrs`` of c, x, l,
    q; ``dims`` (k,)), degree-1 (c, x, l; (k,)) or blocks (c, l, q; (k,
    degree)) call of compact width ``w``; returns the blocks of ``shapes``
    (None where a shape is None).  Kept lean: on the main path's regroups this host work is the
    whole cost of a call."""
    m, index = c.shape[0], c.get_device()
    seg_p, order_p = _check_ids("seg", seg, index, m), None
    if order is not None:
        if m != g:
            raise ValueError(f"order lists one row per group, but there are {m} rows "
                             f"in {g} groups")
        order_p = _check_ids("order", order, index, m)
    new = c.new_empty if m else c.new_zeros  # both paths write every entry
    out = [None if s is None else new(s) for s in shapes]
    if m and g:
        path = 0 if order is not None else 1
        acc = c.new_zeros((g, (w + 3) // 4 * 4)).data_ptr() if path else None
        _launch(kernel, symbol, c, *ptrs, seg_p, order_p, m, *dims, g, path,
                *[None if t is None else t.data_ptr() for t in out], acc)
    return out


def segment_view(
    c: torch.Tensor,
    x: torch.Tensor,
    l: torch.Tensor,
    q: Optional[torch.Tensor],
    seg: torch.Tensor,
    num_groups: int,
    degree: int = 2,
    order: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Fused extend-and-group: ``(c [M], l [M, k], q [M, k, k])``, feature
    ``x [M]`` and int32 ``seg [M]`` become ``(c' [G], l' [G, k+1],
    q' [G, k+1, k+1])`` (``q'`` None at degree 1), feature prepended.
    ``order`` (int32 ``[M]``), where given, lists each group's one row
    (path A)."""
    if degree not in (1, 2):
        raise ValueError(f"segment_view needs degree 1 or 2, got {degree}")
    _check_lead("c", c, 1)
    m = c.shape[0]
    if l.dim() != 2:
        raise ValueError(f"l must be [M, k], got {tuple(l.shape)}")
    k = l.shape[1]
    _check("x", x, c, (m,))
    _check("l", l, c, (m, k))
    g = int(num_groups)
    if degree == 2:
        _check("q", q, c, (m, k, k))
        ptrs = (c.data_ptr(), x.data_ptr(), l.data_ptr(), q.data_ptr())
        return tuple(_run("segment_view", "segment_view2", c, ptrs, seg, order, (k,), g,
                          width("view", k, 2), ((g,), (g, k + 1), (g, k + 1, k + 1))))
    ptrs = (c.data_ptr(), x.data_ptr(), l.data_ptr())
    c1, l1 = _run("segment_view1", "segment_view1", c, ptrs, seg, order, (k,), g,
                  width("view1", k, 1), ((g,), (g, k + 1)))
    return c1, l1, None


def segment_blocks(
    c: torch.Tensor,
    l: Optional[torch.Tensor],
    q: Optional[torch.Tensor],
    seg: torch.Tensor,
    num_groups: int,
    degree: int = 2,
    order: Optional[torch.Tensor] = None,
):
    """Segment-sum all of a view's blocks in one kernel launch: c [M]
    (+ l [M, k] + q [M, k, k] per ``degree``), read in place.  Returns
    ``(c', l', q')`` with Nones past ``degree``.  ``order`` as for
    :func:`segment_view` (path A)."""
    _check_lead("c", c, 1)
    m = c.shape[0]
    k, lp, qp = 0, None, None
    if degree >= 1:
        k = l.shape[1] if l.dim() == 2 else -1
        _check("l", l, c, (m, k))
        lp = l.data_ptr() if k else None
    if degree == 2:
        _check("q", q, c, (m, k, k))
        qp = q.data_ptr() if k else None
    g = int(num_groups)
    return tuple(_run("segment_reduce", "segment_blocks", c, (c.data_ptr(), lp, qp), seg,
                      order, (k, degree), g, width("blocks", k, degree),
                      ((g,), (g, k) if degree >= 1 else None,
                       (g, k, k) if degree == 2 else None)))
