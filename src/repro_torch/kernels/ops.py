"""Public entry points of the kernel layer.

Each function dispatches on where its tensors lie: a CUDA tensor goes to
the hand-written CUDA kernel (``segment_view`` / ``moments`` / ``gram`` /
``segment_gram`` / ``flash`` modules), which launches or raises; a CPU
tensor goes to the plain PyTorch version in ``ref``.  There is no fallback
from one to the other.

Unlike the TPU wrappers there is no padding to block multiples: the CUDA
kernels take any row count.  The segment-view family writes any number of
groups: each call takes one of two paths (``segment_view.plan``), chosen
by whether the caller passes ``order``, each group's one row.  The grouped
Grams take as many groups a launch as its plan holds
(``segment_gram.plan``, ``most``): ``segment_gram`` processes more in
chunks, with ids rebased per chunk, and ``multi_segment_gram`` falls back to
one ``segment_gram`` per column when the fused ``[ΣG, K(K+1)/2]``
accumulator does not fit one launch or there are more than
``segment_gram.MAX_BANDS`` columns.  ``smem_budget`` keeps the TPU
wrappers' budget contract: it forces chunks whose ``[G_chunk, K(K+1)/2]``
accumulator fits it.  Both paths (kernel and plain version) chunk alike,
and both refuse a width whose single group exceeds the budget or
``GROUP_BYTES`` (K > 313 in float32, K > 221 in float64).
``flash_attention`` reads the model's ``[B, S, H, D]`` layout and the KV
heads of GQA in place: no transposes, no repeated K/V, no padding;
``flash_attention_fn`` is the same attention as an autograd function whose
backward is the ``flash_bwd`` kernel.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from . import flash as _flash
from . import gram as _gram
from . import moments as _moments
from . import ref
from . import segment_gram as _sg
from . import segment_view as _sv

__all__ = [
    "FLASH_MAX_HEAD_DIM",
    "fast_device_grouping",
    "flash_attention",
    "flash_attention_fn",
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

_COUNTERS = (
    _sv.launches, _moments.launches, _gram.launches, _sg.launches, _flash.launches,
)
#: widest head dim the flash kernel takes (its widest instantiation)
FLASH_MAX_HEAD_DIM = 256


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


def _seg_ids(seg, like: torch.Tensor) -> torch.Tensor:
    """``seg`` as int32 on ``like``'s device (the engine's device ids pass
    as they are: a cheap check, on a path whose host work is its cost)."""
    if (type(seg) is torch.Tensor and seg.dtype is torch.int32
            and seg.get_device() == like.get_device()):
        return seg
    seg = torch.as_tensor(seg, device=like.device)
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
    order=None,
):
    """Fused traversal node: extend a view's blocks with feature ``x`` AND
    GROUP BY in one pass — ``(c [M], l [M, k], q [M, k, k])`` plus segment
    ids become ``(c' [G], l' [G, k+1], q' [G, k+1, k+1])`` with the feature
    prepended (``q'`` None at degree 1).  ``seg`` may be a host array; it
    moves to ``c``'s device.  ``order``, where given, states that every
    group has one row and lists it (``order[g]``, group ``g``'s row; where
    ``G == M``, ``group_ids_device(..., with_order=True)`` gives it): the
    kernel then gathers each group's row and stores it in place; the plain
    version checks the statement.  Returns blocks in ``c``'s dtype."""
    if degree not in (1, 2):
        raise ValueError(f"segment_view needs degree 1 or 2, got {degree}")
    seg = _seg_ids(seg, c)
    order = None if order is None else _seg_ids(order, c)
    q = q.contiguous() if degree == 2 else None
    impl = _sv.segment_view if c.is_cuda else ref.segment_view_ref
    return impl(
        c.contiguous(), x.contiguous(), l.contiguous(), q, seg, num_groups,
        degree=degree, order=order,
    )


def segment_blocks(
    c: torch.Tensor,
    l: Optional[torch.Tensor],
    q: Optional[torch.Tensor],
    seg,
    num_groups: int,
    *,
    degree: int = 2,
    order=None,
):
    """Segment-reduce ALL of a view's blocks in one call: c [M] (+ l [M, k]
    + q [M, k, k] per ``degree``).  ``order`` as for :func:`segment_view`.  Returns ``(c', l', q')`` with Nones past
    ``degree``, in ``c``'s dtype."""
    if degree not in (0, 1, 2):
        raise ValueError(f"segment_blocks needs degree 0, 1 or 2, got {degree}")
    seg = _seg_ids(seg, c)
    if order is not None:
        order = _seg_ids(order, c)
    if not c.is_cuda:
        return ref.segment_blocks_ref(c, l, q, seg, num_groups, degree=degree,
                                      order=order)
    return _sv.segment_blocks(
        c.contiguous(), l.contiguous() if degree >= 1 else None,
        q.contiguous() if degree == 2 else None, seg, num_groups, degree, order,
    )


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


def _chunk_groups(x: torch.Tensor, groups: List[int],
                  smem_budget: Optional[int]) -> int:
    """Groups one grouped-Gram launch takes: what its plan holds, cut to
    ``smem_budget`` where given; raises where one group's accumulator
    exceeds the budget or ``GROUP_BYTES``."""
    k = x.shape[1]
    per_group = max(k * (k + 1) // 2 * x.element_size(), 1)
    cap = min(smem_budget or _sg.GROUP_BYTES, _sg.GROUP_BYTES)
    if per_group > cap:
        raise ValueError(
            f"one group's accumulator ({per_group} bytes at K = {k}) "
            f"exceeds the {cap}-byte budget"
        )
    most = _sg.plan(k, groups, x.element_size())["most"]
    return min(most, smem_budget // per_group) if smem_budget else most


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
    ``[G, K(K+1)/2]`` accumulator exceeds one launch or the budget, groups
    are processed in chunks with ids rebased per chunk."""
    x = _gram_input(x)
    seg = _seg_ids(seg, x).contiguous()
    num_groups = int(num_groups)
    g_chunk = min(num_groups, _chunk_groups(x, [num_groups], smem_budget))
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
    ``[ΣG, K(K+1)/2]`` accumulator exceeds one launch or the budget, or
    there are more than ``MAX_BANDS`` columns, falls back to one (chunked)
    ``segment_gram`` per column."""
    x = _gram_input(x)
    num_groups = [int(g) for g in num_groups]
    segs = _seg_ids(segs, x)
    if segs.dim() != 2 or segs.shape[1] != len(num_groups):
        raise ValueError(
            f"segs shape {tuple(segs.shape)} does not match "
            f"{len(num_groups)} group counts"
        )
    if not num_groups:
        return []
    if (len(num_groups) > _sg.MAX_BANDS
            or sum(num_groups) > _chunk_groups(x, num_groups, smem_budget)):
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


def group_ids_device(key, device=None, *, with_order: bool = False) -> tuple:
    """Tensor GROUP BY ids: stable sort + adjacent-difference run detection
    instead of host ``np.unique``.  Returns ``(seg, num_groups, first)``
    bit-compatible with ``np.unique(key, return_index=True,
    return_inverse=True)`` — groups numbered in ascending key order, ``seg``
    an int32 tensor on ``device`` and ``first`` (host int64 array) the first
    occurrence of each group.  int64 keys stay int64.  ``with_order`` adds
    the sort's permutation as a fourth element: the rows in group order,
    int32 on ``device`` (where every group has one row, ``order[g]`` is
    group ``g``'s row)."""
    key = torch.as_tensor(key, device=device)
    n = key.shape[0]
    if n == 0:
        empty = torch.zeros((0,), dtype=torch.int32, device=key.device)
        out = (empty, 0, np.zeros((0,), dtype=np.int64))
        return out + (empty,) if with_order else out
    sk, order = torch.sort(key, stable=True)
    start = torch.ones(n, dtype=torch.bool, device=key.device)
    start[1:] = sk[1:] != sk[:-1]
    gid = torch.cumsum(start, 0) - 1
    inv = torch.empty_like(gid).scatter_(0, order, gid)
    first = order[start].cpu().numpy().astype(np.int64)
    out = (inv.to(torch.int32), int(first.shape[0]), first)
    return out + (order.to(torch.int32),) if with_order else out


def _check_flash(q, k, v, window, kv_len) -> int:
    """Refuse what the flash kernels do not take (``ValueError``); returns
    ``kv_len`` resolved (default ``Sk``)."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"flash_attention: expected q [B, Sq, H, D] and k, v [B, Sk, KH, D], "
            f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, _, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or kh == 0 or h % kh:
        raise ValueError(
            f"flash_attention: k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}"
        )
    if d % 8 or not 8 <= d <= FLASH_MAX_HEAD_DIM:
        raise ValueError(
            f"flash_attention: head dim {d} is not a multiple of 8 in "
            f"[8, {FLASH_MAX_HEAD_DIM}]"
        )
    if q.dtype not in (torch.bfloat16, torch.float32) or not (
        q.dtype == k.dtype == v.dtype
    ):
        raise ValueError(
            f"flash_attention takes bfloat16 or float32 alike, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")
    kv_len = sk if kv_len is None else int(kv_len)
    if not 0 <= kv_len <= sk:
        raise ValueError(f"flash_attention: kv_len {kv_len} outside [0, {sk}]")
    return kv_len


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    kv_len: Optional[int] = None,
) -> torch.Tensor:
    """Fused online-softmax attention: q ``[B, Sq, H, D]``, k / v
    ``[B, Sk, KH, D]`` with ``H % KH == 0`` → ``[B, Sq, H, D]`` in q's dtype.

    Positions are the sequence indices: query ``i`` sees key ``j`` iff
    ``j < kv_len`` (default ``Sk``), ``j <= i`` when ``causal`` and
    ``j > i - window`` when ``window`` is set; a row that sees no key is 0.
    Takes bfloat16 or float32 (all three alike) and a head dim that is a
    multiple of 8 up to :data:`FLASH_MAX_HEAD_DIM`; refuses anything else
    with ``ValueError``.  Not differentiable: :func:`flash_attention_fn` is."""
    kv_len = _check_flash(q, k, v, window, kv_len)
    impl = _flash.flash_attention if q.is_cuda else ref.flash_attention_ref
    return impl(q, k, v, causal=causal, window=window, kv_len=kv_len)


class _FlashFunction(torch.autograd.Function):
    """The flash forward (with the row log-sum-exp) and its backward on
    plain tensors: the kernels on a CUDA tensor, the plain versions on a
    CPU tensor."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, kv_len):
        kw = dict(causal=causal, window=window, kv_len=kv_len)
        if q.is_cuda:
            out, lse = _flash.flash_attention(q, k, v, with_lse=True, **kw)
        else:
            out, lse = ref.flash_attention_ref(q, k, v, **kw), None
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if q.is_cuda:
            grads = _flash.flash_backward(q, k, v, out, dout, lse, **ctx.kw)
        else:
            grads = ref.flash_backward_ref(q, k, v, out, dout, **ctx.kw)
        return (*grads, None, None, None)


def flash_attention_fn(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    kv_len: Optional[int] = None,
) -> torch.Tensor:
    """:func:`flash_attention`, differentiable in q, k and v: on a CUDA
    tensor the forward kernel writes the row log-sum-exp and the backward
    is the hand-written ``flash_bwd`` kernel (either raises if it cannot
    build or launch); on a CPU tensor ``ref.flash_attention_ref`` and
    ``ref.flash_backward_ref``."""
    kv_len = _check_flash(q, k, v, window, kv_len)
    return _FlashFunction.apply(q, k, v, causal, window, kv_len)
