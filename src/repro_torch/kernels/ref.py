"""Plain PyTorch versions of the port's kernels (the correctness contracts).

Each function has the signature and output of its kernel wrapper in
``segment_view`` / ``moments`` / ``gram`` / ``segment_gram`` and computes
the same thing the direct way: materialize the extended blocks (or the
per-row outer products), then ``index_add_`` each per segment.
The ops layer runs them for CPU tensors; ``chip_smoke.py`` holds every
kernel against them on the card.  Sums accumulate in the inputs' dtype;
segment ids outside ``[0, num_groups)`` contribute nothing.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

__all__ = [
    "gram_ref",
    "moments_ref",
    "multi_segment_gram_ref",
    "segment_blocks_ref",
    "segment_gram_ref",
    "segment_view_ref",
]


def _segment_add(data: torch.Tensor, seg: torch.Tensor, num: int) -> torch.Tensor:
    seg = seg.long()
    keep = (seg >= 0) & (seg < num)
    if not bool(keep.all()):
        data, seg = data[keep], seg[keep]
    out = torch.zeros(
        (num,) + tuple(data.shape[1:]), dtype=data.dtype, device=data.device
    )
    return out.index_add_(0, seg, data)


def segment_view_ref(
    c: torch.Tensor,
    x: torch.Tensor,
    l: torch.Tensor,
    q: Optional[torch.Tensor],
    seg: torch.Tensor,
    num_groups: int,
    degree: int = 2,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Unfused extend-and-group: materialize the extended blocks, then
    scatter-add each per segment.  Returns ``(c' [G], l' [G, k+1],
    q' [G, k+1, k+1] | None)``."""
    l_ext = torch.cat([(x * c)[:, None], l], dim=1)
    c_new = _segment_add(c, seg, num_groups)
    l_new = _segment_add(l_ext, seg, num_groups)
    if degree != 2:
        return c_new, l_new, None
    xl = x[:, None] * l
    top = torch.cat([(x * x * c)[:, None, None], xl[:, None, :]], dim=2)
    bot = torch.cat([xl[:, :, None], q], dim=2)
    q_ext = torch.cat([top, bot], dim=1)
    return c_new, l_new, _segment_add(q_ext, seg, num_groups)


def segment_blocks_ref(
    c: torch.Tensor,
    l: Optional[torch.Tensor],
    q: Optional[torch.Tensor],
    seg: torch.Tensor,
    num_groups: int,
    degree: int = 2,
):
    """Per-block scatter-add: ``(Σc, Σl, Σq)`` per group, Nones past
    ``degree``."""
    c_new = _segment_add(c, seg, num_groups)
    l_new = _segment_add(l, seg, num_groups) if degree >= 1 else None
    q_new = _segment_add(q, seg, num_groups) if degree == 2 else None
    return c_new, l_new, q_new


def moments_ref(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """``(Σx, max|x|, count)`` in ``x``'s dtype (zeros for an empty x)."""
    if x.shape[0] == 0:
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        return zero, zero, 0
    return x.sum(), x.abs().max(), int(x.shape[0])


def gram_ref(x: torch.Tensor) -> torch.Tensor:
    """``XᵀX`` of an ``[M, K]`` matrix, ``[K, K]`` in ``x``'s dtype."""
    return x.T @ x


def segment_gram_ref(
    x: torch.Tensor, seg: torch.Tensor, num_groups: int
) -> torch.Tensor:
    """``out[g] = Σ_{seg[m]=g} x_m x_mᵀ``: ``[G, K, K]`` in ``x``'s dtype."""
    return _segment_add(x[:, :, None] * x[:, None, :], seg, num_groups)


def multi_segment_gram_ref(
    x: torch.Tensor, segs: torch.Tensor, num_groups: Sequence[int]
) -> List[torch.Tensor]:
    """One grouped Gram per column of ``segs [M, n_seg]``: a list of
    ``[G_i, K, K]``."""
    return [
        segment_gram_ref(x, segs[:, i], int(g)) for i, g in enumerate(num_groups)
    ]
