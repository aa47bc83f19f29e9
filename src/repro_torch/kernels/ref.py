"""Plain PyTorch versions of the port's kernels (the correctness contracts).

Each function has the signature and output of its kernel wrapper in
``segment_view`` / ``moments`` / ``gram`` / ``segment_gram`` / ``flash``
and computes the same thing the direct way: materialize the extended
blocks (or the per-row outer products), then ``index_add_`` each per
segment; attention forms the whole score matrix and takes one softmax,
and its backward differentiates that dense softmax with the kernel's
formulas.
The ops layer runs them for CPU tensors; ``chip_smoke.py`` holds every
kernel against them on the card.  Sums accumulate in the inputs' dtype
(attention: in float32); segment ids outside ``[0, num_groups)``
contribute nothing.  ``order`` is the caller's statement that every group
has exactly one row, and lists it: the kernels' path A relies on it, and
the plain versions check it and raise ``ValueError`` when it is false.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

__all__ = [
    "flash_attention_ref",
    "flash_backward_ref",
    "flash_ref",
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


def _check_order(seg: torch.Tensor, num_groups: int,
                 order: Optional[torch.Tensor]) -> None:
    """Raise ``ValueError`` unless ``order``, where given, lists each
    group's one row: ``num_groups`` ids and ``seg[order[g]] == g`` for every
    group ``g`` (so ``order`` and ``seg`` are inverse permutations)."""
    if order is None:
        return
    n = int(num_groups)
    if not (
        seg.shape == order.shape == (n,)
        and bool(((order >= 0) & (order < n)).all())
        and torch.equal(seg[order.long()].long(), torch.arange(n, device=seg.device))
    ):
        raise ValueError(
            f"order does not list one row per group: {seg.shape[0]} ids in {n} "
            "groups must be a permutation whose inverse is order"
        )


def segment_view_ref(
    c: torch.Tensor,
    x: torch.Tensor,
    l: torch.Tensor,
    q: Optional[torch.Tensor],
    seg: torch.Tensor,
    num_groups: int,
    degree: int = 2,
    order: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Unfused extend-and-group: materialize the extended blocks, then
    scatter-add each per segment.  Returns ``(c' [G], l' [G, k+1],
    q' [G, k+1, k+1] | None)``."""
    _check_order(seg, num_groups, order)
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
    order: Optional[torch.Tensor] = None,
):
    """Per-block scatter-add: ``(Σc, Σl, Σq)`` per group, Nones past
    ``degree``."""
    _check_order(seg, num_groups, order)
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


def flash_ref(q, k, v, *, causal=True, window=None, kv_len=None):
    """Dense softmax attention oracle: q ``[BH, Sq, D]``, k/v ``[BH, Sk, D]``.

    Scores in float32 (bf16 products are exact in float32), positions are
    the indices, fully masked rows give 0, and the probabilities are rounded
    to v's dtype before the float32 product with v.  Returns q's dtype."""
    sq, d = q.shape[1], q.shape[2]
    sk = k.shape[1]
    kv_len = sk if kv_len is None else kv_len
    s = torch.einsum("hqd,hkd->hqk", q.float(), k.float()) * (d**-0.5)
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = kpos < kv_len
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    s = torch.where(mask[None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask.any(-1, keepdim=True)[None], p, 0.0)
    out = torch.einsum("hqk,hkd->hqd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def flash_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool,
    window: Optional[int],
    kv_len: int,
) -> torch.Tensor:
    """:func:`flash_ref` on the model's layout: q ``[B, Sq, H, D]``, k/v
    ``[B, Sk, KH, D]`` (KV heads repeated for GQA) → ``[B, Sq, H, D]``."""
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    g = h // kh
    k = k.repeat_interleave(g, dim=2)
    v = v.repeat_interleave(g, dim=2)
    qf = q.transpose(1, 2).reshape(b * h, sq, d)
    kf = k.transpose(1, 2).reshape(b * h, sk, d)
    vf = v.transpose(1, 2).reshape(b * h, sk, d)
    out = flash_ref(qf, kf, vf, causal=causal, window=window, kv_len=kv_len)
    return out.reshape(b, h, sq, d).transpose(1, 2)


def flash_backward_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    dout: torch.Tensor,
    *,
    causal: bool,
    window: Optional[int],
    kv_len: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dq, dk, dv of :func:`flash_attention_ref` on the model's layout, as
    ``flash.flash_backward`` computes them: the dense masked softmax P
    recomputed in float32, ``Δ = rowsum(dO ∘ out)``, ``dV = Pᵀ dO``,
    ``dS = P ∘ (dO Vᵀ − Δ)``, ``dK = dSᵀ Q · D^-1/2`` (summed over each KV
    head's G query heads), ``dQ = dS K · D^-1/2``; a row that sees no key
    has P = 0, so zero gradients.  One KV head's group at a time; the
    gradients in the inputs' dtype."""
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    g = h // kh
    scale = d**-0.5
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = kpos < kv_len
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(v.shape, dtype=torch.float32, device=q.device)
    for j in range(kh):
        heads = slice(j * g, (j + 1) * g)
        qf = q[:, :, heads].float().transpose(1, 2)  # [B, G, Sq, D]
        of = out[:, :, heads].float().transpose(1, 2)
        gf = dout[:, :, heads].float().transpose(1, 2)
        kf = k[:, :, j].float()[:, None]  # [B, 1, Sk, D]
        vf = v[:, :, j].float()[:, None]
        s = torch.where(mask, qf @ kf.transpose(-1, -2) * scale, -torch.inf)
        lse = torch.logsumexp(s, dim=-1, keepdim=True)  # -inf: no visible key
        p = torch.where(mask & (lse > -torch.inf), torch.exp(s - lse), 0.0)
        delta = (gf * of).sum(-1, keepdim=True)
        ds = p * (gf @ vf.transpose(-1, -2) - delta)
        dq[:, :, heads] = (ds @ kf * scale).transpose(1, 2)
        dk[:, :, j] = (ds.transpose(-1, -2) @ qf).sum(1) * scale
        dv[:, :, j] = (p.transpose(-1, -2) @ gf).sum(1)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
