"""Grouped-query attention with KV caching (full, sliding-window, cross).

PyTorch port of the JAX package's ``models/attention.py``:

* GQA / MQA: queries are reshaped to ``[B, S, KH, G, D]`` so keys/values
  are never materialized per query head (G = n_heads / n_kv_heads).
* Sliding-window attention (mixtral): banded mask in prefill; a
  **ring-buffer KV cache of size window** in decode.  Absolute positions are
  stored next to the ring so masking needs no modular arithmetic.
* Cross attention (whisper's decoder): keys / values projected from the
  encoder states (``kv_states``), no RoPE, every key visible; the decode
  path projects them once (:func:`cross_kv`, cached at prefill) and
  attends over them (:func:`cross_attention_decode`).
* Long sequences (more than ``CHUNKED_THRESHOLD`` queries or keys) take
  the online-softmax path: on a CUDA tensor the hand-written flash kernel
  (``ops.flash_attention``, which derives positions from indices, as the
  TPU kernel does), on a CPU tensor its plain version here,
  :func:`chunked_attention`, with query positions and key positions of
  their own lengths.  The model's positions are always ``arange``, so the
  port's functions take ``positions=None`` to mean exactly that; an
  explicit ``positions`` on a CUDA tensor in that branch raises rather
  than leave the kernel.  Where autograd records the call (training over
  more than 2,048 tokens), the branch takes ``ops.flash_attention_fn``:
  the forward kernel with its row log-sum-exp and the hand-written
  backward kernel on the card, their plain versions on the CPU (the
  reference differentiates its chunked recurrence under ``jax.checkpoint``
  instead; both give the same gradient).

Scores and softmax run in float32 whatever the activation dtype (bf16
inputs are upcast: their products are exact in float32, so this is the
reference's ``preferred_element_type=float32``).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
from torch import nn

from ..kernels import ops
from ..sharding import constrain, is_dtensor, on_head_shards
from .layers import apply_rotary, dense_init, rotary_embedding

__all__ = [
    "Attention",
    "CHUNKED_THRESHOLD",
    "attention_apply",
    "attention_decode",
    "attention_init",
    "attention_prefill",
    "chunked_attention",
    "cross_attention",
    "cross_attention_decode",
    "cross_kv",
    "init_kv_cache",
]

NEG_INF = -1e30

#: Above this many score entries per (q, kv) pair the chunked path kicks in.
CHUNKED_THRESHOLD = 2048
DEFAULT_Q_CHUNK = 512
DEFAULT_K_CHUNK = 1024


class Attention(nn.Module):
    """Projection weights with explicit head axes, as the reference keeps
    them: ``wq [d, H, hd]``, ``wk`` / ``wv [d, KH, hd]``, ``wo [H, hd, d]``."""

    def __init__(self, cfg, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        d, h, kh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        dt = cfg.param_dtype
        self.wq = dense_init(d, (h, hd), dt, generator, device=device)
        self.wk = dense_init(d, (kh, hd), dt, generator, device=device)
        self.wv = dense_init(d, (kh, hd), dt, generator, device=device)
        wo = dense_init(h * hd, d, dt, generator, device=device)
        self.wo = nn.Parameter(wo.data.reshape(h, hd, d), requires_grad=False)


def attention_init(cfg, generator: Optional[torch.Generator] = None, device=None):
    return Attention(cfg, generator, device)


def _gathered(w: torch.Tensor, heads: str) -> torch.Tensor:
    """A ``[d, heads, hd]`` projection whole along ``d`` (FSDP's gather
    before use) and split over its heads as the policy says.  Under a
    policy whose model axis does not divide the heads (smollm's 9 on 16),
    DTensor would otherwise split the flattened heads of the product and
    could not unflatten them.  No-op without a policy."""
    return constrain(w, (None, heads, "head_dim"))


def _project(params: Attention, x: torch.Tensor):
    """q ``[B, S, H, hd]``, k / v ``[B, S, KH, hd]``."""
    q = torch.einsum("bsd,dhe->bshe", x, _gathered(params.wq, "heads"))
    k = torch.einsum("bsd,dke->bske", x, _gathered(params.wk, "kv_heads"))
    v = torch.einsum("bsd,dke->bske", x, _gathered(params.wv, "kv_heads"))
    return q, k, v


def _out(params: Attention, o: torch.Tensor) -> torch.Tensor:
    """``o [B, S, H, hd]`` through ``wo [H, hd, d]``: one product over the
    (head, head_dim) pairs, flattened head first, so that a DTensor whose
    heads are sharded flattens them as it can (an einsum would put them
    second)."""
    b, s, h, e = o.shape
    wo = constrain(params.wo, ("heads", "head_dim", None))  # gathered along d
    return o.reshape(b, s, h * e) @ wo.reshape(h * e, wo.shape[-1])


def _arange_positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)[None].expand(b, s)


def _gqa_scores(q, k, scale):
    """q [B,Sq,H,D], k [B,Sk,KH,D] -> float32 scores [B,KH,G,Sq,Sk]."""
    b, sq, h, d = q.shape
    kh = k.shape[2]
    qg = q.reshape(b, sq, kh, h // kh, d)
    return torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale


def _gqa_out(probs, v, out_dtype):
    """probs [B,KH,G,Sq,Sk], v [B,Sk,KH,D] -> [B,Sq,H,D]."""
    b, kh, g, sq, _ = probs.shape
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(v.dtype).float(), v.float())
    return out.reshape(b, sq, kh * g, v.shape[-1]).to(out_dtype)


def _masked_softmax(scores, mask):
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    # rows with no visible key (fully masked) produce uniform garbage; zero them
    return torch.where(mask.any(dim=-1, keepdim=True), probs, 0.0)


def _dense(q, k, v, qpos, kpos, *, causal: bool, window: Optional[int], out_dtype):
    if is_dtensor(q):
        # per (batch, head) work on each rank's shards, as flash runs (DTensor
        # cannot flatten batch with sharded heads in these products)
        return on_head_shards(
            functools.partial(_dense, causal=causal, window=window, out_dtype=out_dtype),
            q, k, v, qpos, kpos)
    scores = _gqa_scores(q, k, q.shape[-1] ** -0.5)
    qp = qpos[:, None, None, :, None]
    kp = kpos[:, None, None, None, :]
    mask = kp <= qp if causal else torch.ones_like(scores, dtype=torch.bool)
    if window is not None:
        mask = mask & (kp > qp - window)
    return _gqa_out(_masked_softmax(scores, mask), v, out_dtype)


def _all_keys(q, k, v, *, out_dtype):
    """Dense attention with every key visible (cross attention); on each
    rank's shards for DTensors, as :func:`_dense`."""
    if is_dtensor(q):
        return on_head_shards(functools.partial(_all_keys, out_dtype=out_dtype), q, k, v)
    probs = torch.softmax(_gqa_scores(q, k, q.shape[-1] ** -0.5), dim=-1)
    return _gqa_out(probs, v, out_dtype)


# ---------------------------------------------------------------------------
# Chunked online-softmax attention (the flash recurrence in plain torch)
# ---------------------------------------------------------------------------

def chunked_attention(
    q,
    k,
    v,
    qpos,
    kpos,
    *,
    causal: bool,
    window: Optional[int],
    out_dtype,
    q_chunk: int = DEFAULT_Q_CHUNK,
    k_chunk: int = DEFAULT_K_CHUNK,
):
    """Online-softmax attention: q [B,Sq,H,D], k/v [B,Sk,KH,D],
    qpos [B,Sq], kpos [B,Sk] absolute positions (−1 = empty slot).

    Memory O(q_chunk·k_chunk) instead of O(Sq·Sk).  Returns [B,Sq,H,D].
    This is the plain version of the flash kernel on the model's path.  The
    last chunk of each axis may be short (the reference, whose scans need
    equal chunks, takes the largest divisor instead; the chunking changes
    only the order of float32 sums)."""
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    g = h // kh
    scale = d**-0.5
    qg = q.reshape(b, sq, kh, g, d)
    out = []
    for i in range(0, sq, q_chunk):
        q_blk = qg[:, i : i + q_chunk].float()
        qc = q_blk.shape[1]
        qpx = qpos[:, i : i + q_chunk][:, None, None, :, None]
        m = torch.full((b, kh, g, qc), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, kh, g, qc), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, kh, g, qc, d), dtype=torch.float32, device=q.device)
        for j in range(0, sk, k_chunk):
            k_blk, v_blk = k[:, j : j + k_chunk], v[:, j : j + k_chunk]
            s = torch.einsum("bqkgd,bskd->bkgqs", q_blk, k_blk.float()) * scale
            kpx = kpos[:, j : j + k_chunk][:, None, None, None, :]
            mask = kpx >= 0  # skip empty slots
            if causal:
                mask = mask & (kpx <= qpx)
            if window is not None:
                mask = mask & (kpx > qpx - window)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            # exp(NEG_INF - NEG_INF) = 1 would corrupt fully-masked rows;
            # re-apply the mask to the probabilities instead of clamping m.
            p = torch.exp(s - m_new[..., None]) * mask
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqs,bskd->bkgqd", p.to(v.dtype).float(), v_blk.float()
            )
            m = m_new
        o = acc / torch.clamp(l, min=1e-30)[..., None]  # [B,KH,G,qc,D]
        out.append(o.permute(0, 3, 1, 2, 4).reshape(b, qc, h, d))
    return torch.cat(out, dim=1).to(out_dtype)


def _long_attention(
    q, k, v, qpos, kpos, *, causal: bool, window: Optional[int], out_dtype,
    k_chunk: int = DEFAULT_K_CHUNK,
):
    """The chunked branch: the flash kernel on a CUDA tensor (positions are
    the indices), :func:`chunked_attention` on a CPU tensor, with query
    positions ``qpos [B, Sq]`` and key positions ``kpos [B, Sk]`` (None:
    arange of each length).  A call that autograd records takes
    ``ops.flash_attention_fn`` on either device: on the card the forward
    kernel and the hand-written backward, on the CPU their plain versions
    (positions are the indices there too).  DTensors take the kernels on
    each rank's batch and head shards (``sharding.on_head_shards``).  A
    DTensor or a ``meta`` tensor takes them outside autograd too (the plain
    versions off the card: the dry run counts attention as they compute
    it, sharded or not)."""
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad)
    if q.is_cuda or grad or is_dtensor(q) or q.is_meta:
        if qpos is not None or kpos is not None:
            raise ValueError(
                "the flash kernel derives positions from indices: pass "
                "positions=None (arange) on a CUDA tensor or under autograd"
            )
        flash = functools.partial(ops.flash_attention_fn if grad else ops.flash_attention,
                                  causal=causal, window=window, kv_len=k.shape[1])
        if is_dtensor(q):
            # the kernels on each rank's batch and head shards, as _dense
            return on_head_shards(flash, q, k, v).to(out_dtype)
        return flash(q, k, v).to(out_dtype)
    b = q.shape[0]
    if qpos is None:
        qpos = _arange_positions(b, q.shape[1], q.device)
    if kpos is None:
        kpos = _arange_positions(b, k.shape[1], q.device)
    return chunked_attention(
        q, k, v, qpos, kpos,
        causal=causal, window=window, out_dtype=out_dtype, k_chunk=k_chunk,
    )


def _rope(q, k, positions, cfg):
    if cfg.pos != "rope":
        return q, k
    cos, sin = rotary_embedding(positions, cfg.head_dim, cfg.rope_theta)
    return apply_rotary(q, cos, sin), apply_rotary(k, cos, sin)


def _long(s: int, sk: int, cfg) -> bool:
    """Whether attention of ``s`` queries over ``sk`` keys takes the chunked
    branch (the flash kernel on the card)."""
    return max(s, sk) > CHUNKED_THRESHOLD and not cfg.dense_attention


def cross_attention(params: Attention, x: torch.Tensor, ckv: dict, cfg) -> torch.Tensor:
    """Cross attention of ``x [B, S, d]`` over projected encoder keys and
    values ``ckv`` (:func:`cross_kv`): no RoPE, every key visible (the
    chunked branch keeps the whole key sequence in one chunk, as the
    reference does)."""
    q = torch.einsum("bsd,dhe->bshe", x, _gathered(params.wq, "heads"))
    k, v = ckv["k"], ckv["v"]
    sk = k.shape[1]
    if _long(x.shape[1], sk, cfg):
        out = _long_attention(
            q, k, v, None, None, causal=False, window=None, out_dtype=x.dtype, k_chunk=sk
        )
    else:
        out = _all_keys(q, k, v, out_dtype=x.dtype)
    return _out(params, out)


def attention_apply(
    params: Attention,
    x: torch.Tensor,
    cfg,
    *,
    positions: Optional[torch.Tensor] = None,
    causal: bool = True,
    window: Optional[int] = None,
    kv_states: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Self (or cross, via ``kv_states [B, Sk, d]``) attention over full
    sequences: x [B, S, d]; ``positions`` [B, S] absolute positions for RoPE
    and masking (None: arange).  Cross attention takes K / V from
    ``kv_states``, skips RoPE and sees every key (``positions``, ``causal``
    and ``window`` do not apply).  Returns [B, S, d]."""
    if kv_states is not None:
        return cross_attention(params, x, cross_kv(params, kv_states), cfg)
    b, s, _ = x.shape
    q, k, v = _project(params, x)
    pos = _arange_positions(b, s, x.device) if positions is None else positions
    q, k = _rope(q, k, pos, cfg)
    if _long(s, s, cfg):
        out = _long_attention(
            q, k, v, positions, positions, causal=causal, window=window, out_dtype=x.dtype
        )
    else:
        out = _dense(q, k, v, pos, pos, causal=causal, window=window, out_dtype=x.dtype)
    return _out(params, out)


def attention_prefill(
    params: Attention,
    x: torch.Tensor,
    cfg,
    max_len: int,
    *,
    positions: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
):
    """Full causal self-attention that also emits the decode cache.

    Full attention: K/V land in slots [0, S) of a ``max_len`` cache.
    Sliding window: only the last ``window`` positions are retained, rolled
    so that slot p%W holds position p — exactly the decode ring layout.
    """
    b, s, _ = x.shape
    q, k, v = _project(params, x)
    pos = _arange_positions(b, s, x.device) if positions is None else positions
    q, k = _rope(q, k, pos, cfg)
    if _long(s, s, cfg):
        out = _long_attention(
            q, k, v, positions, positions, causal=True, window=window, out_dtype=x.dtype
        )
    else:
        out = _dense(q, k, v, pos, pos, causal=True, window=window, out_dtype=x.dtype)
    out = _out(params, out)

    slots = max_len if window is None else min(window, max_len)
    kh, hd = cfg.n_kv_heads, cfg.head_dim
    k, v = k.to(cfg.dtype), v.to(cfg.dtype)
    if slots >= s:  # positions [0, s), then empty slots (a DTensor cannot
        # be written into a slice of a plain tensor)
        empty = torch.zeros((b, slots - s, kh, hd), dtype=cfg.dtype, device=x.device)
        ck = torch.cat([k, empty], dim=1)
        cv = torch.cat([v, empty], dim=1)
        cpos = torch.cat([pos.to(torch.int32), torch.full(
            (b, slots - s), -1, dtype=torch.int32, device=x.device)], dim=1)
    else:  # keep the last ``slots`` positions, ring-rolled to slot p%slots
        shift = (s - slots) % slots
        ck = torch.roll(k[:, s - slots :], shift, dims=1)
        cv = torch.roll(v[:, s - slots :], shift, dims=1)
        cpos = torch.roll(pos[:, s - slots :], shift, dims=1).to(torch.int32)
    return out, {"k": ck, "v": cv, "pos": cpos}


# ---------------------------------------------------------------------------
# KV cache (decode path)
# ---------------------------------------------------------------------------

def init_kv_cache(cfg, batch: int, max_len: int, window: Optional[int] = None, device=None):
    """Cache of one attention layer.  Full attention: slots = max_len.
    Sliding window: ring of ``window`` slots.  ``pos`` stores each slot's
    absolute position (-1 = empty)."""
    slots = max_len if window is None else min(window, max_len)
    kh, hd = cfg.n_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((batch, slots, kh, hd), dtype=cfg.dtype, device=device),
        "v": torch.zeros((batch, slots, kh, hd), dtype=cfg.dtype, device=device),
        "pos": torch.full((batch, slots), -1, dtype=torch.int32, device=device),
    }


def decode_into(
    params: Attention,
    x: torch.Tensor,
    cache: dict,
    cur_pos: int,
    cfg,
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """:func:`attention_decode` writing the new K/V into ``cache`` in place
    (the model's decode step copies its cache once, then calls this per
    layer); a DTensor cache gets new tensors in the dict instead.  Returns
    the attention output [B, 1, d]."""
    b = x.shape[0]
    q, k_new, v_new = _project(params, x)
    pos_b = torch.full((b, 1), cur_pos, dtype=torch.int32, device=x.device)
    q, k_new = _rope(q, k_new, pos_b, cfg)

    k, v, pos = cache["k"], cache["v"], cache["pos"]
    slot = cur_pos % k.shape[1]
    if is_dtensor(k):
        # a DTensor's slot write on the sequence dim (split over model)
        # would gather the cache: select the new entry instead, and put the
        # new tensors in ``cache``
        hit = torch.arange(k.shape[1], device=x.device) == slot
        cache["k"] = k = torch.where(hit[None, :, None, None], k_new.to(k.dtype), k)
        cache["v"] = v = torch.where(hit[None, :, None, None], v_new.to(v.dtype), v)
        cache["pos"] = pos = torch.where(hit[None, :], cur_pos, pos)
    else:
        k[:, slot] = k_new[:, 0].to(k.dtype)
        v[:, slot] = v_new[:, 0].to(v.dtype)
        pos[:, slot] = cur_pos

    scores = _gqa_scores(q, k, cfg.head_dim**-0.5)  # [B,KH,G,1,slots]
    kpos = pos[:, None, None, None, :]
    mask = (kpos >= 0) & (kpos <= cur_pos)
    if window is not None:
        mask = mask & (kpos > cur_pos - window)
    out = _gqa_out(_masked_softmax(scores, mask), v, x.dtype)
    return _out(params, out)


def attention_decode(
    params: Attention,
    x: torch.Tensor,
    cache: dict,
    cur_pos: int,
    cfg,
    *,
    window: Optional[int] = None,
) -> Tuple[torch.Tensor, dict]:
    """One decode step: x [B, 1, d], ``cur_pos`` an int (same for all rows).

    Writes the new KV at slot ``cur_pos % slots`` of a copy of ``cache`` and
    attends over every non-empty slot whose absolute position is visible.
    Returns (out, new cache); ``cache`` is left as it was."""
    new = {name: t.clone() for name, t in cache.items()}
    return decode_into(params, x, new, cur_pos, cfg, window=window), new


# ---------------------------------------------------------------------------
# Cross-attention decode against a precomputed (cached) encoder KV
# ---------------------------------------------------------------------------

def cross_kv(params: Attention, enc_states: torch.Tensor) -> dict:
    """Encoder K / V ``[B, Sk, KH, hd]``, projected once (whisper's prefill
    caches them)."""
    return {
        "k": torch.einsum("bsd,dke->bske", enc_states, _gathered(params.wk, "kv_heads")),
        "v": torch.einsum("bsd,dke->bske", enc_states, _gathered(params.wv, "kv_heads")),
    }


def cross_attention_decode(params: Attention, x: torch.Tensor, ckv: dict, cfg) -> torch.Tensor:
    """x [B, 1, d] attends over the cached encoder K / V ``ckv`` (no mask,
    float32 scores).  Returns [B, 1, d]."""
    q = torch.einsum("bsd,dhe->bshe", x, _gathered(params.wq, "heads"))
    probs = torch.softmax(_gqa_scores(q, ckv["k"], cfg.head_dim**-0.5), dim=-1)
    return _out(params, _gqa_out(probs, ckv["v"], x.dtype))
