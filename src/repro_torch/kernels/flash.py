"""ctypes wrappers of the flash-attention kernels (``csrc/flash.cu``, and
its backward, ``csrc/flash_bwd.cu``).

:func:`flash_attention` runs online-softmax attention over the model's
``[B, S, H, D]`` layout through ``flash_attention_bf16`` (Hopper tensor
cores: ``wgmma`` on a TMA/mbarrier ring of K/V stages, warp-specialised)
or ``flash_attention_f32`` (scalar FMAs).  Replaces ``flash_kernel_call``
of ``repro/kernels/flash.py``.

The bf16 kernel's host-side geometry and schedule are mirrored here in
plain Python so that the CPU tests can hold them against a brute-force
count of visible (query, key) pairs: :func:`bf16_geometry` (the
instantiation per head dim), :func:`tensor_map` (the TMA maps),
:func:`block_order` (the block order), :func:`key_tiles` and
:func:`tile_interior` (which key tiles a block walks and which of them
need the mask).  :func:`kernel_bf16_geometry` asks the built library for
its own numbers; ``chip_smoke.py`` holds the two equal.

:func:`flash_backward` runs ``flash_backward_{bf16,f32}`` (a Δ pre-pass,
a dK/dV kernel and a dQ kernel, scalar float32 FMAs) from the forward's
row log-sum-exp, which :func:`flash_attention` returns when asked
(``with_lse``).  Replaces no TPU kernel: the reference differentiates its
jnp recurrence instead.

The functions take CUDA tensors only and raise on anything else; their
plain PyTorch versions are ``repro_torch.kernels.ref.flash_attention_ref``
and ``flash_backward_ref``, and ``ops.flash_attention`` /
``ops.flash_attention_fn`` check shapes, dtypes and head dims before
either.  Outputs and scratch are allocated here and the kernels run on the
current stream without synchronising.  ``launches`` counts the forward's
launches and the backward's (one a backward).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

__all__ = [
    "BF16_ROWS_PER_WARPGROUP",
    "bf16_geometry",
    "block_order",
    "flash_attention",
    "flash_backward",
    "kernel_bf16_geometry",
    "key_tiles",
    "launches",
    "padded_dim",
    "tensor_map",
    "tile_interior",
]

#: launches since the last reset (chip_smoke.py zeroes and reads); one
#: backward is one count of ``flash_bwd`` (its three kernels together)
launches = {"flash": 0, "flash_bwd": 0}

_P, _I32 = ctypes.c_void_p, ctypes.c_int
# (q, k, v, out, lse, b, sq, sk, h, kh, d, causal, window, kv_len, stream)
_ARGTYPES = [_P] * 5 + [_I32] * 9 + [_P]
# (q, k, v, o, dout, lse, delta, dq, dk, dv, b, sq, sk, h, kh, d, causal,
#  window, kv_len, stream)
_BWD_ARGTYPES = [_P] * 10 + [_I32] * 9 + [_P]
_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}

#: queries per bf16 consumer warpgroup (wgmma's M)
BF16_ROWS_PER_WARPGROUP = 64
_SMEM_PER_BLOCK = 232_448  # bytes a block can take on an H100
_GEOMETRY_KEYS = ("dp", "panel", "swizzle", "bq", "bk", "stages", "smem")


def padded_dim(d: int) -> int:
    """The instantiation width for head dim ``d``: the least of 16, 32, 64,
    128, 256 that holds it (``padded_dim`` in ``flash.cu``)."""
    for dp in (16, 32, 64, 128, 256):
        if d <= dp:
            return dp
    raise ValueError(f"flash: head dim {d} over 256")


def bf16_geometry(d: int) -> dict:
    """The bf16 instantiation for head dim ``d`` (``Bf16Geometry`` in
    ``flash.cu``): padded width ``dp``; shared-memory tiles in panels of
    ``panel`` columns whose rows are one ``swizzle`` span (bytes, the TMA
    swizzle mode and the wgmma layout); ``bq`` queries per block (two
    consumer warpgroups of 64), ``bk`` keys per tile, a ring of ``stages``
    K/V stages; ``smem`` dynamic shared-memory bytes (1 KiB of alignment
    slack, Q, the ring, the mbarriers)."""
    dp = padded_dim(d)
    bq = 2 * BF16_ROWS_PER_WARPGROUP
    panel = min(dp, 64)
    bk = 64 if dp >= 128 else 128
    stages = 2 if dp >= 128 else 3
    smem = 1024 + bq * dp * 2 + 2 * stages * bk * dp * 2 + (2 * stages + 1) * 8
    return dict(dp=dp, panel=panel, swizzle=panel * 2, bq=bq, bk=bk,
                stages=stages, smem=smem)


def tensor_map(batch: int, seq: int, heads: int, d: int, rows: int) -> dict:
    """The TMA map ``encode_map`` builds for a bf16 ``[batch, seq, heads,
    d]`` tensor: ``dims`` innermost first (d, heads, seq, batch),
    ``strides`` in bytes of dims 1–3, and the ``box`` one load copies
    (``panel`` columns, one head, ``rows`` rows, one batch).  Elements past
    ``d`` or ``seq`` load as 0."""
    panel = bf16_geometry(d)["panel"]
    return dict(
        dims=(d, heads, seq, batch),
        strides=(d * 2, heads * d * 2, seq * heads * d * 2),
        box=(panel, 1, rows, 1),
    )


def block_order(batch: int, sq: int, heads: int, bq: int) -> list:
    """(batch, first query, head) of the bf16 blocks in the order they
    start (block index order, x fastest: the grid is (batch·heads, query
    tiles) and a block's query tile counts from the end): every head of the
    last tile first, so the longest causal rows start first."""
    n = -(-sq // bq)
    return [(x // heads, (n - 1 - y) * bq, x % heads)
            for y in range(n) for x in range(batch * heads)]


def key_tiles(q0: int, bq: int, bk: int, *, sq: int, kv_len: int, causal: bool,
              window: Optional[int]) -> Tuple[int, int]:
    """Key tiles ``[first, last)`` that can hold a visible key for queries
    ``[q0, q0 + bq)`` (``key_tiles`` in ``flash.cu``)."""
    end = min(kv_len, q0 + bq, sq) if causal else kv_len
    begin = max(0, q0 - window + 1) if window else 0
    first = begin // bk
    return first, (-(-end // bk) if end > begin else first)


def tile_interior(r0: int, rows: int, k0: int, bk: int, *, kv_len: int,
                  causal: bool, window: Optional[int]) -> bool:
    """Every key of ``[k0, k0 + bk)`` visible to every query of ``[r0, r0 +
    rows)``: the tile skips the mask (``tile_interior`` in ``flash.cu``)."""
    return (k0 + bk <= kv_len and (not causal or k0 + bk - 1 <= r0)
            and (not window or k0 > r0 + rows - 1 - window))


def kernel_bf16_geometry(d: int) -> dict:
    """The built library's own bf16 instantiation for head dim ``d``
    (``flash_bf16_geometry``; builds the library on first use)."""
    fn = _build.function("flash", "flash_bf16_geometry", [_I32, _P])
    out = (ctypes.c_int * len(_GEOMETRY_KEYS))()
    err = fn(d, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"flash_bf16_geometry({d}) failed: cudaError_t {err}")
    return dict(zip(_GEOMETRY_KEYS, out))


def _operand(name: str, t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned (TMA, and the float32 kernel's
    16-byte loads, take no less) on ``like``'s device."""
    if not t.is_cuda or t.get_device() != like.get_device():
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
    with_lse: bool = False,
):
    """q ``[B, Sq, H, D]``, k / v ``[B, Sk, KH, D]`` bf16 or float32 CUDA
    tensors (shapes already checked by ``ops.flash_attention``) →
    ``[B, Sq, H, D]`` in q's dtype; with ``with_lse``, ``(out, lse)``, the
    row log-sum-exp float32 ``[B, H, Sq]`` (-inf for a row that sees no
    key) that :func:`flash_backward` takes."""
    if q.dtype not in _SUFFIX:
        raise ValueError(f"flash: unsupported dtype {q.dtype}")
    q = _operand("q", q, q)
    k, v = _operand("k", k, q), _operand("v", v, q)
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel() == 0:
        return (out, lse) if with_lse else out
    fn = _build.function("flash", f"flash_attention_{_SUFFIX[q.dtype]}", _ARGTYPES)
    stream = torch.cuda.current_stream(q.get_device()).cuda_stream
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        0 if lse is None else lse.data_ptr(),
        b, sq, sk, h, kh, d, int(causal), window or 0, kv_len, stream,
    )
    if err != 0:
        raise RuntimeError(f"flash launch failed: cudaError_t {err}")
    launches["flash"] += 1
    return (out, lse) if with_lse else out


def flash_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    dout: torch.Tensor,
    lse: torch.Tensor,
    *,
    causal: bool,
    window: Optional[int],
    kv_len: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dq, dk, dv of :func:`flash_attention` (``csrc/flash_bwd.cu``): the
    forward's inputs, its output ``out`` and row log-sum-exp ``lse``, and
    the output's gradient ``dout``, all CUDA tensors of one dtype (``lse``
    float32) → gradients in that dtype, shaped as q, k, v."""
    if q.dtype not in _SUFFIX:
        raise ValueError(f"flash backward: unsupported dtype {q.dtype}")
    q = _operand("q", q, q)
    k, v = _operand("k", k, q), _operand("v", v, q)
    out, dout = _operand("out", out, q), _operand("dout", dout.to(q.dtype), q)
    lse = _operand("lse", lse, q)
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if dq.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    fn = _build.function("flash_bwd", f"flash_backward_{_SUFFIX[q.dtype]}", _BWD_ARGTYPES)
    stream = torch.cuda.current_stream(q.get_device()).cuda_stream
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, sq, sk, h, kh, d, int(causal), window or 0, kv_len, stream,
    )
    if err != 0:
        raise RuntimeError(f"flash backward launch failed: cudaError_t {err}")
    launches["flash_bwd"] += 1
    return dq, dk, dv
