"""ctypes wrappers of the flash-attention kernels (``csrc/flash.cu``, and
its backward, ``csrc/flash_bwd.cu``).

:func:`flash_attention` runs online-softmax attention over the model's
``[B, S, H, D]`` layout through ``flash_attention_bf16`` (Hopper tensor
cores: ``wgmma`` on a TMA/mbarrier ring of K/V stages, warp-specialised)
or ``flash_attention_f32`` (at head dims up to 128 the same shape on
3xTF32 ``wgmma``: a pre-pass splits Q and K into TF32 hi and lo planes and
V into transposed ones, in a workspace allocated here; at head dim 256
scalar FMAs).  Replaces ``flash_kernel_call`` of
``repro/kernels/flash.py``.

The kernels' host-side geometry and schedule are mirrored here in plain
Python so that the CPU tests can hold them against a brute-force count of
visible (query, key) pairs: :func:`bf16_geometry` and :func:`f32_geometry`
(the instantiation per head dim), :func:`fwd_f32_planes` (the float32
workspace's layout), :func:`tensor_map` (the bf16 TMA maps),
:func:`block_order` (the block order), :func:`key_tiles` and
:func:`tile_interior` (which key tiles a block walks and which of them
need the mask), :func:`tf32_key_order` (the keys' order in a transposed
3xTF32 plane).  :func:`kernel_bf16_geometry`, :func:`kernel_f32_geometry`
and :func:`kernel_fwd_f32_workspace` ask the built library for its own
numbers; ``chip_smoke.py`` holds the two equal.

:func:`flash_backward` runs ``flash_backward_{bf16,f32}`` from the
forward's row log-sum-exp, which :func:`flash_attention` returns when
asked (``with_lse``): in bf16 at head dims up to 128 a pre-pass, one
``wgmma`` kernel on TMA-fed stages a block per (batch, head, 128 keys)
that adds dQ into a float32 accumulator with atomics, and a finish pass; in
float32 at head dims up to 128 the 3xTF32 path (a pre-pass that splits Q,
dO, K, V into TF32 hi and lo planes, natural and, for the three operands
that contract over the sequence, transposed; a dK/dV kernel a block per
(batch, KV head, 64 keys) and a dQ kernel a block per (batch, head, 64
queries), each a warpgroup on ``wgmma`` from TMA-fed tiles); at head dim
256 the scalar kernels (a Δ pre-pass, a dK/dV kernel and a dQ kernel).
Replaces no TPU kernel: the reference differentiates its jnp recurrence
instead.  Its geometry and schedule are mirrored too: :func:`bwd_geometry`
(per dtype), :func:`bwd_workspace` and :func:`tf32_planes` (the float32
workspace's layout), :func:`bwd_block_order`, :func:`query_tiles` (which
query tiles a block walks) and, for a (64 keys x 64 queries) tile,
:func:`tile_interior`; ``kernel_bwd_geometry`` and ``kernel_bwd_workspace``
ask the library (``flash_bwd_geometry``, ``flash_bwd_f32_geometry``,
``flash_bwd_workspace``).

The functions take CUDA tensors only and raise on anything else; their
plain PyTorch versions are ``repro_torch.kernels.ref.flash_attention_ref``
and ``flash_backward_ref``, and ``ops.flash_attention`` /
``ops.flash_attention_fn`` check shapes, dtypes and head dims before
either.  Outputs and scratch are allocated here and the kernels run on the
current stream without synchronising.  ``launches`` counts the forward's
launches and the backward's (one a call, its pre-passes included), and
under ``flash_f32`` the float32 forward's share of ``flash``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

__all__ = [
    "BF16_ROWS_PER_WARPGROUP",
    "BWD_F32_ROWS",
    "BWD_KEYS_PER_WARPGROUP",
    "bf16_geometry",
    "block_order",
    "bwd_block_order",
    "bwd_geometry",
    "bwd_workspace",
    "f32_geometry",
    "flash_attention",
    "flash_backward",
    "fwd_f32_planes",
    "fwd_f32_workspace",
    "kernel_bf16_geometry",
    "kernel_bwd_geometry",
    "kernel_bwd_workspace",
    "kernel_f32_geometry",
    "kernel_fwd_f32_workspace",
    "key_tiles",
    "launches",
    "padded_dim",
    "query_tiles",
    "tensor_map",
    "tf32_key_order",
    "tf32_planes",
    "tile_interior",
]

#: launches since the last reset (chip_smoke.py zeroes and reads); one
#: backward is one count of ``flash_bwd`` (its three launches together);
#: ``flash_f32`` counts the float32 forwards among ``flash``'s
launches = {"flash": 0, "flash_bwd": 0, "flash_f32": 0}

_P, _I32 = ctypes.c_void_p, ctypes.c_int
# (q, k, v, out, lse, b, sq, sk, h, kh, d, causal, window, kv_len, stream);
# float32 takes its workspace after lse
_ARGTYPES = {torch.bfloat16: [_P] * 5 + [_I32] * 9 + [_P],
             torch.float32: [_P] * 6 + [_I32] * 9 + [_P]}
# (q, k, v, o, dout, lse, work, dq, dk, dv, b, sq, sk, h, kh, d, causal,
#  window, kv_len, stream)
_BWD_ARGTYPES = [_P] * 10 + [_I32] * 9 + [_P]
_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}

#: queries per bf16 consumer warpgroup (wgmma's M)
BF16_ROWS_PER_WARPGROUP = 64
_SMEM_PER_BLOCK = 232_448  # bytes a block can take on an H100
_GEOMETRY_KEYS = ("dp", "panel", "swizzle", "bq", "bk", "stages", "smem")
_F32_GEOMETRY_KEYS = ("dp", "panel", "swizzle", "bq", "bk", "smem", "wgmma")
# the scalar float32 forward (head dim 256): queries a block, keys a tile
_SCALAR_FWD_BQ, _SCALAR_FWD_BK = 64, 32
#: keys per warpgroup of the bf16 backward (wgmma's M); a block holds two
#: warpgroups' keys
BWD_KEYS_PER_WARPGROUP = 64
_BWD_GEOMETRY_KEYS = ("dp", "panel", "swizzle", "bk", "bq", "stages", "smem", "wgmma")
_BWD_F32_GEOMETRY_KEYS = ("dp", "panel", "swizzle", "bq", "bk", "smem_dkdv", "smem_dq",
                          "wgmma")
#: keys of a float32 dK/dV block and queries of a float32 dQ block (one
#: warpgroup, wgmma's M)
BWD_F32_ROWS = 64
# the scalar backward's tiles (float32, and bf16 at head dim 256)
_SCALAR_BQ = _SCALAR_BK = 32


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


def f32_geometry(d: int) -> dict:
    """The float32 forward's instantiation for head dim ``d``
    (``Tf32FwdGeometry`` in ``flash.cu``): at ``dp`` ≤ 128 the 3xTF32
    kernel (``wgmma`` 1), the bf16 kernel's block shape (``bq`` 128 queries,
    two consumer warpgroups of 64) with natural tiles in panels of ``panel``
    float32 columns, one ``swizzle`` span wide, key tiles of ``bk`` keys (K
    hi and lo, Vᵀ hi and lo in panels of ``min(bk, 32)`` keys), ``smem``
    dynamic shared-memory bytes (1 KiB of alignment slack, both warpgroups'
    Q hi and lo, the K and Vᵀ tiles, a full and an empty mbarrier for each,
    one for Q); at ``dp`` 256 the scalar kernel (``wgmma`` 0: 64 queries a
    block, 32-key tiles)."""
    dp = padded_dim(d)
    if dp == 256:
        smem = ((_SCALAR_FWD_BQ + 2 * _SCALAR_FWD_BK) * (dp + 4)
                + _SCALAR_FWD_BQ * (_SCALAR_FWD_BK + 1)) * 4
        return dict(dp=dp, panel=0, swizzle=0, bq=_SCALAR_FWD_BQ, bk=_SCALAR_FWD_BK,
                    smem=smem, wgmma=0)
    panel = min(dp, 32)
    bq = 2 * BF16_ROWS_PER_WARPGROUP
    # at dp 128 the resident Q of 128 queries, hi and lo, takes 128 KiB
    bk = 32 if dp >= 128 else 64
    q_tile, k_tile = BF16_ROWS_PER_WARPGROUP * dp * 4, bk * dp * 4
    smem = 1024 + 4 * q_tile + 4 * k_tile + 5 * 8
    return dict(dp=dp, panel=panel, swizzle=panel * 4, bq=bq, bk=bk, smem=smem, wgmma=1)


def fwd_f32_planes(b: int, sq: int, sk: int, h: int, kh: int, d: int) -> dict:
    """The float32 forward's workspace layout at head dims up to 128
    (``FwdPlanes`` in ``flash.cu``): ``{name: (offset, floats)}`` of each
    3xTF32 plane, hi and lo, in order: Q and K natural ``[B·heads, S, d]``
    (``qn``, ``kn``), V transposed ``[B·KH, d, S8]`` (``vt``; S8 is Sk
    rounded up to 8, the keys permuted within each 8)."""
    parts = []
    for name, n in (("qn", b * h * sq * d), ("kn", b * kh * sk * d),
                    ("vt", b * kh * d * _round8(sk))):
        parts += [(f"{name}_hi", n), (f"{name}_lo", n)]
    out, at = {}, 0
    for name, n in parts:
        out[name] = (at, n)
        at += n
    return out


def tf32_key_order(s8: int) -> list:
    """The key (sequence position) each position of a transposed 3xTF32
    plane of ``s8`` positions holds (``split_planes`` in ``hopper.cuh``):
    within each 8, position ``8u + k`` holds key ``8u + 2k`` for k < 4 and
    ``8u + 2k - 7`` for k ≥ 4, the order in which a thread's accumulator
    columns (2t4, 2t4 + 1) enter a TF32 A fragment as k = t4 and t4 + 4."""
    return [pos - pos % 8 + (2 * (pos % 8) if pos % 8 < 4 else 2 * (pos % 8) - 7)
            for pos in range(s8)]


def fwd_f32_workspace(b: int, sq: int, sk: int, h: int, kh: int, d: int) -> int:
    """Floats of the workspace the float32 forward takes
    (``flash_f32_workspace``): the planes of :func:`fwd_f32_planes` at head
    dims up to 128, none at 256."""
    if padded_dim(d) == 256:
        return 0
    return sum(n for _, n in fwd_f32_planes(b, sq, sk, h, kh, d).values())


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


def bwd_geometry(d: int, dtype: torch.dtype = torch.bfloat16) -> dict:
    """The backward's instantiation for head dim ``d`` in ``dtype``.

    bf16 (``BwdGeometry`` in ``flash_bwd.cu``): at ``dp`` ≤ 128 the
    ``wgmma`` kernel (``wgmma`` 1), its tiles in panels of ``panel`` columns
    one ``swizzle`` span wide, ``bk`` keys a block (two warpgroups of 64),
    ``bq`` queries a stage in a ring of ``stages``, ``smem`` dynamic
    shared-memory bytes (1 KiB of alignment slack, K and V, the stages' Q
    and dO, four bf16 dSᵀ buffers of 64 x 64, the stages' L and Δ rows, the
    mbarriers); at ``dp`` 256 the scalar kernels (``wgmma`` 0: 32 x 32
    float32 tiles; dK and dV of 64 keys at that width would take 256
    registers a thread).

    float32 (``Tf32Geometry``): at ``dp`` ≤ 128 the 3xTF32 kernels
    (``wgmma`` 1): natural tiles in panels of ``panel`` float32 columns, one
    ``swizzle`` span wide; the dK/dV kernel holds the hi and lo tiles of
    its 64 keys' K and V and walks stages of ``bq`` queries (Q, dO and
    their transposed planes, hi and lo), ``smem_dkdv`` bytes; the dQ kernel
    holds its 64 queries' Q and dO and walks stages of ``bk`` keys (K, V,
    Kᵀ), ``smem_dq`` bytes (each with 1 KiB of alignment slack, the L and Δ
    rows and three mbarriers); at ``dp`` 256 the scalar kernels."""
    if dtype == torch.float32:
        return _bwd_f32_geometry(d)
    dp = padded_dim(d)
    if dp == 256:
        return dict(dp=dp, panel=0, swizzle=0, bk=_SCALAR_BK, bq=_SCALAR_BQ,
                    stages=0, smem=_scalar_smem(dp), wgmma=0)
    panel = min(dp, 64)
    bk, bq = 2 * BWD_KEYS_PER_WARPGROUP, 64
    stages = 3
    smem = (1024 + 2 * bk * dp * 2 + 2 * stages * bq * dp * 2
            + 4 * BWD_KEYS_PER_WARPGROUP * bq * 2 + 2 * stages * bq * 4
            + (2 * stages + 1) * 8)
    return dict(dp=dp, panel=panel, swizzle=panel * 2, bk=bk, bq=bq,
                stages=stages, smem=smem, wgmma=1)


def _scalar_smem(dp: int) -> int:
    """Dynamic shared-memory bytes of the scalar kernels at width ``dp``."""
    return ((2 * _SCALAR_BK + 2 * _SCALAR_BQ) * (dp + 4)
            + 2 * _SCALAR_BQ * (_SCALAR_BK + 1) + 2 * _SCALAR_BQ) * 4


def _bwd_f32_geometry(d: int) -> dict:
    dp = padded_dim(d)
    if dp == 256:
        smem = _scalar_smem(dp)
        return dict(dp=dp, panel=0, swizzle=0, bq=_SCALAR_BQ, bk=_SCALAR_BK,
                    smem_dkdv=smem, smem_dq=smem, wgmma=0)
    panel = min(dp, 32)
    # at dp 128 the resident 64-row hi and lo tiles take 128 KiB
    bq, bk = (16, 32) if dp >= 128 else (64, 64)
    tile = BWD_F32_ROWS * dp * 4
    smem_dkdv = 1024 + 4 * tile + 8 * bq * dp * 4 + 2 * bq * 4 + 3 * 8
    smem_dq = 1024 + 4 * tile + 2 * BWD_F32_ROWS * 4 + 6 * bk * dp * 4 + 3 * 8
    return dict(dp=dp, panel=panel, swizzle=panel * 4, bq=bq, bk=bk,
                smem_dkdv=smem_dkdv, smem_dq=smem_dq, wgmma=1)


def _padded_rows(sq: int) -> int:
    return -(-sq // 64) * 64


def _round8(s: int) -> int:
    return -(-s // 8) * 8


def tf32_planes(b: int, sq: int, sk: int, h: int, kh: int, d: int) -> dict:
    """The float32 path's workspace layout (``Tf32Planes`` in
    ``flash_bwd.cu``): ``{name: (offset, floats)}`` of the L·log2 e and Δ
    rows (``[B, H, Sq]`` padded to 64) and of each 3xTF32 plane, hi and lo:
    natural ``[B·heads, S, d]`` (``qn``, ``on``: dO, ``kn``, ``vn``) and
    transposed ``[B·heads, d, S8]`` (``qt``, ``ot``, ``kt``; S8 is S
    rounded up to 8), in order."""
    nq, nqt = b * h * sq * d, b * h * d * _round8(sq)
    nk, nkt = b * kh * sk * d, b * kh * d * _round8(sk)
    parts = [("rows", 2 * b * h * _padded_rows(sq))]
    for name, n in (("qn", nq), ("qt", nqt), ("on", nq), ("ot", nqt),
                    ("kn", nk), ("kt", nkt), ("vn", nk)):
        parts += [(f"{name}_hi", n), (f"{name}_lo", n)]
    out, at = {}, 0
    for name, n in parts:
        out[name] = (at, n)
        at += n
    return out


def bwd_workspace(dtype: torch.dtype, b: int, sq: int, sk: int, h: int, kh: int,
                  d: int) -> int:
    """Floats of the workspace the backward takes (``flash_bwd_workspace``):
    bf16 at ``dp`` ≤ 128 the rows, the float32 dQ accumulator and, under
    GQA, the dK and dV accumulators; float32 at ``dp`` ≤ 128 the rows and
    the 3xTF32 planes (:func:`tf32_planes`); Δ at ``dp`` 256."""
    dp = padded_dim(d)
    if dp == 256:
        return b * h * sq
    if dtype == torch.float32:
        return sum(n for _, n in tf32_planes(b, sq, sk, h, kh, d).values())
    return (2 * b * h * _padded_rows(sq) + b * sq * h * d
            + (0 if h == kh else 2 * b * sk * kh * d))


def bwd_block_order(batch: int, sk: int, heads: int, bk: int) -> list:
    """(batch, first key, head) of the bf16 backward's blocks in the order
    they start (block index order, x fastest: the grid is (batch·heads, key
    tiles)): every head of the first key tile first, so under causal
    masking the key tiles that the most query tiles see start first."""
    n = -(-sk // bk)
    return [(x // heads, y * bk, x % heads)
            for y in range(n) for x in range(batch * heads)]


def query_tiles(k0: int, bk: int, bq: int, *, sq: int, kv_len: int, causal: bool,
                window: Optional[int]) -> Tuple[int, int]:
    """Query tiles ``[first, last)`` of ``bq`` queries that can see a key of
    ``[k0, k0 + bk)`` (``query_tiles`` in ``flash_bwd.cu``): the tiles a
    backward block walks.  A (64 keys x 64 queries) tile of it skips the
    mask where ``tile_interior(q0, 64, k0, 64)`` holds."""
    k_end = min(k0 + bk, kv_len)
    if k_end <= k0:
        return 0, 0
    begin = k0 if causal else 0
    end = min(sq, k_end - 1 + window) if window else sq
    first = begin // bq
    return first, (-(-end // bq) if end > begin else first)


def kernel_bwd_geometry(d: int, dtype: torch.dtype = torch.bfloat16) -> dict:
    """The built library's own backward instantiation for head dim ``d`` in
    ``dtype`` (``flash_bwd_geometry``, ``flash_bwd_f32_geometry``; builds
    the library on first use)."""
    f32 = dtype == torch.float32
    name = "flash_bwd_f32_geometry" if f32 else "flash_bwd_geometry"
    keys = _BWD_F32_GEOMETRY_KEYS if f32 else _BWD_GEOMETRY_KEYS
    fn = _build.function("flash_bwd", name, [_I32, _P])
    out = (ctypes.c_int * len(keys))()
    err = fn(d, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"{name}({d}) failed: cudaError_t {err}")
    return dict(zip(keys, out))


def kernel_bwd_workspace(dtype: torch.dtype, b: int, sq: int, sk: int, h: int,
                         kh: int, d: int) -> int:
    """Floats of the float32 workspace the backward takes, as the library
    computes them (``flash_bwd_workspace``)."""
    fn = _build.function("flash_bwd", "flash_bwd_workspace", [_I32] * 7 + [_P])
    out = ctypes.c_longlong()
    err = fn(int(dtype == torch.bfloat16), b, sq, sk, h, kh, d, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"flash_bwd_workspace failed: cudaError_t {err}")
    return out.value


def kernel_f32_geometry(d: int) -> dict:
    """The built library's own float32 forward instantiation for head dim
    ``d`` (``flash_f32_geometry``; builds the library on first use)."""
    fn = _build.function("flash", "flash_f32_geometry", [_I32, _P])
    out = (ctypes.c_int * len(_F32_GEOMETRY_KEYS))()
    err = fn(d, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"flash_f32_geometry({d}) failed: cudaError_t {err}")
    return dict(zip(_F32_GEOMETRY_KEYS, out))


def kernel_fwd_f32_workspace(b: int, sq: int, sk: int, h: int, kh: int, d: int) -> int:
    """Floats of the workspace the float32 forward takes, as the library
    computes them (``flash_f32_workspace``)."""
    fn = _build.function("flash", "flash_f32_workspace", [_I32] * 6 + [_P])
    out = ctypes.c_longlong()
    err = fn(b, sq, sk, h, kh, d, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"flash_f32_workspace failed: cudaError_t {err}")
    return out.value


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
    fn = _build.function("flash", f"flash_attention_{_SUFFIX[q.dtype]}",
                         _ARGTYPES[q.dtype])
    stream = torch.cuda.current_stream(q.get_device()).cuda_stream
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            0 if lse is None else lse.data_ptr()]
    if q.dtype == torch.float32:  # the 3xTF32 planes, every float written first
        work = torch.empty(kernel_fwd_f32_workspace(b, sq, sk, h, kh, d),
                           dtype=torch.float32, device=q.device)
        ptrs.append(work.data_ptr() if work.numel() else 0)
    err = fn(*ptrs, b, sq, sk, h, kh, d, int(causal), window or 0, kv_len, stream)
    if err != 0:
        raise RuntimeError(f"flash launch failed: cudaError_t {err}")
    launches["flash"] += 1
    if q.dtype == torch.float32:
        launches["flash_f32"] += 1
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
    # the bf16 path accumulates into its workspace; the float32 path writes
    # every float of its own before reading it
    alloc = torch.zeros if q.dtype == torch.bfloat16 else torch.empty
    work = alloc(kernel_bwd_workspace(q.dtype, b, sq, sk, h, kh, d),
                 dtype=torch.float32, device=q.device)
    fn = _build.function("flash_bwd", f"flash_backward_{_SUFFIX[q.dtype]}", _BWD_ARGTYPES)
    stream = torch.cuda.current_stream(q.get_device()).cuda_stream
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), work.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, sq, sk, h, kh, d, int(causal), window or 0, kv_len, stream,
    )
    if err != 0:
        raise RuntimeError(f"flash backward launch failed: cudaError_t {err}")
    launches["flash_bwd"] += 1
    return dq, dk, dv
