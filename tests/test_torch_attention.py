"""PyTorch port, attention layer: the flash kernel's plain version, the
chunked online-softmax path and the shared layers, held against the JAX
package on the same numpy-seeded inputs.

Tolerances: float32 paths at 1e-5 (the same float32 arithmetic in another
summation order; the Pallas kernel runs in interpret mode with 16-wide
blocks, its plain version takes one dense softmax), bf16 at 4e-2 (the
reference's own flash tolerance: one bf16 rounding of p and of the output),
the layers at 1e-6.  The CUDA kernels themselves run only on the card
(``chip_smoke.py`` phase 2); here their wrappers' refusals and build
command are checked, and the kernels' host-side geometry, workspace and
schedule (the Python mirror in ``kernels/flash.py``) are held against
brute-force counts of the visible (query, key) pairs and, for the float32
kernel's transposed V plane, against the register fragments' order.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.ops as JOPS
from repro.kernels.flash import flash_kernel_call
import repro.models.attention as JA
import repro.models.layers as JL
import repro_torch.models.attention as PA
import repro_torch.models.layers as PL
from repro.configs import get_config as jax_config
from repro_torch.configs import get_config
from repro_torch.kernels import _build
from repro_torch.kernels import flash as PF
from repro_torch.kernels import ops as POPS

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}

# the four shapes of the reference's flash sweep
FLASH_SHAPES = [
    (2, 64, 64, 4, 2, 32, True, None),   # GQA causal
    (1, 48, 48, 2, 2, 16, True, 16),     # sliding window
    (2, 24, 72, 3, 1, 64, False, None),  # MQA, non-causal, ragged blocks
    (1, 16, 128, 4, 4, 128, True, None), # long kv, wide head
]


def _randn(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("b,sq,sk,h,kh,d,causal,window", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flash_plain_version_matches_pallas(b, sq, sk, h, kh, d, causal, window, dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(sq * 7 + d)
    q, k, v = _randn(rng, (b, sq, h, d)), _randn(rng, (b, sk, kh, d)), _randn(rng, (b, sk, kh, d))
    want = JOPS.flash_attention(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        causal=causal, window=window, bq=16, bk=16,
    )
    got = POPS.flash_attention(
        torch.from_numpy(q).to(tdt), torch.from_numpy(k).to(tdt),
        torch.from_numpy(v).to(tdt), causal=causal, window=window,
    )
    assert got.dtype == tdt and tuple(got.shape) == (b, sq, h, d)
    tol = 1e-5 if dtype == "float32" else 4e-2
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), rtol=tol, atol=tol
    )


def test_flash_plain_version_kv_len_and_empty_rows():
    """Keys at or past ``kv_len`` are invisible; a row that sees no key is 0
    (the reference's ``kv_len`` padding bound)."""
    rng = np.random.default_rng(3)
    q, k, v = _randn(rng, (1, 20, 2, 16)), _randn(rng, (1, 30, 1, 16)), _randn(rng, (1, 30, 1, 16))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = POPS.flash_attention(tq, tk, tv, causal=False, kv_len=11)
    want = POPS.flash_attention(tq, tk[:, :11], tv[:, :11], causal=False)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    empty = POPS.flash_attention(tq, tk, tv, causal=False, kv_len=0)
    assert not empty.any()


@pytest.mark.parametrize(
    "causal,window", [(True, None), (True, 8), (False, None), (False, 12)]
)
def test_chunked_attention_matches_reference(causal, window):
    """Empty slots (-1) are skipped, positions differ per row, and windows
    band the mask, exactly as in the reference's recurrence."""
    rng = np.random.default_rng(11)
    b, sq, sk, h, kh, d = 2, 32, 48, 4, 2, 16
    q, k, v = _randn(rng, (b, sq, h, d)), _randn(rng, (b, sk, kh, d)), _randn(rng, (b, sk, kh, d))
    qpos = np.stack([np.arange(sq) + 16, np.arange(sq) + 10]).astype(np.int32)
    kpos = np.stack([np.arange(sk), np.arange(sk)]).astype(np.int32)
    kpos[0, 5:9] = -1
    kpos[1, 30:] = -1
    kw = dict(causal=causal, window=window, q_chunk=8, k_chunk=16)
    want = JA.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(qpos),
        jnp.asarray(kpos), out_dtype=jnp.float32, **kw,
    )
    got = PA.chunked_attention(
        *map(torch.from_numpy, (q, k, v, qpos, kpos)), out_dtype=torch.float32, **kw
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("window", [None, 4])
def test_attention_decode_matches_reference(window):
    """One decode step against a cache holding empty slots, full and ring
    (window 4 over 6 slots); the input cache is left as it was."""
    jcfg = dataclasses.replace(jax_config("smollm-135m", smoke=True), window=window)
    pcfg = dataclasses.replace(get_config("smollm-135m", smoke=True), window=window)
    jp = JA.attention_init(jax.random.key(1), jcfg)
    pp = PA.attention_init(pcfg, device="cpu")
    for name in ("wq", "wk", "wv", "wo"):
        getattr(pp, name).data.copy_(torch.from_numpy(np.array(jp[name])))
    rng = np.random.default_rng(2)
    x = _randn(rng, (2, 1, pcfg.d_model))
    cache = {
        "k": _randn(rng, (2, 6, pcfg.n_kv_heads, pcfg.head_dim)),
        "v": _randn(rng, (2, 6, pcfg.n_kv_heads, pcfg.head_dim)),
        "pos": np.array([[6, 7, 2, 3, -1, -1], [6, 1, 2, 3, 4, 5]], np.int32),
    }
    jout, jc = JA.attention_decode(
        jp, jnp.asarray(x), {n: jnp.asarray(a) for n, a in cache.items()},
        jnp.asarray(8, jnp.int32), jcfg, window=window,
    )
    pc_in = {n: torch.from_numpy(a.copy()) for n, a in cache.items()}
    pout, pc = PA.attention_decode(pp, torch.from_numpy(x), pc_in, 8, pcfg, window=window)
    np.testing.assert_allclose(pout.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)
    for name in ("k", "v", "pos"):
        np.testing.assert_allclose(pc[name].numpy(), np.asarray(jc[name]), rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(pc_in[name].numpy(), cache[name])


def _layer_case(name, rng):
    x = _randn(rng, (2, 5, 24))
    scale = _randn(rng, (24,)) + 1.0
    bias = _randn(rng, (24,))
    tx = torch.from_numpy(x)
    if name == "rms_norm":
        return JL.rms_norm(jnp.asarray(x), jnp.asarray(scale)), PL.rms_norm(tx, torch.from_numpy(scale))
    if name == "layer_norm":
        return (
            JL.layer_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias)),
            PL.layer_norm(tx, torch.from_numpy(scale), torch.from_numpy(bias)),
        )
    if name == "np_ln":
        return JL.apply_norm(jnp.asarray(x), {}, "np_ln"), PL.apply_norm(tx, PL.Norm(24, "np_ln"), "np_ln")
    if name in ("swiglu", "gelu"):
        m = PL.MLP(24, 40, name, torch.float32, torch.Generator().manual_seed(0))
        params = {k: jnp.asarray(p.detach().numpy()) for k, p in m.named_parameters()}
        return JL.mlp_apply(params, jnp.asarray(x), name), m(tx)
    if name == "rotary":
        xr = _randn(rng, (2, 5, 3, 16))
        pos = np.array([[0, 1, 2, 3, 4], [7, 9, 100, 2047, 4000]], np.int32)
        jc, js = JL.rotary_embedding(jnp.asarray(pos), 16, 10_000.0)
        pc, ps = PL.rotary_embedding(torch.from_numpy(pos), 16, 10_000.0)
        return (
            JL.apply_rotary(jnp.asarray(xr), jc, js),
            PL.apply_rotary(torch.from_numpy(xr), pc, ps),
        )
    if name == "sinusoidal":
        return JL.sinusoidal_positions(12, 16), PL.sinusoidal_positions(12, 16)
    raise KeyError(name)


@pytest.mark.parametrize(
    "name", ["rms_norm", "layer_norm", "np_ln", "swiglu", "gelu", "rotary", "sinusoidal"]
)
def test_layers_match_reference(name):
    want, got = _layer_case(name, np.random.default_rng(5))
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-6)


def test_truncated_normal_is_seeded_and_truncated():
    a = PL.truncated_normal((4000,), torch.float32, 0.5, torch.Generator().manual_seed(1))
    b = PL.truncated_normal((4000,), torch.float32, 0.5, torch.Generator().manual_seed(1))
    assert torch.equal(a, b)
    assert float(a.abs().max()) <= 1.0 and 0.3 < float(a.std()) < 0.5


@pytest.mark.parametrize("d", [4, 12, 264, 512])
def test_flash_refuses_head_dims(d):
    q = torch.zeros(1, 8, 2, d)
    with pytest.raises(ValueError, match="head dim"):
        POPS.flash_attention(q, q, q)


@pytest.mark.parametrize(
    "dtypes",
    [(torch.float16,) * 3, (torch.float64,) * 3, (torch.bfloat16, torch.float32, torch.float32)],
)
def test_flash_refuses_dtypes(dtypes):
    q, k, v = (torch.zeros(1, 8, 2, 16, dtype=dt) for dt in dtypes)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        POPS.flash_attention(q, k, v)


@pytest.mark.parametrize(
    "q_shape,k_shape,kw",
    [
        ((1, 8, 3, 16), (1, 8, 2, 16), {}),          # H not a multiple of KH
        ((1, 8, 2, 16), (2, 8, 2, 16), {}),          # batch differs
        ((1, 8, 2, 16), (1, 8, 2, 16), {"kv_len": 9}),
        ((1, 8, 2, 16), (1, 8, 2, 16), {"window": 0}),
    ],
)
def test_flash_refuses_shapes(q_shape, k_shape, kw):
    with pytest.raises(ValueError):
        POPS.flash_attention(torch.zeros(q_shape), torch.zeros(k_shape), torch.zeros(k_shape), **kw)


def test_flash_builds_for_sm90a_and_counts():
    assert "flash" in _build.SOURCES
    cmd = _build.nvcc_command("flash", _build.library_path("flash"))
    assert "arch=compute_90a,code=sm_90a" in cmd and cmd[-1].endswith("csrc/flash.cu")
    POPS.reset_launch_counts()
    q = torch.zeros(1, 8, 2, 16)
    POPS.flash_attention(q, q, q)  # CPU: the plain version, no launch
    assert POPS.launch_counts()["flash"] == 0


# -- the bf16 kernel's geometry and schedule (Hopper: wgmma + TMA) ----------------

def _visible(rows, keys, *, kv_len, causal, window):
    """Brute-force visibility of queries ``rows`` x keys ``keys`` (index arrays)."""
    i, j = rows[:, None], keys[None, :]
    vis = j < kv_len
    if causal:
        vis = vis & (j <= i)
    if window:
        vis = vis & (j > i - window)
    return vis


@pytest.mark.parametrize("d", range(8, 257, 8))
def test_bf16_geometry_per_width(d):
    """Every head dim the kernel takes has an instantiation that holds it,
    whose TMA swizzle span is one panel row (32, 64 or 128 bytes, the
    wgmma layout's), whose tiles start on the 1 KiB swizzle repeat and whose
    shared memory fits one H100 block."""
    g = PF.bf16_geometry(d)
    assert g["dp"] == min(w for w in (16, 32, 64, 128, 256) if w >= d)
    assert g["panel"] == min(g["dp"], 64) and g["dp"] % g["panel"] == 0
    assert g["swizzle"] == 2 * g["panel"] and g["swizzle"] in (32, 64, 128)
    assert g["bq"] == 2 * PF.BF16_ROWS_PER_WARPGROUP == 128
    assert g["bk"] in (64, 128) and g["stages"] >= 2
    q_bytes, tile_bytes = g["bq"] * g["dp"] * 2, g["bk"] * g["dp"] * 2
    assert q_bytes % 1024 == 0 and tile_bytes % 1024 == 0
    assert g["smem"] == 1024 + q_bytes + 2 * g["stages"] * tile_bytes + (2 * g["stages"] + 1) * 8
    assert g["smem"] <= 232_448


def _tma_box(x, tmap, coords):
    """What one TMA load of ``tmap``'s box at ``coords`` (innermost first)
    puts in shared memory, read from ``x``'s flat storage through the map's
    byte strides; elements outside ``dims`` are 0."""
    flat = x.ravel()
    box, dims = tmap["box"], tmap["dims"]
    st = [1] + [s // 2 for s in tmap["strides"]]
    out = np.zeros((box[2], box[0]), x.dtype)
    for r in range(box[2]):
        for c in range(box[0]):
            at = (coords[0] + c, coords[1], coords[2] + r, coords[3])
            if all(0 <= a < n for a, n in zip(at, dims)):
                out[r, c] = flat[sum(a * s for a, s in zip(at, st))]
    return out


@pytest.mark.parametrize(
    "b,seq,heads,d,rows,row0",
    [(2, 37, 3, 40, 16, 30), (1, 20, 2, 8, 8, 16), (2, 9, 1, 72, 8, 0), (1, 12, 2, 256, 4, 10)],
)
def test_bf16_tensor_map_loads_padded_tiles(b, seq, heads, d, rows, row0):
    """The maps over ``[B, S, heads, D]``: 16-byte strides, a box one swizzle
    span wide, and loads of each panel that together give the tile of one
    head and batch, zero past the sequence and past D (the kernel's
    padding), never another batch's rows."""
    g = PF.bf16_geometry(d)
    tmap = PF.tensor_map(b, seq, heads, d, rows)
    assert all(s % 16 == 0 for s in tmap["strides"])
    assert tmap["box"][0] * 2 == g["swizzle"] and max(tmap["box"]) <= 256
    x = np.random.default_rng(d).standard_normal((b, seq, heads, d)).astype(np.float32)
    for bi in range(b):
        for hi in range(heads):
            got = np.concatenate(
                [_tma_box(x, tmap, (p * g["panel"], hi, row0, bi))
                 for p in range(g["dp"] // g["panel"])], axis=1)
            want = np.zeros((rows, g["dp"]), np.float32)
            tile = x[bi, row0:row0 + rows, hi, :]
            want[: tile.shape[0], :d] = tile
            np.testing.assert_array_equal(got, want)


# (Sq, Sk, kv_len, causal, window, D): the serving shape, ragged ends,
# kv_len short of Sk and not a tile multiple, kv_len 0, windows
SCHEDULES = [
    (4096, 4096, 4096, True, None, 64),
    (1111, 1111, 1111, True, None, 128),
    (1000, 3001, 2777, False, None, 64),
    (1000, 3001, 0, False, None, 64),
    (300, 300, 300, True, 50, 40),
    (333, 333, 333, True, None, 256),
    (2048, 2048, 2048, True, 1024, 128),
    (257, 520, 300, True, 77, 16),
    (130, 70, 70, False, 9, 32),
]


@pytest.mark.parametrize("sq,sk,kv_len,causal,window,d", SCHEDULES)
def test_bf16_schedule_covers_visible_pairs(sq, sk, kv_len, causal, window, d):
    """Blocks in launch order cover every (batch, head, query tile) once,
    latest tiles first across all heads (causal: of the full tiles, the most
    work first); the key tiles a block walks hold every visible pair of its
    rows (skipping the others is exact); a tile that skips the mask has
    every pair of its warpgroup's 64 rows visible; and the pairs in walked
    tiles, counted per tile, sum to the brute-force count."""
    g = PF.bf16_geometry(d)
    bq, bk, wg_rows = g["bq"], g["bk"], PF.BF16_ROWS_PER_WARPGROUP
    kw = dict(kv_len=kv_len, causal=causal, window=window)
    order = PF.block_order(2, sq, 3, bq)
    assert sorted(order) == sorted(
        (b, q0, h) for b in range(2) for q0 in range(0, sq, bq) for h in range(3))
    starts = [q0 for _, q0, _ in order]
    assert starts == sorted(starts, reverse=True)
    vis = _visible(np.arange(sq), np.arange(sk), **kw)
    if causal and not window:  # of the full tiles, the longest start first
        work = [int(vis[q0:q0 + bq].sum()) for q0 in starts if q0 + bq <= sq]
        assert work == sorted(work, reverse=True)
    counted, interior = 0, 0
    for q0 in sorted(set(starts), reverse=True):
        first, last = PF.key_tiles(q0, bq, bk, sq=sq, **kw)
        assert 0 <= first <= last
        block = vis[q0:q0 + bq]
        assert not block[:, : first * bk].any() and not block[:, last * bk:].any()
        for t in range(first, last):
            k0 = t * bk
            counted += int(block[:, k0:k0 + bk].sum())
            for r0 in range(q0, q0 + bq, wg_rows):
                if PF.tile_interior(r0, wg_rows, k0, bk, **kw):
                    interior += 1
                    rows = np.arange(r0, r0 + wg_rows)
                    assert _visible(rows, np.arange(k0, k0 + bk), **kw).all()
        if kv_len == 0:
            assert first == last
    assert counted == int(vis.sum())
    if causal and sq >= 1024:
        assert interior > 0  # the long rows take the unmasked path


@pytest.mark.parametrize("d", range(8, 257, 8))
def test_bwd_geometry_per_width(d):
    """The bf16 backward's instantiation for every head dim: the wgmma kernel
    up to a padded width of 128 (two warpgroups of 64 keys, 64-query stages,
    panels one swizzle span wide on the 1 KiB repeat), the scalar kernels at
    256; its shared memory fits one H100 block."""
    g = PF.bwd_geometry(d)
    assert g["dp"] == PF.padded_dim(d)
    assert g["smem"] <= 232_448
    if g["dp"] == 256:
        assert g["wgmma"] == 0 and g["bk"] == g["bq"] == 32 and g["stages"] == 0
        return
    assert g["wgmma"] == 1
    assert g["panel"] == min(g["dp"], 64) and g["swizzle"] == 2 * g["panel"]
    assert g["bk"] == 2 * PF.BWD_KEYS_PER_WARPGROUP == 128 and g["bq"] == 64
    assert g["stages"] >= 2
    kv_bytes, q_bytes = g["bk"] * g["dp"] * 2, g["bq"] * g["dp"] * 2
    ds_bytes = PF.BWD_KEYS_PER_WARPGROUP * g["bq"] * 2
    assert ds_bytes == 64 * 128  # dSᵀ rows of 64 queries: one 128-byte swizzle span
    for nbytes in (kv_bytes, q_bytes, ds_bytes, PF.BWD_KEYS_PER_WARPGROUP * g["swizzle"]):
        assert nbytes % (8 * g["swizzle"]) == 0  # tiles and warpgroup halves on the repeat
    assert g["smem"] == (1024 + 2 * kv_bytes + 2 * g["stages"] * q_bytes + 4 * ds_bytes
                         + 2 * g["stages"] * g["bq"] * 4 + (2 * g["stages"] + 1) * 8)


@pytest.mark.parametrize("sq,sk,kv_len,causal,window,d", SCHEDULES)
def test_bwd_schedule_covers_visible_pairs(sq, sk, kv_len, causal, window, d):
    """The backward's blocks in launch order cover every (batch, head, key
    tile) once, earliest keys first (causal: the key tiles the most queries
    see start first); the query tiles a block walks hold every visible pair
    of its keys; a (64 keys x 64 queries) tile that skips the mask has every
    pair visible; and the pairs in walked tiles sum to the brute-force
    count."""
    g = PF.bwd_geometry(d)
    bk, bq, wk = g["bk"], g["bq"], PF.BWD_KEYS_PER_WARPGROUP
    kw = dict(kv_len=kv_len, causal=causal, window=window)
    order = PF.bwd_block_order(2, sk, 3, bk)
    assert sorted(order) == sorted(
        (b, k0, h) for b in range(2) for k0 in range(0, sk, bk) for h in range(3))
    assert len(set(order)) == len(order)
    starts = [k0 for _, k0, _ in order]
    assert starts == sorted(starts)
    vis = _visible(np.arange(sq), np.arange(sk), **kw)
    if causal and not window:
        work = [int(vis[:, k0:k0 + bk].sum()) for k0 in starts]
        assert work == sorted(work, reverse=True)
    counted, interior = 0, 0
    for k0 in sorted(set(starts)):
        first, last = PF.query_tiles(k0, bk, bq, sq=sq, **kw)
        assert 0 <= first <= last
        block = vis[:, k0:k0 + bk]
        assert not block[: first * bq].any() and not block[last * bq:].any()
        for t in range(first, last):
            q0 = t * bq
            counted += int(block[q0:q0 + bq].sum())
            for kw0 in range(k0, k0 + bk, wk if g["wgmma"] else bk):
                if g["wgmma"] and PF.tile_interior(q0, bq, kw0, wk, **kw):
                    interior += 1
                    assert _visible(np.arange(q0, q0 + bq), np.arange(kw0, kw0 + wk), **kw).all()
        if kv_len <= k0:
            assert first == last
    assert counted == int(vis.sum())
    if causal and sq >= 1024 and g["wgmma"]:
        assert interior > 0  # the long rows take the unmasked path


@pytest.mark.parametrize(
    "bh,sq,sk,d,blk,kv_lens",
    [(2, 40, 72, 16, 8, (53, 0)), (1, 1000, 3001, 64, 512, (2777, 0))],
)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flash_plain_version_matches_pallas_at_kv_len(bh, sq, sk, d, blk, kv_lens, dtype):
    """``kv_len`` short of Sk and not a multiple of the key tile (the small
    shape and chip_smoke.py's 1,000 x 3,001 one), and ``kv_len = 0`` (exact
    zeros), against ``flash_kernel_call`` itself in interpret mode on
    zero-padded blocks."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(29)
    q, k, v = _randn(rng, (bh, sq, d)), _randn(rng, (bh, sk, d)), _randn(rng, (bh, sk, d))
    pad = lambda x: np.pad(x, ((0, 0), (0, -x.shape[1] % blk), (0, 0)))
    tol = 1e-5 if dtype == "float32" else 4e-2
    for kv_len in kv_lens:
        want = flash_kernel_call(
            *(jnp.asarray(pad(x), jdt) for x in (q, k, v)),
            causal=False, kv_len=kv_len, bq=blk, bk=blk, interpret=True,
        )[:, :sq]
        # [BH, S, D] as batch 1 with BH heads
        got = POPS.flash_attention(
            *(torch.from_numpy(x).to(tdt).transpose(0, 1)[None] for x in (q, k, v)),
            causal=False, kv_len=kv_len,
        )[0].transpose(0, 1)
        np.testing.assert_allclose(
            got.float().numpy(), np.asarray(want, np.float32), rtol=tol, atol=tol
        )
        if kv_len == 0:
            assert not got.any() and not np.asarray(want, np.float32).any()


def _variants_tool():
    """``tools/flash_variants.py`` (a script, not a package) as a module."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "tools" / "flash_variants.py"
    spec = importlib.util.spec_from_file_location("flash_variants", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_variant_tool_edits_copies_of_the_kernel_source(tmp_path):
    """A variant is the checkout's flash.cu with texts replaced, or another
    file; a replacement that names no text of the source is refused."""
    tool = _variants_tool()
    base = (_build.CSRC / "flash.cu").read_text()
    other = tmp_path / "old.cu"
    other.write_text("int x;")
    stages = re.search(r"static constexpr int kStages = [^;]*;", base).group(0)
    got = tool.variant_sources([
        "final",
        f"two_stages={stages}=>static constexpr int kStages = 2;",
        f"old:{other}",
    ])
    assert got["final"] == base and got["old"] == "int x;"
    assert got["two_stages"] == base.replace(stages, "static constexpr int kStages = 2;")
    with pytest.raises(SystemExit, match="not in the source"):
        tool.variant_sources(["bad=no such text=>x"])


def test_variant_tool_reads_ptxas_registers_and_spills():
    log = (
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_117flash_bf16_kernelILi64EEEv' "
        "for 'sm_90a'\nptxas info    : Function properties for _ZN12_GLOBAL__N_117flash_bf16_"
        "kernelILi64EEEv\n    16 bytes stack frame, 24 bytes spill stores, 8 bytes spill loads\n"
        "ptxas info    : Used 168 registers, used 16 barriers\n"
    )
    assert _variants_tool().ptxas_report(log) == [(64, 168, 24, 8)]


def _bwd_variants_tool():
    """``tools/flash_bwd_variants.py`` (a script, not a package) as a module."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "tools" / "flash_bwd_variants.py"
    spec = importlib.util.spec_from_file_location("flash_bwd_variants", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arm", sorted(_bwd_variants_tool().ARMS))
def test_bwd_variant_tool_arms_apply_to_the_checkout(arm):
    """Each named arm of the backward's design ablation edits text that the
    checkout's ``flash_bwd.cu`` holds exactly once (the final arm is the
    source itself), so every arm still builds from today's source."""
    tool = _bwd_variants_tool()
    base = (_build.CSRC / "flash_bwd.cu").read_text()
    got = tool.variant_sources([arm])[arm]
    if not tool.ARMS[arm]:
        assert got == base
        return
    for sub in tool.ARMS[arm].split("@@"):
        assert base.count(sub.split("=>")[0]) == 1, (arm, sub)
    assert got != base


def test_bwd_variant_tool_reads_ptxas_registers_and_spills():
    log = (
        "ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__b7f7edad_12_flash_bwd_cu_"
        "1a06042315bwd_bf16_kernelILi128EEEv14CUtensorMap_stS1_S1_S1_NS_4ArgsE' for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN45_GLOBAL__N__b7f7edad_12_flash_bwd_cu_"
        "1a06042315bwd_bf16_kernelILi128EEEv14CUtensorMap_stS1_S1_S1_NS_4ArgsE\n"
        "    344 bytes stack frame, 856 bytes spill stores, 852 bytes spill loads\n"
        "ptxas info    : Used 168 registers, used 16 barriers\n"
    )
    assert _bwd_variants_tool().ptxas_report(log) == [(128, 168, 856, 852)]


@pytest.mark.parametrize("d", range(8, 257, 8))
def test_bwd_f32_geometry_per_width(d):
    """The float32 backward's instantiation for every head dim: the 3xTF32
    kernels up to a padded width of 128 (64-row resident tiles, natural
    panels of 32 float32 columns on the 128-byte swizzle, 64-byte at width
    16), the scalar kernels at 256; both kernels' shared memory fits one
    H100 block and every tile and panel starts on a swizzle repeat."""
    g = PF.bwd_geometry(d, torch.float32)
    assert g["dp"] == PF.padded_dim(d)
    assert g["smem_dkdv"] <= 232_448 and g["smem_dq"] <= 232_448
    if g["dp"] == 256:
        assert g["wgmma"] == 0 and g["bq"] == g["bk"] == 32
        assert g["smem_dkdv"] == g["smem_dq"] == PF.bwd_geometry(d)["smem"]
        return
    dp, rows = g["dp"], PF.BWD_F32_ROWS
    assert g["wgmma"] == 1 and rows == 64
    assert g["panel"] == min(dp, 32) and g["swizzle"] == 4 * g["panel"]
    assert (g["bq"], g["bk"]) == ((16, 32) if dp == 128 else (64, 64))
    tile, q_tile, k_tile = rows * dp * 4, g["bq"] * dp * 4, g["bk"] * dp * 4
    for seq in (g["bq"], g["bk"]):  # a transposed tile's panels: DP rows of min(seq, 32)
        panel_bytes = dp * min(seq, 32) * 4
        assert panel_bytes % (8 * min(seq, 32) * 4) == 0
    for nbytes in (tile, q_tile, k_tile, rows * g["swizzle"], g["bq"] * g["swizzle"]):
        assert nbytes % 512 == 0  # the 64-byte swizzle's repeat; 1 KiB at 128 bytes
    assert g["smem_dkdv"] == 1024 + 4 * tile + 8 * q_tile + 2 * g["bq"] * 4 + 3 * 8
    assert g["smem_dq"] == 1024 + 4 * tile + 2 * rows * 4 + 6 * k_tile + 3 * 8


@pytest.mark.parametrize("b,sq,sk,h,kh,d", [(1, 4096, 4096, 9, 3, 64), (2, 1000, 3001, 8, 2, 40),
                                           (1, 1111, 1111, 4, 1, 128), (1, 300, 301, 2, 2, 8)])
def test_bwd_f32_workspace_covers_the_planes(b, sq, sk, h, kh, d):
    """The float32 workspace holds the L·log2 e and Δ rows (padded to 64)
    and the 3xTF32 hi and lo planes of Q, dO, K, V (natural) and Q, dO, K
    (transposed, the sequence padded to 8), one after another: no overlap,
    each 16-byte aligned with TMA-legal strides, and its size covers them
    all."""
    lay = PF.tf32_planes(b, sq, sk, h, kh, d)
    s8 = lambda s: -(-s // 8) * 8  # noqa: E731
    want = {"rows": 2 * b * h * -(-sq // 64) * 64}
    for name, n in (("qn", b * h * sq * d), ("qt", b * h * d * s8(sq)), ("on", b * h * sq * d),
                    ("ot", b * h * d * s8(sq)), ("kn", b * kh * sk * d),
                    ("kt", b * kh * d * s8(sk)), ("vn", b * kh * sk * d)):
        want[f"{name}_hi"] = want[f"{name}_lo"] = n
    assert {k: n for k, (_, n) in lay.items()} == want
    at = 0
    for name, (off, n) in lay.items():  # in order, back to back
        assert off == at and off * 4 % 16 == 0, name
        at += n
    assert PF.bwd_workspace(torch.float32, b, sq, sk, h, kh, d) == at
    # TMA strides (bytes) of the natural rows and the transposed rows
    assert (4 * d) % 16 == 0 and (4 * s8(sq)) % 16 == 0 and (4 * s8(sk)) % 16 == 0
    # the bf16 workspace is as it was: rows, the float32 dQ and GQA's dK / dV
    bf16 = PF.bwd_workspace(torch.bfloat16, b, sq, sk, h, kh, d)
    assert bf16 == want["rows"] + b * sq * h * d + (0 if h == kh else 2 * b * sk * kh * d)


# -- the float32 forward's 3xTF32 kernel (Hopper: wgmma + TMA) --------------------

@pytest.mark.parametrize("d", range(8, 257, 8))
def test_f32_geometry_per_width(d):
    """The float32 forward's instantiation for every head dim: the 3xTF32
    kernel up to a padded width of 128 (the bf16 kernel's 128-query block
    of two warpgroups, natural panels of 32 float32 columns on the 128-byte
    swizzle, 64-byte at width 16, one K and one Vᵀ tile of 64 keys, 32 at
    width 128, Vᵀ in panels of up to 32 keys), the scalar kernel at 256;
    its shared memory fits one H100 block and every tile and panel starts
    on a swizzle repeat."""
    g = PF.f32_geometry(d)
    dp = PF.padded_dim(d)
    assert g["dp"] == dp and g["smem"] <= 232_448
    if dp == 256:
        assert g["wgmma"] == 0 and (g["bq"], g["bk"]) == (64, 32)
        assert g["smem"] == ((64 + 2 * 32) * (256 + 4) + 64 * (32 + 1)) * 4
        return
    assert g["wgmma"] == 1 and g["bq"] == 2 * PF.BF16_ROWS_PER_WARPGROUP == 128
    assert g["panel"] == min(dp, 32) and g["swizzle"] == 4 * g["panel"]
    assert g["swizzle"] in (64, 128) and dp % g["panel"] == 0
    assert g["bk"] == (32 if dp == 128 else 64)
    q_tile, k_tile = PF.BF16_ROWS_PER_WARPGROUP * dp * 4, g["bk"] * dp * 4
    panel_v = min(g["bk"], 32)
    assert g["bk"] % panel_v == 0
    # tiles one after another from a 1 KiB-aligned base stay on the 1 KiB
    # repeat; a natural panel's rows and a Vᵀ panel's DP rows on their own
    for nbytes in (q_tile, k_tile):
        assert nbytes % 1024 == 0
    for nbytes, span in ((PF.BF16_ROWS_PER_WARPGROUP * g["swizzle"], g["swizzle"]),
                         (g["bk"] * g["swizzle"], g["swizzle"]),
                         (dp * panel_v * 4, panel_v * 4)):
        assert span in (64, 128) and nbytes % (8 * span) == 0
    assert g["smem"] == 1024 + 4 * q_tile + 4 * k_tile + 5 * 8


@pytest.mark.parametrize("b,sq,sk,h,kh,d", [(1, 4096, 4096, 9, 3, 64), (2, 1000, 3001, 8, 2, 40),
                                           (1, 4096, 1500, 16, 16, 64), (1, 300, 301, 2, 2, 8),
                                           (1, 333, 333, 2, 2, 256)])
def test_fwd_f32_workspace_covers_the_planes(b, sq, sk, h, kh, d):
    """The float32 forward's workspace holds the 3xTF32 hi and lo planes of
    Q and K (natural) and V (transposed, the keys padded to 8), one after
    another: no overlap, each 16-byte aligned with TMA-legal strides, and
    its size covers them all (none at head dim 256, the scalar kernel)."""
    lay = PF.fwd_f32_planes(b, sq, sk, h, kh, d)
    s8 = -(-sk // 8) * 8
    want = {}
    for name, n in (("qn", b * h * sq * d), ("kn", b * kh * sk * d), ("vt", b * kh * d * s8)):
        want[f"{name}_hi"] = want[f"{name}_lo"] = n
    assert {k: n for k, (_, n) in lay.items()} == want
    at = 0
    for name, (off, n) in lay.items():  # in order, back to back
        assert off == at and off * 4 % 16 == 0, name
        at += n
    assert PF.fwd_f32_workspace(b, sq, sk, h, kh, d) == (0 if d > 128 else at)
    # TMA strides (bytes) of the natural rows, the transposed rows and the matrices
    for stride in (4 * d, 4 * sq * d, 4 * sk * d, 4 * s8, 4 * s8 * d):
        assert stride % 16 == 0


@pytest.mark.parametrize("s8", [8, 64, 1504])
def test_tf32_key_order_matches_the_register_fragments(s8):
    """The transposed V plane permutes the keys within each 8 so that one
    k-step of O += P·V, with P's accumulator fragments as the register A
    operand (``Tf32Ops::frags``: a thread's columns 2t4, 2t4 + 1 of rows g,
    g + 8 as k = t4, t4 + 4) and B read K-major from the plane, is P·V."""
    order = PF.tf32_key_order(s8)
    for u in range(0, s8, 8):
        assert sorted(order[u:u + 8]) == list(range(u, u + 8))
    rng = np.random.default_rng(s8)
    p, v = rng.standard_normal((64, s8)), rng.standard_normal((s8, 16))
    plane = v[order].T  # [D, S8]: position 8u + k holds key order[8u + k]
    got = np.zeros((64, 16))
    for u in range(0, s8, 8):  # a k-step of 8 keys
        a = np.zeros((64, 8))  # the A operand as every thread's fragments fill it
        for t4 in range(4):
            a[:, t4] = p[:, u + 2 * t4]          # frags' k = t4: column 2t4
            a[:, t4 + 4] = p[:, u + 2 * t4 + 1]  # k = t4 + 4: column 2t4 + 1
        got += a @ plane[:, u:u + 8].T
    np.testing.assert_allclose(got, p @ v, rtol=1e-12, atol=1e-12)


# smollm-135m's head layout cut to size: GQA 3:1 at head dim 64, causal, a
# window, and a ragged non-causal kv_len
SMOLLM_LIKE = [
    (1, 64, 64, 3, 1, 64, True, None, 64),
    (2, 48, 48, 3, 1, 64, True, 16, 48),
    (1, 40, 72, 3, 1, 64, False, None, 53),
]


@pytest.mark.parametrize("b,sq,sk,h,kh,d,causal,window,kv_len", SMOLLM_LIKE)
def test_f32_plain_path_matches_pallas_at_smollm_shapes(b, sq, sk, h, kh, d, causal, window,
                                                        kv_len):
    """The float32 forward's plain path (what ``ops.flash_attention`` runs on
    a CPU tensor, and what phase 2 holds the 3xTF32 kernel to) against
    ``flash_kernel_call`` itself in interpret mode, K and V repeated per
    query head and zero-padded to its 16-wide blocks."""
    rng = np.random.default_rng(sq * 13 + sk)
    q, k, v = _randn(rng, (b, sq, h, d)), _randn(rng, (b, sk, kh, d)), _randn(rng, (b, sk, kh, d))
    rep = lambda x: np.repeat(x, h // kh, axis=2).transpose(0, 2, 1, 3).reshape(b * h, -1, d)  # noqa: E731
    pad = lambda x: np.pad(x, ((0, 0), (0, -x.shape[1] % 16), (0, 0)))  # noqa: E731
    want = flash_kernel_call(
        *(jnp.asarray(pad(x)) for x in (q.transpose(0, 2, 1, 3).reshape(b * h, sq, d),
                                        rep(k), rep(v))),
        causal=causal, window=window, kv_len=kv_len, bq=16, bk=16, interpret=True,
    )[:, :sq]
    kw = dict(causal=causal, window=window, kv_len=kv_len)
    got = POPS.flash_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    got = got.numpy().transpose(0, 2, 1, 3).reshape(b * h, sq, d)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arm", sorted(_variants_tool().ARMS))
def test_f32_variant_tool_arms_apply_to_the_checkout(arm):
    """Each named arm of the float32 forward's design ablation edits text
    that the checkout's ``flash.cu`` holds exactly once (the final arm is
    the source itself), so every arm still builds from today's source."""
    tool = _variants_tool()
    base = (_build.CSRC / "flash.cu").read_text()
    got = tool.variant_sources([arm])[arm]
    if not tool.ARMS[arm]:
        assert got == base
        return
    for sub in tool.ARMS[arm].split("@@"):
        assert base.count(sub.split("=>")[0]) == 1, (arm, sub)
    assert got != base


def test_f32_variant_tool_builds_another_commit_against_its_own_header(tmp_path):
    """A ``name:path`` variant is built with its own directory ahead of
    ``csrc`` on the include path, so an older ``flash.cu`` finds the
    ``hopper.cuh`` of its commit; the tool's float32 bound is
    ``chip_smoke.py``'s: at head dim 64 (whisper-medium's cross attention)
    3 x the operations at TF32's rate, the scalar one at float32's beside
    it, and at head dim 256 the scalar one alone."""
    tool = _variants_tool()
    cs = tool.cs
    old = tmp_path / "flash.cu"
    old.write_text("int x;")
    assert tool.source_dirs([f"parent:{old}", "final", "two=a=>b"]) == {"parent": tmp_path}
    for d, tf32 in ((64, True), (256, False)):
        nbytes, flops = cs.flash_work(1, 4096, 1500, 16, 16, d, False, None, 4)
        assert flops == 4 * d * 16 * 4096 * 1500
        mem = nbytes / cs.HBM_BYTES_PER_S * 1e3
        scalar = max(mem, flops / cs.FP32_FLOPS * 1e3)
        bnd = tool.bounds_ms(1, 4096, 1500, 16, 16, d, False, None, torch.float32)
        assert bnd == cs.flash_bound(nbytes, flops, torch.float32, tf32)
        if tf32:
            assert bnd["bound_ms"] == pytest.approx(max(mem, 3 * flops / cs.TF32_FLOPS * 1e3))
            assert bnd["scalar_bound_ms"] == pytest.approx(scalar)
        else:
            assert bnd["bound_ms"] == pytest.approx(scalar) and "scalar_bound_ms" not in bnd
    log = ("ptxas info    : Function properties for _ZN12_GLOBAL__N_117flash_tf32_kernelILi64EEEv\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "ptxas info    : Used 168 registers, used 1 barriers\n")
    assert tool.ptxas_report(log, "flash_tf32_kernel") == [(64, 168, 0, 0)]
