"""PyTorch port, kernel layer on the CPU: the plain versions behind
``repro_torch.kernels.ops`` against the JAX package's kernels — its
``repro.kernels.ref`` oracles and its Pallas kernels in interpret mode —
over the cases of ``tests/test_kernels.py``: shape sweeps, k = 0, empty
segments, a single group, zero rows, float64 and a bad degree; for the
Gram family also forced group chunking, the per-column fallback, empty
segment columns and out-of-range ids.

The CUDA kernels themselves run only on a GPU (``chip_smoke.py`` holds
each against these plain versions there).  What the CPU can check of them
is checked here: the wrappers refuse CPU tensors, the compact per-group
sums the kernels write expand to the plain version's blocks, and the
build command targets ``sm_90a``.

Tolerances: float32 sums in another order than XLA's, rtol 1e-5 /
atol 1e-4 (the reference's own kernel tests use the same); float64 1e-13.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import gram as gk
from repro_torch.kernels import moments as mom
from repro_torch.kernels import segment_gram as sg
from repro_torch.kernels import segment_view as sv


def _inputs(m, k, g, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal(m).astype(dtype)
    x = rng.standard_normal(m).astype(dtype)
    l = rng.standard_normal((m, k)).astype(dtype)
    q = rng.standard_normal((m, k, k)).astype(dtype)
    seg = rng.integers(0, g, m).astype(np.int32)
    return c, x, l, q, seg


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _assert_blocks(got, want, rtol=1e-5, atol=1e-4):
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert tuple(a.shape) == tuple(np.asarray(b).shape)
            np.testing.assert_allclose(
                a.numpy(), np.asarray(b), rtol=rtol, atol=atol
            )


@pytest.mark.parametrize("m,g", [(5, 1), (200, 17)])
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("degree", [1, 2])
def test_segment_view_sweep_matches_reference(m, g, k, degree):
    c, x, l, q, seg = _inputs(m, k, g)
    qq = q if degree == 2 else None
    got = ops.segment_view(*_t(c, x, l), None if qq is None else _t(qq)[0],
                           seg, g, degree=degree)
    want = rref.segment_view_ref(c, x, l, q, seg, g, degree=degree)
    _assert_blocks(got, want)


@pytest.mark.parametrize("degree", [1, 2])
def test_segment_view_matches_pallas_interpret(degree):
    m, k, g = 200, 3, 17
    c, x, l, q, seg = _inputs(m, k, g, seed=4)
    qq = q if degree == 2 else None
    got = ops.segment_view(*_t(c, x, l), None if qq is None else _t(qq)[0],
                           seg, g, degree=degree)
    want = rops.segment_view(
        jnp.asarray(c), jnp.asarray(x), jnp.asarray(l),
        None if qq is None else jnp.asarray(qq), jnp.asarray(seg), g,
        degree=degree, impl="pallas", interpret=True,
    )
    _assert_blocks(got, want)


def test_segment_view_k0():
    """Views with no features yet (every relation leaf): l [M, 0]."""
    m, g = 37, 5
    c, x, _, _, seg = _inputs(m, 1, g)
    l, q = np.zeros((m, 0), np.float32), np.zeros((m, 0, 0), np.float32)
    got = ops.segment_view(*_t(c, x, l, q), seg, g, degree=2)
    _assert_blocks(got, rref.segment_view_ref(c, x, l, q, seg, g, degree=2))
    assert got[1].shape == (g, 1) and got[2].shape == (g, 1, 1)
    got1 = ops.segment_view(*_t(c, x, l), None, seg, g, degree=1)
    _assert_blocks(got1, rref.segment_view_ref(c, x, l, q, seg, g, degree=1))


def test_segment_view_empty_segments_and_dropped_ids():
    """Groups with no rows come out exactly zero; ids ≥ G drop, as in the
    reference oracle's ``mode='drop'`` scatter."""
    m, k, g = 40, 2, 8
    c, x, l, q, _ = _inputs(m, k, g)
    seg = np.where(np.arange(m) % 2 == 0, 1, 6).astype(np.int32)
    seg[::7] = g + 3
    got = ops.segment_view(*_t(c, x, l, q), seg, g, degree=2)
    _assert_blocks(got, rref.segment_view_ref(c, x, l, q, seg, g, degree=2))
    empty = [i for i in range(g) if i not in (1, 6)]
    assert np.all(got[0].numpy()[empty] == 0.0)
    assert np.all(got[2].numpy()[empty] == 0.0)


@pytest.mark.parametrize("degree", [1, 2])
def test_segment_view_single_group(degree):
    m, k = 63, 3
    c, x, l, q, _ = _inputs(m, k, 4)
    seg = np.zeros(m, np.int32)
    got = ops.segment_view(*_t(c, x, l), _t(q)[0] if degree == 2 else None,
                           seg, 1, degree=degree)
    _assert_blocks(got, rref.segment_view_ref(c, x, l, q, seg, 1, degree=degree))


def test_segment_view_zero_rows():
    z = torch.zeros(0)
    got = ops.segment_view(z, z, torch.zeros(0, 2), torch.zeros(0, 2, 2),
                           np.zeros(0, np.int32), 3, degree=2)
    assert got[0].shape == (3,) and bool((got[0] == 0).all())
    assert got[2].shape == (3, 3, 3) and bool((got[2] == 0).all())


def test_segment_view_fp64_matches_x64_reference():
    """float64 in, float64 accumulation out — comparable at 1e-13 to the
    reference oracle under x64."""
    m, k, g = 200, 3, 7
    c, x, l, q, seg = _inputs(m, k, g, dtype=np.float64, seed=3)
    got = ops.segment_view(*_t(c, x, l, q), seg, g, degree=2)
    assert got[0].dtype == got[2].dtype == torch.float64
    with jax.enable_x64(True):
        want = rref.segment_view_ref(
            jnp.asarray(c), jnp.asarray(x), jnp.asarray(l), jnp.asarray(q),
            jnp.asarray(seg), g, degree=2,
        )
        assert want[0].dtype == jnp.float64
        _assert_blocks(got, want, rtol=1e-13, atol=1e-13)


def test_bad_degree_raises():
    c, x, l, q, seg = _inputs(8, 2, 2)
    with pytest.raises(ValueError):
        ops.segment_view(*_t(c, x, l, q), seg, 2, degree=3)
    with pytest.raises(ValueError):
        ops.segment_blocks(*_t(c, l, q), seg, 2, degree=3)


@pytest.mark.parametrize("m,g", [(5, 1), (200, 17)])
@pytest.mark.parametrize("degree", [0, 1, 2])
def test_segment_blocks_sweep_matches_reference(m, g, degree):
    c, _, l, q, seg = _inputs(m, 3, g)
    got = ops.segment_blocks(
        *_t(c), _t(l)[0] if degree >= 1 else None,
        _t(q)[0] if degree == 2 else None, seg, g, degree=degree,
    )
    _assert_blocks(got, rref.segment_blocks_ref(c, l, q, seg, g, degree=degree))
    want = rops.segment_blocks(
        jnp.asarray(c), jnp.asarray(l), jnp.asarray(q), jnp.asarray(seg), g,
        degree=degree, impl="pallas", interpret=True,
    )
    _assert_blocks(got, want)


def test_segment_blocks_fp64():
    c, _, l, q, seg = _inputs(90, 2, 9, dtype=np.float64)
    got = ops.segment_blocks(*_t(c, l, q), seg, 9, degree=2)
    assert got[2].dtype == torch.float64
    with jax.enable_x64(True):
        want = rref.segment_blocks_ref(
            jnp.asarray(c), jnp.asarray(l), jnp.asarray(q), jnp.asarray(seg), 9
        )
        _assert_blocks(got, want, rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("m", [1, 37, 5000])
def test_moments_match_reference(m):
    x = np.random.default_rng(m).normal(3.0, 10.0, m).astype(np.float32)
    s, mx, n = ops.moments(torch.from_numpy(x))
    rs, rmx, rn = rops.moments(jnp.asarray(x), interpret=True)
    es, emx, _ = rref.moments_ref(jnp.asarray(x))
    assert n == rn == m
    np.testing.assert_allclose(float(s), float(rs), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(float(s), float(es), rtol=1e-5, atol=1e-3)
    assert float(mx) == float(rmx) == float(emx)


def test_moments_empty_and_fp64():
    s, mx, n = ops.moments(torch.zeros(0))
    assert n == 0 and float(s) == 0.0 and float(mx) == 0.0
    x = np.random.default_rng(1).standard_normal(300)
    s, mx, n = ops.moments(torch.from_numpy(x))
    assert s.dtype == torch.float64
    np.testing.assert_allclose(float(s), x.sum(), rtol=1e-13)
    assert float(mx) == np.abs(x).max()


@pytest.mark.parametrize("n,dom", [(1, 1), (37, 5), (500, 40), (64, 64)])
def test_group_ids_device_matches_np_unique(n, dom):
    """Stable-sort grouping is bit-compatible with np.unique: same ids,
    same ascending group order, same first-occurrence gathers."""
    key = np.random.default_rng(7).integers(0, dom, n).astype(np.int64)
    uniq, first, inv = np.unique(key, return_index=True, return_inverse=True)
    seg, num, dfirst = ops.group_ids_device(key, "cpu")
    assert num == len(uniq) and seg.dtype == torch.int32
    np.testing.assert_array_equal(seg.numpy(), inv.astype(np.int32))
    np.testing.assert_array_equal(dfirst, first)
    rseg, rnum, rfirst = rops.group_ids_device(key)
    np.testing.assert_array_equal(seg.numpy(), np.asarray(rseg))
    np.testing.assert_array_equal(dfirst, rfirst)


def test_group_ids_device_keeps_int64_keys():
    """Keys past the int32 range stay distinct (the JAX path without x64
    would narrow them to int32)."""
    key = np.array([2**40 + 1, 5, 2**40, 5, 2**40 + 1], dtype=np.int64)
    seg, num, first = ops.group_ids_device(key, "cpu")
    assert num == 3
    np.testing.assert_array_equal(seg.numpy(), [2, 0, 1, 0, 2])
    np.testing.assert_array_equal(first, [1, 2, 0])
    seg, num, first = ops.group_ids_device(np.zeros(0, np.int64), "cpu")
    assert num == 0 and seg.shape == (0,) and first.shape == (0,)


# -- what the CPU can check of the CUDA route -----------------------------------

def test_cpu_tensors_take_the_plain_version():
    ops.reset_launch_counts()
    c, x, l, q, seg = _inputs(50, 2, 6)
    ops.segment_view(*_t(c, x, l, q), seg, 6)
    ops.segment_view(*_t(c, x, l), None, seg, 6, degree=1)
    ops.segment_blocks(*_t(c, l, q), seg, 6)
    ops.moments(_t(c)[0])
    ops.gram(_t(l)[0])
    ops.segment_gram(_t(l)[0], seg, 6)
    ops.multi_segment_gram(_t(l)[0], np.stack([seg, seg], 1), [6, 6])
    qkv = torch.zeros(1, 8, 2, 16)
    ops.flash_attention(qkv, qkv, qkv)
    assert set(ops.launch_counts()) == {
        "segment_view", "segment_view1", "segment_reduce", "moments",
        "gram", "segment_gram", "multi_segment_gram", "flash",
    }
    assert all(v == 0 for v in ops.launch_counts().values())
    assert ops.fast_device_grouping("cuda") and not ops.fast_device_grouping("cpu")


def test_kernel_wrappers_refuse_cpu_tensors():
    c, x, l, q, seg = _t(*_inputs(10, 2, 3))
    with pytest.raises(ValueError):
        sv.segment_view(c, x, l, q, seg, 3)
    with pytest.raises(ValueError):
        sv.segment_blocks(c, l, q, seg, 3)
    with pytest.raises(ValueError):
        sv.segment_reduce(torch.zeros(10, 2), seg, 3)
    with pytest.raises(ValueError):
        mom.moments(c)
    with pytest.raises(ValueError):
        gk.gram(l)
    with pytest.raises(ValueError):
        sg.segment_gram(l, seg, 3)
    with pytest.raises(ValueError):
        sg.multi_segment_gram(l, torch.stack([seg, seg], 1), [3, 3])


def _compact_sums(c, x, l, q, seg, g, degree):
    """What the kernels write: per-group sums of each row's distinct
    entries, [c, xc, x·xc, l, x·l, q] (degree 2) or [c, xc, l] (degree 1)."""
    xc = x * c
    parts = [c[:, None], xc[:, None]]
    if degree == 2:
        parts += [(x * xc)[:, None], l, x[:, None] * l, q.reshape(len(c), -1)]
    else:
        parts.append(l)
    rows = torch.cat(parts, dim=1)
    out = torch.zeros((g, rows.shape[1]), dtype=rows.dtype)
    return out.index_add_(0, seg.long(), rows)


@pytest.mark.parametrize("k", [0, 1, 3])
@pytest.mark.parametrize("degree", [1, 2])
def test_kernel_sum_layout_expands_to_plain_blocks(k, degree):
    c, x, l, q, seg = _t(*_inputs(120, k, 9, dtype=np.float64))
    s = _compact_sums(c, x, l, q, seg, 9, degree)
    assert s.shape[1] == (3 + 2 * k + k * k if degree == 2 else k + 2)
    got = sv.expand_view_sums(s, k, degree)
    want = ref.segment_view_ref(c, x, l, q if degree == 2 else None, seg, 9,
                                degree=degree)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.is_contiguous()
            torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("degree", [0, 1, 2])
def test_block_packing_round_trips(degree):
    c, _, l, q, seg = _t(*_inputs(60, 2, 5, dtype=np.float64))
    data = sv.pack_blocks(c, l, q, degree)
    assert data.shape == (60, [1, 3, 7][degree]) and data.is_contiguous()
    sums = torch.zeros(5, data.shape[1], dtype=data.dtype).index_add_(
        0, seg.long(), data
    )
    got = sv.unpack_blocks(sums, 2, degree)
    want = ref.segment_blocks_ref(c, l, q, seg, 5, degree=degree)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


def test_build_targets_hopper_from_repo_sources(monkeypatch, tmp_path):
    assert set(_build.SOURCES) == {
        "segment_view", "moments", "gram", "segment_gram", "flash",
    }
    for name in _build.SOURCES:
        src = _build.CSRC / f"{name}.cu"
        assert src.exists()
        cmd = _build.nvcc_command(name, tmp_path / "x.so")
        assert "arch=compute_90a,code=sm_90a" in cmd and str(src) == cmd[-1]
        assert "-shared" in cmd and "-O3" in cmd
        path = _build.library_path(name)
        assert path.parent == _build.BUILD_DIR and path.suffix == ".so"
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build._nvcc()


# -- the Gram family ---------------------------------------------------------

def _gram_x(m, k, dtype=np.float32, seed=0):
    return (np.random.default_rng(seed).standard_normal((m, k)) * 3.0).astype(dtype)


@pytest.mark.parametrize("m", [1, 7, 129, 1000])
@pytest.mark.parametrize("k", [1, 3, 64, 130])
def test_gram_sweep_matches_pallas_interpret(m, k):
    """The kernel's small-K (≤ 8) and tiled (> 8) widths alike.  rtol 1e-5;
    atol 1e-2 covers near-zero off-diagonal entries, float32 sums of up to
    1000 products of magnitude ~10 taken in another order (the Pallas
    kernel's 512-row blocks)."""
    x = _gram_x(m, k, seed=m + k)
    got = ops.gram(torch.from_numpy(x))
    want = rops.gram(jnp.asarray(x), interpret=True)
    assert got.dtype == torch.float32 and got.shape == (k, k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-2)
    np.testing.assert_allclose(got.numpy(), np.asarray(rref.gram_ref(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-3)
    assert torch.equal(got, got.T)


def test_gram_fp64_empty_and_dtypes():
    x = _gram_x(300, 6, dtype=np.float64)
    got = ops.gram(torch.from_numpy(x))
    assert got.dtype == torch.float64
    with jax.enable_x64(True):
        want = np.asarray(jnp.asarray(x).T @ jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-13, atol=1e-12)
    assert ops.gram(torch.zeros(0, 4)).shape == (4, 4)
    assert bool((ops.gram(torch.zeros(0, 4)) == 0).all())
    with pytest.raises(ValueError):
        ops.gram(torch.zeros(5, 2, dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        ops.gram(torch.zeros(5))


@pytest.mark.parametrize("m,g", [(5, 1), (64, 4), (200, 17), (1000, 3)])
@pytest.mark.parametrize("k", [2, 9])
def test_segment_gram_sweep_matches_pallas_interpret(m, g, k):
    x = _gram_x(m, k, seed=m)
    seg = np.random.default_rng(g).integers(0, g, m).astype(np.int32)
    got = ops.segment_gram(torch.from_numpy(x), seg, g)
    want = rops.segment_gram(jnp.asarray(x), jnp.asarray(seg), g, interpret=True)
    assert got.shape == (g, k, k) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("budget", [40, 100, 200])
def test_segment_gram_forced_chunking_matches_unchunked(budget):
    """A tiny shared-memory budget drives the chunked path (6 values of
    4 bytes per group at k = 3: budget 40 gives one group per chunk)."""
    m, k, g = 57, 3, 10
    x = torch.from_numpy(_gram_x(m, k, seed=1))
    seg = np.random.default_rng(2).integers(0, g, m).astype(np.int32)
    chunked = ops.segment_gram(x, seg, g, smem_budget=budget)
    unchunked = ops.segment_gram(x, seg, g)
    np.testing.assert_allclose(chunked.numpy(), unchunked.numpy(), rtol=1e-6, atol=1e-6)
    want = rops.segment_gram(x.numpy(), jnp.asarray(seg), g, vmem_budget=budget,
                             interpret=True)
    np.testing.assert_allclose(chunked.numpy(), np.asarray(want), rtol=1e-5, atol=1e-3)


def test_segment_gram_group_chunking_at_default_budget():
    """4000 groups of k = 40 (820 distinct values each) exceed the default
    budget: the chunked result equals the reference's oracle."""
    m, k, g = 64, 40, 4000
    x = _gram_x(m, k, seed=5)
    seg = np.random.default_rng(5).integers(0, g, m).astype(np.int32)
    got = ops.segment_gram(torch.from_numpy(x), seg, g)
    want = rref.segment_gram_ref(jnp.asarray(x), jnp.asarray(seg), g)
    assert g * k * (k + 1) // 2 * 4 > ops.SMEM_ACC_BYTES
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-3)


def test_segment_gram_out_of_range_ids_and_fp64():
    """Negative and too-large ids add nothing (the zero one-hot row)."""
    x = _gram_x(6, 2, dtype=np.float64)
    seg = np.array([0, -1, 1, 5, 0, 2], np.int32)
    got = ops.segment_gram(torch.from_numpy(x), seg, 3)
    assert got.dtype == torch.float64
    want = np.zeros((3, 2, 2))
    for row, s in zip(x, seg):
        if 0 <= s < 3:
            want[s] += np.outer(row, row)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-14, atol=1e-14)
    chunked = ops.segment_gram(torch.from_numpy(x), seg, 3, smem_budget=24)
    np.testing.assert_allclose(chunked.numpy(), want, rtol=1e-14, atol=1e-14)
    assert ops.segment_gram(torch.zeros(0, 2), np.zeros(0, np.int32), 4).shape == (4, 2, 2)


@pytest.mark.parametrize("m", [5, 64, 200])
@pytest.mark.parametrize("doms", [[3], [4, 7], [5, 2, 9]])
def test_multi_segment_gram_matches_pallas_interpret(m, doms):
    x = _gram_x(m, 4, seed=m)
    rng = np.random.default_rng(len(doms))
    segs = np.stack([rng.integers(0, d, m) for d in doms], axis=1).astype(np.int32)
    got = ops.multi_segment_gram(torch.from_numpy(x), segs, doms)
    want = rops.multi_segment_gram(jnp.asarray(x), jnp.asarray(segs), doms,
                                   interpret=True)
    assert len(got) == len(want) == len(doms)
    for a, b, d in zip(got, want, doms):
        assert a.shape == (d, 4, 4)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-3)


def test_multi_segment_gram_fallback_and_empty_columns():
    """Over the budget the fused call falls back to one (chunked)
    segment_gram per column — same numbers; zero columns give []."""
    m, k, doms = 120, 3, [10, 6]
    x = torch.from_numpy(_gram_x(m, k, seed=9))
    rng = np.random.default_rng(9)
    segs = np.stack([rng.integers(0, d, m) for d in doms], axis=1).astype(np.int32)
    fused = ops.multi_segment_gram(x, segs, doms)
    tiny = ops.multi_segment_gram(x, segs, doms, smem_budget=200)
    want = rops.multi_segment_gram(x.numpy(), jnp.asarray(segs), doms,
                                   vmem_budget=200, interpret=True)
    for a, b, c in zip(fused, tiny, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(b.numpy(), np.asarray(c), rtol=1e-5, atol=1e-3)
    assert ops.multi_segment_gram(x, np.zeros((m, 0), np.int32), []) == []
    with pytest.raises(ValueError):
        ops.multi_segment_gram(x, segs, [10])


def test_grouped_gram_refuses_a_group_over_the_budget():
    """Chunking cannot go below one group: a K whose single accumulator
    (K(K+1)/2 values) exceeds the budget is refused on both paths."""
    x = torch.from_numpy(_gram_x(10, 3))
    seg = np.zeros(10, np.int32)
    with pytest.raises(ValueError, match="budget"):
        ops.segment_gram(x, seg, 2, smem_budget=20)
    with pytest.raises(ValueError, match="budget"):
        ops.multi_segment_gram(x, np.stack([seg, seg], 1), [2, 2], smem_budget=20)
    wide = torch.zeros(4, 314)
    with pytest.raises(ValueError, match="budget"):
        ops.segment_gram(wide, np.zeros(4, np.int32), 1)
    assert ops.segment_gram(torch.zeros(4, 313), np.zeros(4, np.int32), 1).shape == (1, 313, 313)


def test_gram_parts_cover_rows():
    """The row ranges the wrapper sizes its scratch for: at least one, at
    most one block of 256 rows each (K ≤ 8) or 32-row splits (tiled)."""
    assert gk.num_parts(1, 5) == 1 and gk.num_parts(18_641_880, 5) == 8 * 132
    assert gk.num_parts(1_000_000, 130) * 15 >= 4 * 132
    assert gk.num_parts(40, 130) == 2
