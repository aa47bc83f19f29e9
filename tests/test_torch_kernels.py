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

import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_jax_compat import enable_x64

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


#: the orders of segment ids the main path's traversal hands the kernels
#: (one per node kind): a random permutation (one row per group, onpromotion),
#: the identity (unit_sales and every regroup), ascending runs of distinct
#: groups restarting at each item (item_nbr), cyclic 0 … G−1 (store_nbr),
#: one group (date), and uniformly random ids (the worst case)
ID_ORDERS = ("permutation", "identity", "item_runs", "cyclic", "one_group", "random")


def _ids(order, m, seed=0):
    """(seg int32 [m], G, each group's row or None) for an id order: the
    rows come along where every group has one (the engine's ``order``)."""
    rng = np.random.default_rng(seed)
    if order == "permutation":
        seg = rng.permutation(m).astype(np.int32)
        return seg, m, np.argsort(seg).astype(np.int32)
    if order == "identity":
        return np.arange(m, dtype=np.int32), m, np.arange(m, dtype=np.int32)
    if order == "item_runs":  # 8 items, each a sorted sample of 40 groups
        g, items = 40, 8
        runs = [np.sort(rng.choice(g, size=-(-m // items), replace=False))
                for _ in range(items)]
        return np.concatenate(runs)[:m].astype(np.int32), g, None
    if order == "cyclic":
        return (np.arange(m) % 17).astype(np.int32), 17, None
    if order == "one_group":
        return np.zeros(m, np.int32), 1, None
    return rng.integers(0, 17, m).astype(np.int32), 17, None


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


@pytest.mark.parametrize("order", ID_ORDERS)
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("degree", [1, 2])
def test_segment_view_id_orders_match_reference(order, k, degree):
    m = 200
    seg, g, rows = _ids(order, m)
    c, x, l, q, _ = _inputs(m, k, g)
    qq = q if degree == 2 else None
    got = ops.segment_view(*_t(c, x, l), None if qq is None else _t(qq)[0],
                           seg, g, degree=degree, order=rows)
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
    with enable_x64():
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


@pytest.mark.parametrize("order", ID_ORDERS)
@pytest.mark.parametrize("degree", [0, 1, 2])
def test_segment_blocks_id_orders_match_reference(order, degree):
    seg, g, rows = _ids(order, 200, seed=1)
    c, _, l, q, _ = _inputs(200, 3, g)
    got = ops.segment_blocks(
        *_t(c), _t(l)[0] if degree >= 1 else None,
        _t(q)[0] if degree == 2 else None, seg, g, degree=degree, order=rows,
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
    with enable_x64():
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


@pytest.mark.parametrize("offset,m,dtype", [(1, 4_001, np.float32), (3, 4_098, np.float32),
                                            (0, 4_099, np.float32), (1, 333, np.float64)])
def test_moments_of_column_views(offset, m, dtype):
    """A column that is a view starting past a 16-byte boundary (the
    ``offset``-th value of its storage), and lengths that are not a
    multiple of 4: the count, max and sum of the reference's kernel."""
    base = np.random.default_rng(offset + m).normal(2.0, 5.0, m + offset).astype(dtype)
    col = torch.from_numpy(base)[offset:]
    assert col.is_contiguous() and (col.data_ptr() % 16 != 0) == (offset != 0)
    s, mx, n = ops.moments(col)
    assert n == m and s.dtype == col.dtype and float(mx) == np.abs(base[offset:]).max()
    if dtype == np.float32:
        rs, rmx, rn = rops.moments(jnp.asarray(base[offset:]), interpret=True)
        assert rn == m and float(mx) == float(rmx)
        np.testing.assert_allclose(float(s), float(rs), rtol=1e-5, atol=1e-3)
    else:
        np.testing.assert_allclose(float(s), base[offset:].sum(), rtol=1e-13)


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
    # the sort's order lists the rows group by group, each group's first
    # occurrence first
    seg4, num4, first4, order = ops.group_ids_device(key, "cpu", with_order=True)
    assert torch.equal(seg4, seg) and num4 == num and order.dtype == torch.int32
    assert np.all(np.diff(inv[order.numpy()]) >= 0)
    np.testing.assert_array_equal(np.sort(order.numpy()), np.arange(n))


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
        sv.segment_blocks(c, None, None, seg, 3, degree=0)
    with pytest.raises(ValueError):
        mom.moments(c)
    with pytest.raises(ValueError):
        gk.gram(l)
    with pytest.raises(ValueError):
        sg.segment_gram(l, seg, 3)
    with pytest.raises(ValueError):
        sg.multi_segment_gram(l, torch.stack([seg, seg], 1), [3, 3])


def _compact_rows(payload, c, x, l, q, degree=2):
    """The compact ``[M, W]`` rows the kernels sum (``value`` in
    ``csrc/segment_view.cu``): ``[c, xc, x·xc, l, x·l, q]`` for the view,
    ``[c | l | q]`` up to ``degree`` for the blocks."""
    m = c.shape[0]
    if payload == "view":
        xc = x * c
        parts = [c[:, None], xc[:, None], (x * xc)[:, None], l,
                 x[:, None] * l, q.reshape(m, -1)]
    else:
        parts = [c[:, None]]
        if degree >= 1:
            parts.append(l)
        if degree == 2:
            parts.append(q.reshape(m, -1))
    return torch.cat(parts, dim=1)


def _expand_sums(acc, payload, k, degree=2):
    """The blocks ``(c', l', q')`` from per-group compact sums ``acc [G, W
    or Wp]`` (``to_blocks`` / ``seg_finish`` in the source; padding columns
    ignored): the view's bordered blocks (x·l twice, by symmetry), or the
    blocks' ``c | l | q`` split, Nones past ``degree``."""
    g = acc.shape[0]
    c_new = acc[:, 0].clone()
    if payload == "view":
        sxl = acc[:, 3 + k : 3 + 2 * k]
        l_new = torch.cat([acc[:, 1:2], acc[:, 3 : 3 + k]], dim=1)
        q_new = torch.empty((g, k + 1, k + 1), dtype=acc.dtype)
        q_new[:, 0, 0] = acc[:, 2]
        q_new[:, 0, 1:] = sxl
        q_new[:, 1:, 0] = sxl
        q_new[:, 1:, 1:] = acc[:, 3 + 2 * k : 3 + 2 * k + k * k].reshape(g, k, k)
        return c_new, l_new, q_new
    kl = k if degree >= 1 else 0
    l_new = acc[:, 1 : 1 + kl].clone() if degree >= 1 else None
    q_new = None
    if degree == 2:
        q_new = acc[:, 1 + kl : 1 + kl + k * k].reshape(g, k, k).clone()
    return c_new, l_new, q_new


@pytest.mark.parametrize("k", [0, 1, 3])
@pytest.mark.parametrize("degree", [1, 2])
def test_kernel_sum_layout_expands_to_plain_blocks(k, degree):
    """The kernels' compact rows (``_compact_rows``), summed per group into
    path C's padded accumulator, land in the plain version's blocks through
    the finishing kernel's map (``_expand_sums``); degree 1 keeps its
    compact ``[c, xc, l]``, whose columns are the blocks themselves."""
    c, x, l, q, seg = _t(*_inputs(120, k, 9, dtype=np.float64))
    want = ref.segment_view_ref(c, x, l, q if degree == 2 else None, seg, 9,
                                degree=degree)
    if degree == 1:
        rows = torch.cat([c[:, None], (x * c)[:, None], l], dim=1)
        s = torch.zeros(9, k + 2, dtype=rows.dtype).index_add_(0, seg.long(), rows)
        got = (s[:, 0], s[:, 1:], None)
    else:
        rows = _compact_rows("view", c, x, l, q)
        p = sv.plan("view", k, 2, False)
        assert rows.shape[1] == p["width"] == 3 + 2 * k + k * k
        acc = torch.full((9, p["padded"]), float("nan"), dtype=rows.dtype)
        acc[:, : p["width"]] = 0
        acc[:, : p["width"]].index_add_(0, seg.long(), rows)
        got = _expand_sums(acc, "view", k)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("degree", [0, 1, 2])
def test_block_packing_round_trips(degree):
    """The blocks payload's compact row ``[c | l | q]`` (up to ``degree``),
    summed per group, splits back into the plain version's blocks."""
    c, _, l, q, seg = _t(*_inputs(60, 2, 5, dtype=np.float64))
    data = _compact_rows("blocks", c, None, l, q, degree)
    assert data.shape == (60, [1, 3, 7][degree]) and data.is_contiguous()
    assert data.shape[1] == sv.plan("blocks", 2, degree, False)["width"]
    sums = torch.zeros(5, data.shape[1], dtype=data.dtype).index_add_(
        0, seg.long(), data
    )
    got = _expand_sums(sums, "blocks", 2, degree)
    want = ref.segment_blocks_ref(c, l, q, seg, 5, degree=degree)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


#: (node, payload, rows, k, degree, groups, each group's row passed) at
#: the main path's sizes, and the path and layout each must take
MAIN_PATH_PLANS = [
    ("onpromotion", "view", 18_641_880, 0, 2, 18_641_880, True, ("one_row", 3, 4)),
    ("unit_sales", "view", 18_641_880, 1, 2, 18_641_880, True, ("one_row", 6, 8)),
    ("item_nbr", "view", 18_641_880, 2, 2, 90_936, False, ("atomic", 11, 12)),
    ("store_nbr", "view", 90_936, 3, 2, 1_684, False, ("atomic", 18, 20)),
    ("date", "view", 1_684, 4, 2, 1, False, ("atomic", 27, 28)),
    ("transactions", "blocks", 90_936, 0, 2, 90_936, True, ("one_row", 1, 4)),
    ("cluster", "blocks", 54, 0, 2, 54, True, ("one_row", 1, 4)),
    # the degree-1 batch's nodes (and the categorical leg's g: queries)
    ("onpromotion-view1", "view1", 18_641_880, 0, 1, 18_641_880, True, ("one_row", 2, 4)),
    ("unit_sales-view1", "view1", 18_641_880, 1, 1, 18_641_880, True, ("one_row", 3, 4)),
    ("item_nbr-view1", "view1", 18_641_880, 2, 1, 90_936, False, ("atomic", 4, 4)),
    ("store_nbr-view1", "view1", 90_936, 3, 1, 1_684, False, ("atomic", 5, 8)),
    ("date-view1", "view1", 1_684, 4, 1, 1, False, ("atomic", 6, 8)),
]


@pytest.mark.parametrize("case", MAIN_PATH_PLANS, ids=[c[0] for c in MAIN_PATH_PLANS])
def test_plan_mirror_at_main_path_nodes(case):
    """The Python mirror of the library's path choice at each node of the
    traversal (``chip_smoke.py`` holds it equal to the library's own)."""
    _, payload, _rows, k, degree, _g, one_row, (path, w, wp) = case
    p = sv.plan(payload, k, degree, one_row)
    assert (p["path"], p["width"], p["padded"]) == (path, w, wp)
    assert p["padded"] % 4 == 0 and p["width"] <= p["padded"] < p["width"] + 4


@pytest.mark.parametrize("degree", [0, 1, 2])
def test_plan_takes_one_row_path_only_with_order(degree):
    """Path A is taken exactly where the caller passes each group's row,
    whatever the width; the blocks' width counts the blocks up to
    ``degree``."""
    for k in (0, 1, 3, 40):
        assert sv.plan("blocks", k, degree, True)["path"] == "one_row"
        assert sv.plan("blocks", k, degree, False)["path"] == "atomic"
        assert sv.plan("blocks", k, degree, False)["width"] == (
            1 + (k if degree >= 1 else 0) + (k * k if degree == 2 else 0))
    assert sv.plan("view", 3, 2, True)["path"] == "one_row"
    for k in (0, 1, 3, 40):  # degree 1: [c, xc, l]
        assert sv.plan("view1", k, 1, True)["path"] == "one_row"
        assert sv.plan("view1", k, 1, False)["path"] == "atomic"
        assert sv.plan("view1", k, 1, False)["width"] == k + 2
    assert sv.PATHS == ("one_row", "atomic")


@pytest.mark.parametrize("order", ["random", "item_runs", "one_group"])
def test_plain_versions_refuse_a_false_one_row_statement(order):
    """An ``order`` passed where a group has no row or more than one fails
    on the CPU: ids that repeat, miss a group or fall outside it."""
    seg, g, _ = _ids(order, 40)
    c, x, l, q, _ = _t(*_inputs(40, 2, g))
    rows = np.arange(40, dtype=np.int32)
    for groups in (g, 40):
        with pytest.raises(ValueError, match="one row per group"):
            ops.segment_view(c, x, l, q, seg, groups, order=rows)
        with pytest.raises(ValueError, match="one row per group"):
            ops.segment_blocks(c, l, q, seg, groups, order=rows)
    bad = np.arange(40, dtype=np.int32)
    bad[3] = 40  # out of range, so group 3 has no row
    with pytest.raises(ValueError, match="one row per group"):
        ref.segment_blocks_ref(c, l, q, torch.from_numpy(bad), 40,
                               order=torch.from_numpy(rows))
    perm = np.random.default_rng(0).permutation(40).astype(np.int32)
    ref.segment_view_ref(c, x, l, q, torch.from_numpy(perm), 40,
                         order=torch.from_numpy(np.argsort(perm).astype(np.int32)))


def test_plain_versions_check_the_order_of_groups():
    """``order`` must list each group's row (the inverse permutation of the
    ids), and with it the outputs equal those without it exactly."""
    seg = np.random.default_rng(1).permutation(40).astype(np.int32)
    order = np.argsort(seg).astype(np.int32)
    c, x, l, q, _ = _t(*_inputs(40, 2, 40))
    want = ref.segment_view_ref(c, x, l, q, torch.from_numpy(seg), 40)
    got = ops.segment_view(c, x, l, q, seg, 40, order=order)
    _assert_blocks(got, [w.numpy() for w in want], rtol=0, atol=0)
    got = ops.segment_blocks(c, l, q, seg, 40, order=order)
    _assert_blocks(got, [w.numpy() for w in ref.segment_blocks_ref(
        c, l, q, torch.from_numpy(seg), 40)], rtol=0, atol=0)
    for bad in (seg, np.roll(order, 1), np.where(order == 0, 40, order).astype(np.int32),
                order[:39]):
        with pytest.raises(ValueError, match="order"):
            ops.segment_view(c, x, l, q, seg, 40, order=bad)
        with pytest.raises(ValueError, match="order"):
            ops.segment_blocks(c, l, q, seg, 40, order=bad)


@pytest.mark.parametrize("order", ["permutation", "identity"])
@pytest.mark.parametrize("k", [0, 1, 3])
def test_segment_view1_order_matches_pallas_interpret(order, k):
    """Degree 1 with each group's row passed (path A on the card: the
    onpromotion and unit_sales nodes): the plain version against the
    reference's ``segment_view1_kernel_call`` in interpret mode."""
    m = 96
    seg, g, rows = _ids(order, m, seed=k)
    c, x, l, _, _ = _inputs(m, k, g, seed=7)
    got = ops.segment_view(*_t(c, x, l), None, seg, g, degree=1, order=rows)
    want = rops.segment_view(
        jnp.asarray(c), jnp.asarray(x), jnp.asarray(l), None, jnp.asarray(seg), g,
        degree=1, impl="pallas", interpret=True,
    )
    assert got[2] is None and tuple(got[1].shape) == (g, k + 1)
    _assert_blocks(got, want)


#: (what, k, groups per column, value bytes) and the grouped-Gram plan each
#: must take: (split, entries a CTA, launches, copies of each hot band)
GRAM_PLANS = [
    ("multi K 4 store+item", 4, [54, 4_100], 4, (1, 10, 1, 16)),
    ("K 6 item", 6, [4_100], 4, (2, 11, 1, 1)),
    ("K 40 chunked", 40, [4_000], 4, (8, 103, 9, 1)),
    ("K 6 item float64", 6, [4_100], 8, (5, 5, 1, 1)),
    ("K 313 one group", 313, [1], 4, (2, 24_571, 1, 1)),
    ("K 2 sixteen columns", 2, [96] * 8 + [48] * 8, 4, (1, 3, 1, 8)),
    ("K 4 store float64", 4, [54], 8, (1, 10, 1, 16)),
    ("hot at 256 groups, four copies fit", 4, [256, 4_000], 4, (1, 10, 1, 4)),
    ("not hot at 257 groups", 4, [257, 4_000], 4, (1, 10, 1, 1)),
]


def _gram_acc_len(groups, e, copies):
    return sum(g * (e | 1) * copies if g <= 256 and copies > 1 else g * e for g in groups)


@pytest.mark.parametrize("case", GRAM_PLANS, ids=[c[0] for c in GRAM_PLANS])
def test_grouped_gram_plan_mirror(case):
    """The Python mirror of the grouped-Gram launch plan (``chip_smoke.py``
    holds it equal to the library's ``segment_gram_plan``): a split of one
    where one CTA holds the accumulator (K 4, G 54 + 4,100) with sixteen
    copies of the hot store band (at most 256 groups), one launch of two
    CTAs at K 6 and G 4,100 (no hot band: one copy), chunks at K 40 and G
    4,000, fewer copies where sixteen do not fit; and the layout fits a
    Hopper block."""
    _, k, groups, elem, (split, entries, chunks, copies) = case
    total = sum(groups)
    p = sg.plan(k, groups, elem)
    assert (p["split"], p["entries"], p["chunks"], p["copies"]) == (
        split, entries, chunks, copies)
    nt = k * (k + 1) // 2
    assert p["split"] * p["entries"] >= nt > (p["split"] - 1) * p["entries"]
    assert p["rows"] % 4 == 0 and p["rows"] >= 4 and p["stages"] in (1, 2, 4, 8)
    ring = p["stages"] * p["rows"] * (k * elem + 4 * len(groups))
    avail = (232_448 - 128 - ring) // elem
    n = (_gram_acc_len(groups, p["entries"], p["copies"]) if chunks == 1
         else min(total, p["most"]) * p["entries"])
    assert p["smem"] == 128 + ring + (n + 3) // 4 * 4 * elem <= 232_448
    assert (p["chunks"] == 1) == (total <= p["most"])
    if split > 1 and chunks == 1:  # the least split that holds it
        fewer = -(-nt // (split - 1))
        assert total * fewer * elem > 232_448 - 128 - ring - 3 * elem
    if chunks == 1 and copies < 16 and min(groups) <= 256:  # the most copies that fit
        assert _gram_acc_len(groups, p["entries"], 2 * copies) + 3 > avail
    # ops chunks by ``most``: the total and the number of columns set it
    assert sg.plan(k, [total] + [0] * (len(groups) - 1), elem)["most"] == p["most"]


def test_segment_gram_chunks_where_one_launch_cannot_hold():
    """More groups than a split of 8 holds at K 6 (16,969): the ops layer
    chunks by the plan, on both paths, and the result equals the
    reference's."""
    m, k, g = 300, 6, 17_200
    assert sg.plan(k, g, 4)["chunks"] == 2
    x = _gram_x(m, k, seed=3)
    seg = np.random.default_rng(3).integers(0, g, m).astype(np.int32)
    got = ops.segment_gram(torch.from_numpy(x), seg, g)
    want = rref.segment_gram_ref(jnp.asarray(x), jnp.asarray(seg), g)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-3)


def test_multi_segment_gram_falls_back_where_one_launch_cannot_hold():
    """A fused accumulator over what one launch holds (K 6, 17,100 groups
    in two columns) falls back to one segment_gram per column."""
    m, k, doms = 200, 6, [17_000, 100]
    assert sg.plan(k, doms, 4)["chunks"] > 1
    x = torch.from_numpy(_gram_x(m, k, seed=4))
    rng = np.random.default_rng(4)
    segs = np.stack([rng.integers(0, d, m) for d in doms], axis=1).astype(np.int32)
    got = ops.multi_segment_gram(x, segs, doms)
    for i, (a, d) in enumerate(zip(got, doms)):
        want = rref.segment_gram_ref(jnp.asarray(x.numpy()), jnp.asarray(segs[:, i]), d)
        np.testing.assert_allclose(a.numpy(), np.asarray(want), rtol=1e-5, atol=1e-3)


def _tool(name):
    """``tools/<name>.py`` (a script, not a package) as a module."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "tools" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tool_arms():
    out = []
    for tool in ("segment_gram_variants", "segment_view_variants"):
        for arm, spec in _tool(tool).EDITS.items():
            pairs = spec.items() if isinstance(spec, dict) else [spec]
            out += [(tool, arm, kind, edits) for kind, edits in pairs]
    return out


@pytest.mark.parametrize("tool,arm,kind,edits", _tool_arms(),
                         ids=[f"{t}:{a}:{k}" for t, a, k, _ in _tool_arms()])
def test_ablation_tool_edits_apply_to_the_checkout(tool, arm, kind, edits):
    """Each ablation arm's (old text, new text) edits name text that the
    checkout's kernel source or wrapper holds exactly once, so the arm
    still builds from today's source."""
    mod = _tool(tool)
    base = (_build.CSRC / f"{tool.split('_variants')[0]}.cu" if kind == "cu"
            else mod.WRAPPER).read_text()
    for old, _ in edits:
        assert base.count(old) == 1, (arm, old)
    assert mod.edited(arm, kind, edits) != base


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


def test_enable_x64_takes_the_spelling_jax_has(monkeypatch):
    """``torch_jax_compat.enable_x64`` uses ``jax.enable_x64`` where JAX
    has it and ``jax.experimental.enable_x64`` where it does not (the 0.4
    series that CI pins)."""
    import jax
    import jax.experimental

    used = []

    def legacy():
        used.append("experimental")
        return "legacy context"

    monkeypatch.setattr(jax.experimental, "enable_x64", legacy, raising=False)
    if hasattr(jax, "enable_x64"):
        with enable_x64():
            assert jnp.zeros(1, jnp.float64).dtype == jnp.float64
        monkeypatch.delattr(jax, "enable_x64")
    assert enable_x64() == "legacy context" and used == ["experimental"]


def test_first_load_builds_and_loads_once_across_threads(monkeypatch, tmp_path):
    """Kernels first run on the factorized service's drain worker: eight
    threads asking for one function at once build once and load once, and
    ``build`` names its temporary output by process and thread."""
    import ctypes
    import threading

    lib_path = tmp_path / "segment_view-x.so"
    calls = {"build": 0, "load": 0}
    gate = threading.Barrier(8)

    def build():
        calls["build"] += 1
        threading.Event().wait(0.05)  # a slow nvcc, so the threads overlap
        lib_path.write_bytes(b"")

    class Lib:
        def __init__(self, path):
            calls["load"] += 1
            self.sym = types.SimpleNamespace(argtypes=None, restype=None)

    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "library_path", lambda name: lib_path)
    monkeypatch.setattr(_build, "build", build)
    monkeypatch.setattr(ctypes, "CDLL", Lib)
    got = []

    def worker():
        gate.wait(5)
        got.append(_build.function("segment_view", "sym", [ctypes.c_int]))

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
        assert not t.is_alive()
    assert calls == {"build": 1, "load": 1}
    assert len(got) == 8 and all(fn is got[0] for fn in got)
    assert got[0].argtypes == [ctypes.c_int] and got[0].restype is ctypes.c_int

    names = []
    both = threading.Barrier(2)  # both build calls alive: distinct thread ids

    class Popen:
        def __init__(self, cmd, **kw):
            names.append(cmd[cmd.index("-o") + 1])
            both.wait(5)
            self.returncode = 1

        def communicate(self):
            return "", None

    monkeypatch.undo()
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "library_path",
                        lambda name: tmp_path / f"{name}-x.so")
    monkeypatch.setattr(_build.subprocess, "Popen", Popen)
    failed = []

    def build_twice():
        with pytest.raises(RuntimeError, match="build failed"):
            _build.build(("moments",))
        failed.append(True)

    threads = [threading.Thread(target=build_twice) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
        assert not t.is_alive()
    assert len(set(names)) == 2 and len(failed) == 2
    for name in names:
        assert f".{os.getpid()}." in name and name.endswith(".tmp.so")


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
    with enable_x64():
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
    """4000 groups of k = 40 (820 distinct values each) exceed what one
    launch holds: the chunked result equals the reference's oracle."""
    m, k, g = 64, 40, 4000
    x = _gram_x(m, k, seed=5)
    seg = np.random.default_rng(5).integers(0, g, m).astype(np.int32)
    got = ops.segment_gram(torch.from_numpy(x), seg, g)
    want = rref.segment_gram_ref(jnp.asarray(x), jnp.asarray(seg), g)
    assert sg.plan(k, g, 4)["chunks"] > 1
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


def test_engine_states_one_row_per_group_where_groups_equal_rows(monkeypatch):
    """A small Favorita traversal on the CPU: every fused node and regroup
    states one row per group (passes ``order``) exactly where its group
    count equals its row count (the plain versions check each statement),
    both kinds occur, and
    the cofactors still equal the float64 numpy engine's."""
    import repro_torch.core.factorize as PF
    import repro_torch.data.synthetic as PS

    calls = []

    def spy(name, fn):
        def wrapped(c, *args, **kwargs):
            seg, num = args[-2], args[-1]
            order = kwargs["order"]
            calls.append((name, c.shape[0], int(num), order is not None))
            if order is not None:  # each group's one row
                assert torch.equal(seg.long()[order.long()], torch.arange(int(num)))
            return fn(c, *args, **kwargs)
        return wrapped

    monkeypatch.setattr(PF.kernel_ops, "segment_view",
                        spy("segment_view", ops.segment_view))
    monkeypatch.setattr(PF.kernel_ops, "segment_blocks",
                        spy("segment_blocks", ops.segment_blocks))
    b = PS.favorita_like(n_dates=8, n_stores=4, n_items=6, seed=3)
    cols = b.features + [b.label]
    eng = PF.FactorizedEngine(b.store, b.vorder, cols, backend="torch",
                              dtype=torch.float64, device="cpu")
    eng.device_grouping = True  # the GPU's sort-based grouping, on the CPU
    got = eng.cofactors().matrix()
    assert {n for n, *_ in calls} == {"segment_view", "segment_blocks"}
    assert all(stated == (rows == num) for _, rows, num, stated in calls)
    assert {stated for *_, stated in calls} == {True, False}
    exact = PF.FactorizedEngine(b.store, b.vorder, cols, backend="numpy")
    np.testing.assert_allclose(got, exact.cofactors().matrix(), rtol=1e-12, atol=1e-12)
