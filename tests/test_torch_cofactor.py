"""PyTorch port, cofactor baselines (paper §3.4): the materialized ("noPre")
Gram, its streaming and grouped forms and the row engine, held against the
JAX package on the same numpy-seeded relations.

Tolerances:
* float64 host paths (row engine, the grouped host oracle): 1e-12;
* float32 Gram paths (``use_kernel`` on either side, or the plain product):
  rtol 1e-5 / atol 1e-4 of entries up to ~1e5 — both sum the same float32
  values in different orders (the reference's Pallas kernels run in
  interpret mode here; the port's kernels take their plain versions on the
  CPU, since these tensors lie on the CPU).
"""

import numpy as np
import pytest
import torch

import repro.core as R
import repro.data.synthetic as RS
import repro_torch.core as P
import repro_torch.data.synthetic as PS

F32 = dict(rtol=1e-5, atol=1e-4)
F64 = dict(rtol=1e-12, atol=1e-12)
FAV = dict(n_dates=8, n_stores=4, n_items=6, seed=3)


@pytest.fixture(scope="module")
def bundles():
    return PS.favorita_like(**FAV), RS.favorita_like(**FAV)


def _cols(b):
    return b.features + [b.label]


def _assert_cof(got, want, tol):
    assert got.features == want.features
    assert got.count == want.count
    np.testing.assert_allclose(got.lin, want.lin, **tol)
    np.testing.assert_allclose(got.quad, want.quad, **tol)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("scaled", [False, True])
def test_materialized_matches_reference(bundles, use_kernel, scaled):
    pb, rb = bundles
    pf = P.compute_scale_factors(pb.store, pb.features, pb.label) if scaled else None
    rf = R.compute_scale_factors(rb.store, rb.features, rb.label) if scaled else None
    got = P.cofactors_materialized(pb.store, _cols(pb), use_kernel=use_kernel,
                                   scale=pf, device="cpu")
    want = R.cofactors_materialized(rb.store, _cols(rb), use_kernel=use_kernel,
                                    scale=rf)
    _assert_cof(got, want, F32)
    assert got.quad.dtype == np.float64 and np.array_equal(got.quad, got.quad.T)


@pytest.mark.parametrize("name", ["figure1", "favorita"])
def test_row_engine_and_factorized_match_reference(bundles, name):
    pb, rb = bundles if name == "favorita" else (PS.figure1_schema(), RS.figure1_schema())
    got = P.cofactors_row_engine(pb.store, _cols(pb))
    _assert_cof(got, R.cofactors_row_engine(rb.store, _cols(rb)), F64)
    fact = P.cofactors_factorized(pb.store, pb.vorder, _cols(pb), backend="numpy")
    _assert_cof(fact, got, dict(rtol=1e-10, atol=1e-10))


def test_streaming_equals_one_shot_and_reference(bundles):
    pb, rb = bundles
    x = P.design_matrix(pb.store.materialize_join(), _cols(pb))
    one = P.cofactors_from_matrix(x, _cols(pb), use_kernel=True, device="cpu")
    for chunk_rows in (1, 7, x.shape[0], 10 * x.shape[0]):
        got = P.cofactors_streaming(x, _cols(pb), chunk_rows=chunk_rows, device="cpu")
        _assert_cof(got, one, F32)
    want = R.cofactors_streaming(x, _cols(rb), chunk_rows=7)
    _assert_cof(P.cofactors_streaming(x, _cols(pb), chunk_rows=7, device="cpu"), want, F32)
    chunked = P.cofactors_materialized(pb.store, _cols(pb), use_kernel=True,
                                       chunk_rows=5, device="cpu")
    _assert_cof(chunked, one, F32)
    # an iterable of chunks, empty ones skipped
    parts = [x[:3], x[3:3], x[3:]]
    _assert_cof(P.cofactors_streaming(iter(parts), _cols(pb), device="cpu"), one, F32)
    with pytest.raises(ValueError):
        P.cofactors_streaming(x, _cols(pb), device="cpu")
    with pytest.raises(ValueError):
        P.cofactors_streaming(x, _cols(pb), chunk_rows=0, device="cpu")
    with pytest.raises(ValueError):
        P.cofactors_streaming([x[:, :2]], _cols(pb), device="cpu")


@pytest.mark.parametrize("use_kernel", [False, True])
def test_from_matrix_matches_reference(use_kernel):
    x = np.random.default_rng(4).normal(0, 3, size=(500, 6))
    feats = [f"f{i}" for i in range(6)]
    got = P.cofactors_from_matrix(x, feats, use_kernel=use_kernel, device="cpu")
    want = R.cofactors_from_matrix(x, feats, use_kernel=use_kernel)
    _assert_cof(got, want, F32)
    empty = P.cofactors_from_matrix(np.zeros((0, 6)), feats, device="cpu")
    assert empty.count == 0 and not empty.quad.any()


def test_grouped_matches_reference_and_sums_to_global():
    rng = np.random.default_rng(0)
    z = rng.normal(size=(50, 3))
    seg = rng.integers(0, 6, 50)
    feats = ["a", "b", "c"]
    host = P.cofactors_grouped(z, seg, 6, feats, use_kernel=False)
    for got, want in zip(host, R.cofactors_grouped(z, seg, 6, feats, use_kernel=False)):
        _assert_cof(got, want, F64)
    kern = P.cofactors_grouped(z, seg, 6, feats, device="cpu")
    for got, want in zip(kern, R.cofactors_grouped(z, seg, 6, feats)):
        _assert_cof(got, want, F32)
    total = kern[0]
    for g in kern[1:]:
        total = total + g
    assert total.count == 50
    np.testing.assert_allclose(total.quad, z.T @ z, **F32)
    np.testing.assert_allclose(total.lin, z.sum(axis=0), **F32)


def test_grouped_out_of_range_segments_dropped_on_both_paths():
    z = np.random.default_rng(1).normal(size=(6, 2))
    seg = np.array([0, -1, 1, 5, 0, 2])  # -1 and 5 out of range for G = 3
    kern = P.cofactors_grouped(z, seg, 3, ["a", "b"], device="cpu")
    host = P.cofactors_grouped(z, seg, 3, ["a", "b"], use_kernel=False)
    assert [c.count for c in host] == [2.0, 1.0, 1.0]
    for got, want in zip(kern, host):
        _assert_cof(got, want, F32)


def test_gram_paths_default_to_cuda_and_never_fall_back(bundles):
    pb, _ = bundles
    x = np.ones((4, 2))
    if torch.cuda.is_available():
        assert P.cofactors_from_matrix(x, ["a", "b"]).count == 4
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.cofactors_from_matrix(x, ["a", "b"])
    with pytest.raises(RuntimeError):
        P.cofactors_grouped(x, np.zeros(4, np.int64), 1, ["a", "b"])
    with pytest.raises(RuntimeError):
        P.cofactors_materialized(pb.store, _cols(pb), use_kernel=True)
    # the host paths need no device
    assert P.cofactors_grouped(x, np.zeros(4, np.int64), 1, ["a", "b"],
                               use_kernel=False)[0].count == 4
