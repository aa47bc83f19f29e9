"""PyTorch port, categorical cofactors: sparse group-by blocks instead of
one-hot columns, held against the JAX package on the same numpy-seeded
relations.

Tolerances:
* the float64 numpy engine and the float64 host paths: 1e-12, with equal
  ``passes`` / ``node_visits`` and equal ``column_names``;
* float32 paths (the torch engine on the CPU, the grouped-Gram kernel's
  plain version): rtol 1e-5 / atol 1e-3 of entries up to ~1e5 — the same
  float32 values summed in another order than the reference's.
"""

import numpy as np
import pytest

import repro.core as R
import repro.core.categorical as RC
import repro.data.synthetic as RS
import repro_torch.core as P
import repro_torch.data.synthetic as PS

CONT = ["transactions", "onpromotion", "unit_sales"]
CAT = ["store_nbr", "item_nbr"]
FAV = dict(n_dates=8, n_stores=4, n_items=6, seed=3)
F64 = dict(rtol=1e-12, atol=1e-12)
F32 = dict(rtol=1e-5, atol=1e-3)


def _no_view_cache(bundle):
    """A store's persistent view cache lets later engines skip node
    visits; these tests share stores across engines, so the counters
    compare with the cache off in both packages."""
    bundle.store.view_cache.enabled = False
    return bundle


@pytest.fixture(scope="module")
def bundles():
    return (
        _no_view_cache(PS.favorita_like(**FAV)),
        _no_view_cache(RS.favorita_like(**FAV)),
    )


def _assert_cat(got, want, tol):
    assert got.cont == want.cont and got.cat == want.cat
    assert got.domains == want.domains
    assert got.column_names() == want.column_names()
    assert got.count == pytest.approx(want.count, rel=tol["rtol"])
    np.testing.assert_allclose(got.matrix(), want.matrix(), **tol)
    for key, coo in want.cat_cat.items():
        np.testing.assert_array_equal(got.cat_cat[key].rows, coo.rows)
        np.testing.assert_array_equal(got.cat_cat[key].cols, coo.cols)


def _oracle_matrix(bundle, cont, cat):
    joined = bundle.store.materialize_join()
    doms = {c: bundle.store.attr_domain(c) for c in cat}
    x, names = P.onehot_design_matrix(joined, cont, cat, doms)
    z = np.concatenate([np.ones((x.shape[0], 1)), x], axis=1)
    return z.T @ z, ["intercept"] + names


@pytest.mark.parametrize("cat", [["store_nbr"], CAT, CAT + ["date"]])
def test_factorized_and_per_pass_match_reference(bundles, cat):
    pb, rb = bundles
    pst, rst = {}, {}
    got = P.cat_cofactors_factorized(pb.store, pb.vorder, CONT, cat, stats=pst)
    want = R.cat_cofactors_factorized(rb.store, rb.vorder, CONT, cat, stats=rst)
    _assert_cat(got, want, F64)
    assert pst["passes"] == rst["passes"] == 1
    assert pst["node_visits"] == rst["node_visits"]
    pb.store.reset_counters()
    rb.store.reset_counters()
    per = P.cat_cofactors_per_pass(pb.store, pb.vorder, CONT, cat)
    rper = R.cat_cofactors_per_pass(rb.store, rb.vorder, CONT, cat)
    _assert_cat(per, rper, F64)
    assert pb.store.passes == rb.store.passes == 1 + len(cat) + len(cat) * (len(cat) - 1) // 2
    assert pb.store.node_visits == rb.store.node_visits
    np.testing.assert_allclose(per.matrix(), got.matrix(), **F64)
    oracle, names = _oracle_matrix(pb, CONT, cat)
    np.testing.assert_allclose(got.matrix(), oracle, rtol=1e-10, atol=1e-10)
    assert got.column_names() == names and got.nnz() < got.num_params ** 2


def test_torch_engine_matches_reference_jax(bundles):
    """The float32 engine on the CPU (the segment-view kernels' plain
    versions) against the reference's jax backend."""
    pb, rb = bundles
    got = P.cat_cofactors_factorized(pb.store, pb.vorder, CONT, CAT,
                                     backend="torch", device="cpu")
    want = R.cat_cofactors_factorized(rb.store, rb.vorder, CONT, CAT, backend="jax")
    _assert_cat(got, want, F32)
    per = P.cat_cofactors_per_pass(pb.store, pb.vorder, CONT, CAT,
                                   backend="torch", device="cpu")
    _assert_cat(per, want, F32)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_materialized_matches_reference(bundles, use_kernel):
    pb, rb = bundles
    got = P.cat_cofactors_materialized(pb.store, CONT, CAT, use_kernel=use_kernel,
                                       device="cpu")
    want = R.cat_cofactors_materialized(rb.store, CONT, CAT, use_kernel=use_kernel)
    _assert_cat(got, want, F32 if use_kernel else F64)
    oracle, _ = _oracle_matrix(pb, CONT, CAT)
    np.testing.assert_allclose(got.matrix(), oracle, rtol=1e-4, atol=1e-2)


def test_from_arrays_union_with_domain_growth_and_checks(bundles):
    pb, rb = bundles
    joined = pb.store.materialize_join()
    x = np.stack([joined.column(f).astype(float) for f in CONT], axis=1)
    ids = np.stack([joined.column(c).astype(np.int64) for c in CAT], axis=1)
    doms = {c: pb.store.attr_domain(c) for c in CAT}
    half = x.shape[0] // 2
    small = {c: int(ids[:half, i].max()) + 1 for i, c in enumerate(CAT)}
    a = P.cat_cofactors_from_arrays(x[:half], ids[:half], CONT, CAT, small)
    b = P.cat_cofactors_from_arrays(x[half:], ids[half:], CONT, CAT, doms)
    whole = P.cat_cofactors_from_arrays(x, ids, CONT, CAT, doms)
    np.testing.assert_allclose((a + b).matrix(), whole.matrix(), **F64)
    ra = RC.cat_cofactors_from_arrays(x[:half], ids[:half], CONT, CAT, small)
    rb_ = RC.cat_cofactors_from_arrays(x[half:], ids[half:], CONT, CAT, doms)
    _assert_cat(a + b, ra + rb_, F64)
    kern = P.cat_cofactors_from_arrays(x, ids, CONT, CAT, doms, use_kernel=True,
                                       device="cpu")
    _assert_cat(kern, whole, F32)
    bad = ids.copy()
    bad[0, 0] = -1
    with pytest.raises(ValueError, match="outside domain"):
        P.cat_cofactors_from_arrays(x, bad, CONT, CAT, doms)
    with pytest.raises(ValueError):
        P.cat_cofactors_from_arrays(x, ids[:, :1], CONT, CAT, doms)


def test_sparse_counts_and_projection_match_reference(bundles):
    coo = P.SparseCounts(np.array([0, 1, 0]), np.array([2, 0, 2]),
                         np.array([1.0, 2.0, 3.0]), (2, 3))
    total = coo + coo
    assert total.to_dense()[0, 2] == 8.0 and total.nnz == 2
    assert total.pad((3, 4)).shape == (3, 4)
    with pytest.raises(ValueError):
        total.pad((1, 3))
    np.testing.assert_array_equal(
        P.SparseCounts.from_dense(total.to_dense()).to_dense(), total.to_dense()
    )
    pb, rb = bundles
    got = P.cat_cofactors_factorized(pb.store, pb.vorder, CONT, CAT)
    want = R.cat_cofactors_factorized(rb.store, rb.vorder, CONT, CAT)
    keep = (["unit_sales", "transactions"], ["item_nbr", "store_nbr"])
    _assert_cat(got.project(*keep), want.project(*keep), F64)
    mat, names = got.regression_matrix("unit_sales")
    rmat, rnames = want.regression_matrix("unit_sales")
    assert names == rnames and names[-1] == "unit_sales"
    np.testing.assert_allclose(mat, rmat, **F64)
    with pytest.raises(ValueError):
        got.regression_matrix("nope")


def test_random_schemas_sparse_equals_onehot():
    for seed in range(6):
        kw = dict(seed=seed, n_branches=(seed % 3) + 1)
        b = PS.random_acyclic_schema(**kw)
        rb = _no_view_cache(RS.random_acyclic_schema(**kw))
        cat = ["k0"] + [f"k{i + 1}" for i in range(len(b.features) // 2)]
        cont = b.features + [b.label]
        stats = {}
        sparse = P.cat_cofactors_factorized(b.store, b.vorder, cont, cat,
                                            stats=stats)
        assert stats["passes"] == 1
        _assert_cat(sparse, R.cat_cofactors_factorized(rb.store, rb.vorder, cont, cat),
                    F64)
        oracle, _ = _oracle_matrix(b, cont, cat)
        np.testing.assert_allclose(sparse.matrix(), oracle, rtol=1e-9, atol=1e-9)


def test_many_categorical_attributes_fused():
    kw = dict(n_cat=12, domain=7, n_rows=150, seed=1)
    b, rb = PS.many_cat_schema(**kw), _no_view_cache(RS.many_cat_schema(**kw))
    cat = [f"c{i}" for i in range(12)]
    stats, rstats = {}, {}
    fused = P.cat_cofactors_factorized(b.store, b.vorder, ["x", "y"], cat, stats=stats)
    want = R.cat_cofactors_factorized(rb.store, rb.vorder, ["x", "y"], cat,
                                      stats=rstats)
    assert stats["passes"] == 1 and stats["node_visits"] == rstats["node_visits"]
    _assert_cat(fused, want, F64)
    oracle, _ = _oracle_matrix(b, ["x", "y"], cat)
    np.testing.assert_allclose(fused.matrix(), oracle, rtol=1e-9, atol=1e-9)


def test_onehot_design_matrix_matches_reference(bundles):
    pb, rb = bundles
    doms = {c: pb.store.attr_domain(c) for c in CAT}
    x, names = P.onehot_design_matrix(pb.store.materialize_join(), CONT, CAT, doms)
    rx, rnames = RC.onehot_design_matrix(rb.store.materialize_join(), CONT, CAT, doms)
    np.testing.assert_array_equal(x, rx)
    assert names == rnames
