"""PyTorch port, factorized engine, held against the JAX package's engine
on the same relations (the port's generators are bit-identical to the
reference's, ``test_torch_relation.py``):

* the float64 numpy backend equals the reference's numpy backend to 1e-12;
* the torch backend (float32, CPU here) matches the reference's jax
  backend (float32) to rtol 1e-5 of the largest cofactor — both sum in
  float32, in different orders;
* fused ≡ unfused, and the torch backend at float64 ≡ the numpy oracle;
* group ids, group order and key layouts are exactly equal, and so are
  ``passes`` / ``node_visits``.

The reference runs with its view cache off: the port has none yet.
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro.core.factorize as RF
import repro.core.scaling as RSC
import repro.data.synthetic as RS
import repro_torch.core.factorize as PF
import repro_torch.core.scaling as PSC
import repro_torch.data.synthetic as PS

BUNDLES = [
    ("figure1", lambda m: m.figure1_schema()),
    ("favorita", lambda m: m.favorita_like(n_dates=8, n_stores=4, n_items=6, seed=3)),
] + [
    (f"acyclic{s}", lambda m, s=s: m.random_acyclic_schema(s))
    for s in (0, 1, 2, 7, 13, 42)
]


def _pair(make):
    return make(PS), make(RS)


def _engines(pb, rb, cols, backend, ref_backend=None, **kw):
    ref_backend = ref_backend or {"torch": "jax"}.get(backend, backend)
    port_kw = dict(kw, device="cpu") if backend == "torch" else dict(kw)
    ref_kw = {k: v for k, v in kw.items() if k != "dtype"}
    return (
        PF.FactorizedEngine(pb.store, pb.vorder, cols, backend=backend, **port_kw),
        RF.FactorizedEngine(rb.store, rb.vorder, cols, backend=ref_backend,
                            use_view_cache=False, **ref_kw),
    )


def _close32(a, b):
    b = np.asarray(b, dtype=np.float64)
    np.testing.assert_allclose(
        np.asarray(a), b, rtol=1e-5, atol=1e-5 * max(1.0, np.abs(b).max())
    )


@pytest.mark.parametrize("name,make", BUNDLES)
def test_numpy_backend_matches_reference_1e12(name, make):
    pb, rb = _pair(make)
    cols = pb.features + [pb.label]
    pe, re_ = _engines(pb, rb, cols, "numpy")
    got, want = pe.cofactors(), re_.cofactors()
    assert got.features == want.features
    np.testing.assert_allclose(got.matrix(), want.matrix(), rtol=1e-12, atol=1e-12)
    assert (pe.passes, pe.node_visits) == (re_.passes, re_.node_visits)


# the reference's jax path compiles per shape: two bundles keep it short
@pytest.mark.parametrize("name,make", BUNDLES[:2])
def test_torch_backend_matches_reference_jax_fp32(name, make):
    pb, rb = _pair(make)
    cols = pb.features + [pb.label]
    pe, re_ = _engines(pb, rb, cols, "torch")
    assert pe.use_node_kernels and re_.use_node_kernels
    got, want = pe.cofactors(), re_.cofactors()
    _close32(got.matrix(), want.matrix())
    assert (pe.passes, pe.node_visits) == (re_.passes, re_.node_visits)


@pytest.mark.parametrize("name,make", BUNDLES)
def test_fused_matches_unfused_and_fp64_oracle(name, make):
    pb = make(PS)
    cols = pb.features + [pb.label]
    mk = dict(backend="torch", device="cpu")
    fused = PF.FactorizedEngine(pb.store, pb.vorder, cols, **mk)
    unfused = PF.FactorizedEngine(pb.store, pb.vorder, cols,
                                  use_node_kernels=False, **mk)
    assert not unfused.use_node_kernels
    _close32(fused.cofactors().matrix(), unfused.cofactors().matrix())
    assert (fused.passes, fused.node_visits) == (unfused.passes, unfused.node_visits)
    exact = PF.FactorizedEngine(pb.store, pb.vorder, cols, backend="numpy")
    fused64 = PF.FactorizedEngine(pb.store, pb.vorder, cols, dtype=torch.float64, **mk)
    fused64.device_grouping = True  # the GPU's sort-based grouping, on the CPU
    np.testing.assert_allclose(
        fused64.cofactors().matrix(), exact.cofactors().matrix(),
        rtol=1e-12, atol=1e-12,
    )


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_scaled_cofactors_match_reference(backend):
    pb, rb = _pair(BUNDLES[1][1])
    cols = pb.features + [pb.label]
    pf = PSC.compute_scale_factors(pb.store, pb.features, pb.label)
    rf = RSC.compute_scale_factors(rb.store, rb.features, rb.label)
    assert pf.avg == rf.avg and pf.max == rf.max
    pe, re_ = _engines(pb, rb, cols, backend, scale=None)
    pe.scale, re_.scale = pf, rf
    got, want = pe.cofactors(), re_.cofactors()
    if backend == "numpy":
        np.testing.assert_allclose(got.matrix(), want.matrix(), rtol=1e-12, atol=1e-12)
    else:
        _close32(got.matrix(), want.matrix())
    # Cofactors algebra: rescaling the unscaled aggregates = scaled traversal
    raw = PF.FactorizedEngine(pb.store, pb.vorder, cols, backend="numpy").cofactors()
    rraw = RF.FactorizedEngine(rb.store, rb.vorder, cols, backend="numpy",
                               use_view_cache=False).cofactors()
    np.testing.assert_allclose(raw.rescale(pf).matrix(), rraw.rescale(rf).matrix(),
                               rtol=1e-12, atol=1e-9)
    keep = cols[1:3]
    np.testing.assert_array_equal(raw.project(keep).matrix(),
                                  rraw.project(keep).matrix())
    np.testing.assert_array_equal((raw + raw).matrix(), (rraw + rraw).matrix())


QUERIES = [
    ("base", (), 2),
    ("by_store", ("store_nbr",), 1),
    ("by_date_item", ("date", "item_nbr"), 2),
    ("count_by_item", ("item_nbr",), 0),
]


@pytest.mark.parametrize(
    "backend,device_grouping", [("numpy", False), ("torch", False), ("torch", True)]
)
def test_grouped_batch_keys_byte_identical(backend, device_grouping):
    """GROUP BY batches: the same group rows in the same order, key arrays
    byte-identical, blocks equal at the backend's tolerance, one pass."""
    pb, rb = _pair(BUNDLES[1][1])
    cols = ["onpromotion", "transactions", "unit_sales"]
    # float32 torch against the float64 reference: the jax leg is above
    pe, re_ = _engines(pb, rb, cols, backend, ref_backend="numpy")
    pe.device_grouping = device_grouping  # the GPU's sort-based grouping
    pq = [PF.AggregateQuery(*q) for q in QUERIES]
    rq = [RF.AggregateQuery(*q) for q in QUERIES]
    got, want = pe.run_batch(pq), re_.run_batch(rq)
    assert pe.passes == re_.passes == 1 and pe.node_visits == re_.node_visits
    for name, _, degree in QUERIES:
        g, w = got[name], want[name]
        assert list(g.keys) == list(w.keys) and g.features == w.features
        for a in w.keys:
            assert g.keys[a].dtype == w.keys[a].dtype
            assert g.keys[a].tobytes() == w.keys[a].tobytes()
            np.testing.assert_array_equal(g.ids(a), w.ids(a))
        for blk in ("count", "lin", "quad"):
            a, b = getattr(g, blk), getattr(w, blk)
            assert (a is None) == (b is None)
            if a is None:
                continue
            if backend == "numpy":
                np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
            else:
                _close32(a, b)


def test_grouped_cofactors_match_reference():
    pb, rb = _pair(BUNDLES[0][1])
    cols = ["Inventory", "Sale"]
    got = PF.grouped_cofactors_factorized(pb.store, pb.vorder, cols, ["L"],
                                          backend="numpy")
    want = RF.grouped_cofactors_factorized(rb.store, rb.vorder, cols, ["L"],
                                           backend="numpy")
    assert got.num_groups == want.num_groups and got.features == want.features
    np.testing.assert_array_equal(got.ids("L"), want.ids("L"))
    for blk in ("count", "lin", "quad"):
        np.testing.assert_allclose(getattr(got, blk), getattr(want, blk),
                                   rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError):
        PF.FactorizedEngine(pb.store, pb.vorder, cols, backend="numpy").grouped_cofactors()


def test_merge_and_scatter_match_reference():
    pb, rb = _pair(BUNDLES[1][1])
    parts = [
        ("a", ("onpromotion", "unit_sales"), [("q", (), 2), ("s", ("store_nbr",), 1)]),
        ("b", ("unit_sales", "transactions"), [("t", ("store_nbr",), 2)]),
    ]

    def build(mod):
        return [mod.BatchPart(rid, feats, tuple(mod.AggregateQuery(*q) for q in qs))
                for rid, feats, qs in parts]

    pm, rm = PF.merge_batches(build(PF)), RF.merge_batches(build(RF))
    assert pm.features == rm.features and pm.assignments == rm.assignments
    assert [dataclasses.astuple(q) for q in pm.queries] == [
        dataclasses.astuple(q) for q in rm.queries
    ]
    pe, re_ = _engines(pb, rb, pm.features, "numpy")
    got = PF.scatter_results(pm, build(PF), pe.run_batch(pm.queries))
    want = RF.scatter_results(rm, build(RF), re_.run_batch(rm.queries))
    for rid in ("a", "b"):
        for qn, w in want[rid].items():
            g = got[rid][qn]
            assert g.features == w.features
            np.testing.assert_allclose(g.count, w.count, rtol=1e-12)
            np.testing.assert_allclose(g.lin, w.lin, rtol=1e-12, atol=1e-12)
            assert (g.quad is None) == (w.quad is None)
    with pytest.raises(ValueError):
        PF.merge_batches([])


def test_engine_rejects_what_reference_rejects():
    pb = PS.figure1_schema()
    cols = pb.features + [pb.label]
    with pytest.raises(ValueError):
        PF.FactorizedEngine(pb.store, pb.vorder, cols, backend="jax")
    with pytest.raises(ValueError):
        PF.FactorizedEngine(pb.store, pb.vorder, cols, backend="numpy",
                            group_by=["Sale"])
    eng = PF.FactorizedEngine(pb.store, pb.vorder, cols, backend="numpy")
    with pytest.raises(ValueError):
        eng.run_batch([PF.AggregateQuery("a"), PF.AggregateQuery("a")])
    with pytest.raises(ValueError):
        eng.run_batch([PF.AggregateQuery("a", (), 3)])
    with pytest.raises(ValueError):
        eng.run_batch([PF.AggregateQuery("a", ("nope",), 1)])


def test_default_device_is_cuda_and_never_falls_back():
    pb = PS.figure1_schema()
    cols = pb.features + [pb.label]
    if torch.cuda.is_available():
        assert PF.FactorizedEngine(pb.store, pb.vorder, cols).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PF.FactorizedEngine(pb.store, pb.vorder, cols)
        with pytest.raises(RuntimeError):
            PF.cofactors_factorized(pb.store, pb.vorder, cols)
