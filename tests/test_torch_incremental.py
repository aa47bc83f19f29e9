"""PyTorch port, incremental cofactor maintenance, held against the JAX
package's: ``Store.append``, the cofactor caches, the FD re-check of each
delta, maintained column moments and the ``use_cache`` warm retrain.

The correctness anchor is Prop. 4.1 union commutativity: after appends the
maintained cofactors equal a from-scratch recompute.  Every scenario runs
once per package on the same numpy-seeded relations and deltas; the two
records (matrices, θ, ``cache_info`` counters, view-cache state) must
agree — numpy backends to 1e-12, the port's torch backend (float32, on the
CPU here) against the reference's jax backend in float32 tolerance, and
counters, keys and layouts exactly.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import repro.core as RC
import repro.core.categorical as RCAT
import repro.core.factorize as RF
import repro.core.relation as RREL
import repro.core.store as RST
import repro.data.synthetic as RS
import repro_torch.core as PC
import repro_torch.core.categorical as PCAT
import repro_torch.core.factorize as PF
import repro_torch.core.relation as PREL
import repro_torch.core.store as PST
import repro_torch.data.synthetic as PS

CAT2 = ["c0", "c1", "d0", "d1"]
FEATS2 = ["x"] + CAT2


def _pkg(ref: bool, fp32: bool) -> types.SimpleNamespace:
    """One package's surface, plus the engine keywords of the backend."""
    if ref:
        bk = {"backend": "jax"} if fp32 else {"backend": "numpy"}
        core, cat, fac, rel, st, data = RC, RCAT, RF, RREL, RST, RS
    else:
        bk = {"backend": "torch", "device": "cpu"} if fp32 else {"backend": "numpy"}
        core, cat, fac, rel, st, data = PC, PCAT, PF, PREL, PST, PS
    closed = dataclasses.replace(core.VERSIONS["closed"], backend="numpy")
    if not ref:
        closed = dataclasses.replace(closed, device="cpu")
    return types.SimpleNamespace(
        ref=ref, bk=bk, core=core, data=data, Store=st.Store,
        Relation=rel.Relation, closed=closed,
        cofactors_factorized=fac.cofactors_factorized,
        cat_cofactors_factorized=cat.cat_cofactors_factorized,
    )


def _host(a):
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def vc_state(store):
    """The view cache's state in LRU order (backend names made common)."""
    out = []
    for key, e in store.view_cache.items():
        key = tuple(key._replace(backend={"jax": "torch"}.get(key.backend, key.backend)))
        v = e.view
        out.append((key, sorted(e.relations), e.version, e.nbytes, list(v.keys),
                    {a: np.asarray(c) for a, c in v.keys.items()},
                    _host(v.c), _host(v.l), _host(v.q), list(v.feats)))
    return out


def _same(got, want, rtol, path="obs"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            _same(got[k], want[k], rtol, f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, rtol, f"{path}[{i}]")
    elif isinstance(want, np.ndarray) or isinstance(got, np.ndarray):
        got, want = np.asarray(got), np.asarray(want)
        assert got.shape == want.shape, path
        if want.dtype.kind in "iub" or got.dtype.kind in "iub":
            np.testing.assert_array_equal(got, want, err_msg=path)
        else:
            scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
            np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale,
                                       err_msg=path)
    elif isinstance(want, float):
        assert got == pytest.approx(want, rel=rtol, abs=rtol), path
    else:
        assert got == want, path


def twin(scenario, fp32=False, **kw):
    """Run ``scenario`` on both packages; their records must agree."""
    want = scenario(_pkg(True, fp32), **kw)
    got = scenario(_pkg(False, fp32), **kw)
    _same(got, want, 1e-5 if fp32 else 1e-12)
    return got


def _info(store):
    return dict(store.cache_info())


def _sales_delta(m, n_rows, rng, n_dates=8, n_stores=4, n_items=6):
    return m.Relation.from_columns(
        "delta",
        {
            "date": rng.integers(0, n_dates, n_rows).astype(np.int32),
            "store_nbr": rng.integers(0, n_stores, n_rows).astype(np.int32),
            "item_nbr": rng.integers(0, n_items, n_rows).astype(np.int32),
        },
        {
            "unit_sales": rng.normal(10, 2, n_rows),
            "onpromotion": rng.integers(0, 2, n_rows).astype(np.float64),
        },
    )


def _favorita(m):
    b = m.data.favorita_like(n_dates=8, n_stores=4, n_items=6, seed=3)
    return b, b.features + [b.label]


def _warm_vs_cold(m, b, cols, tol=1e-12):
    warm = b.store.cofactors(b.vorder, cols, **m.bk)
    cold = m.cofactors_factorized(b.store, b.vorder, cols, use_view_cache=False,
                                  **m.bk)
    scale = max(1.0, float(np.abs(cold.matrix()).max()))
    np.testing.assert_allclose(warm.matrix(), cold.matrix(), rtol=tol,
                               atol=tol * scale)
    return warm.matrix()


FP32 = dict(argnames="fp32", argvalues=[False, True], ids=["numpy", "fp32"])


# ---------------------------------------------------------------------------
# Store.append + cache maintenance
# ---------------------------------------------------------------------------

def _merges(m):
    b, _ = _favorita(m)
    before = b.store.get("SalesF").num_rows
    merged = b.store.append("SalesF", _sales_delta(m, 13, np.random.default_rng(7)))
    assert merged.num_rows == before + 13 == b.store.get("SalesF").num_rows
    assert b.store.get("SalesF").domains["date"] == 8
    return [merged.rows(), merged.domains, _info(b.store)]


def test_append_merges_rows_and_domains():
    twin(_merges)


def test_append_requires_same_attributes():
    b = PS.favorita_like(n_dates=8, n_stores=4, n_items=6, seed=3)
    bad = PREL.Relation.from_columns("d", {"date": [0]}, {"unit_sales": [1.0]})
    with pytest.raises(ValueError):
        b.store.append("SalesF", bad)
    with pytest.raises(KeyError):
        b.store.append("NoSuchRelation", bad)
    assert b.store.cache_info()["pending_appends"] == 0


def _scratch(m):
    b, cols = _favorita(m)
    rng = np.random.default_rng(7)
    rec = [b.store.cofactors(b.vorder, cols, **m.bk).matrix()]
    for n in (17, 5, 29):  # repeated appends stack in the log
        b.store.append("SalesF", _sales_delta(m, n, rng))
        rec.append(_info(b.store))
    rec += [_warm_vs_cold(m, b, cols, 1e-5), _info(b.store), vc_state(b.store)]
    return rec


@pytest.mark.parametrize(**FP32)
def test_append_delta_equals_scratch_recompute(fp32):
    twin(_scratch, fp32=fp32)


def _dimension(m):
    b, cols = _favorita(m)
    b.store.cofactors(b.vorder, cols, **m.bk)
    delta = m.Relation.from_columns(
        "d", {"date": [0, 1, 2], "store_nbr": [0, 1, 2]},
        {"transactions": [111.0, 222.0, 333.0]},
    )
    b.store.append("Transactions", delta)
    return [_warm_vs_cold(m, b, cols, 1e-5), _info(b.store), vc_state(b.store)]


@pytest.mark.parametrize(**FP32)
def test_append_to_dimension_relation_maintains_cache(fp32):
    twin(_dimension, fp32=fp32)


def _interleaved(m):
    b, cols = _favorita(m)
    rng = np.random.default_rng(11)
    b.store.cofactors(b.vorder, cols, **m.bk)
    b.store.append("SalesF", _sales_delta(m, 11, rng))
    b.store.append("Transactions", m.Relation.from_columns(
        "d", {"date": [3], "store_nbr": [3]}, {"transactions": [999.0]}))
    b.store.append("SalesF", _sales_delta(m, 4, rng))
    pending = _info(b.store)
    assert pending["pending_relations"] == 2
    return [pending, _warm_vs_cold(m, b, cols, 1e-5), _info(b.store),
            vc_state(b.store)]


@pytest.mark.parametrize(**FP32)
def test_interleaved_appends_to_different_relations(fp32):
    twin(_interleaved, fp32=fp32)


def _hit_and_put(m):
    b, cols = _favorita(m)
    c1 = b.store.cofactors(b.vorder, cols, backend="numpy")
    assert b.store.cofactors(b.vorder, cols, backend="numpy") is c1
    n1 = b.store.cache_info()["entries"]
    b.store.put(b.store.get("Oil"))  # arbitrary mutation invalidates
    n2 = b.store.cache_info()["entries"]
    c3 = b.store.cofactors(b.vorder, cols, backend="numpy")
    np.testing.assert_allclose(c3.matrix(), c1.matrix(), rtol=1e-12)
    b.store.put(m.Relation.from_columns("Unrelated", {"zz": [0]}, {"w": [1.0]}))
    assert (n1, n2, b.store.cache_info()["entries"]) == (1, 0, 1)
    return [c3.matrix(), _info(b.store), vc_state(b.store)]


def test_cache_hit_and_put_invalidation():
    twin(_hit_and_put)


def _all_entries(m):
    b, cols = _favorita(m)
    b.store.cofactors(b.vorder, cols, backend="numpy")
    b.store.cofactors(b.vorder, cols[:2], backend="numpy")
    b.store.cofactors(b.vorder, cols, **({"backend": "jax"} if m.ref else
                                         {"backend": "torch", "device": "cpu"}))
    assert b.store.cache_info()["entries"] == 3  # keyed by features, backend
    b.store.append("SalesF", _sales_delta(m, 9, np.random.default_rng(5)))
    rec = [_warm_vs_cold(m, b, feats) for feats in (cols, cols[:2])]
    return rec + [_info(b.store)]


def test_append_maintains_all_cache_entries():
    twin(_all_entries)


def _moments(m):
    b, _ = _favorita(m)
    cols = b.features + [b.label]
    for f in cols:
        b.store.column_moments(f)  # seed the moments cache
    b.store.append("SalesF", _sales_delta(m, 21, np.random.default_rng(2)))
    maintained = [b.store.column_moments(f) for f in cols]
    factors = m.core.compute_scale_factors(b.store, b.features, b.label)
    fresh = m.Store(b.store.relations())  # same data, no caches
    expect = m.core.compute_scale_factors(fresh, b.features, b.label)
    for col in cols:
        np.testing.assert_allclose(factors.avg[col], expect.avg[col], rtol=1e-12)
        np.testing.assert_allclose(factors.max[col], expect.max[col], rtol=1e-12)
    b.store.put(b.store.get("SalesF"))  # put drops the affected moments
    after_put = m.core.compute_scale_factors(b.store, b.features, b.label)
    return [maintained, factors.avg, factors.max, after_put.avg]


def test_column_moments_maintained_under_append():
    twin(_moments)


def test_scale_factors_read_the_maintained_moments(monkeypatch):
    """The default scaling path reads ``store.column_moments`` — after an
    append it rescans no relation."""
    b = PS.favorita_like(n_dates=8, n_stores=4, n_items=6, seed=3)
    for f in b.features + [b.label]:
        b.store.column_moments(f)
    b.store.append("SalesF", _sales_delta(PC, 21, np.random.default_rng(2)))

    def rescan(*a, **k):
        raise AssertionError("moments rescanned the catalog")

    monkeypatch.setattr(PST, "_column_moments", rescan)
    factors = PC.compute_scale_factors(b.store, b.features, b.label)
    s, mx, n = b.store.column_moments(b.label)
    assert factors.avg[b.label] == s / n


def _warm_retrain(m):
    b, _ = _favorita(m)
    warm_cfg = dataclasses.replace(m.closed, use_cache=True)
    m.core.linear_regression(b.store, b.vorder, b.features, b.label, warm_cfg)
    b.store.append("SalesF", _sales_delta(m, 25, np.random.default_rng(3)))
    warm = m.core.linear_regression(b.store, b.vorder, b.features, b.label, warm_cfg)
    cold = m.core.linear_regression(b.store, b.vorder, b.features, b.label, m.closed)
    np.testing.assert_allclose(warm.theta, cold.theta, rtol=1e-8, atol=1e-8)
    return [warm.theta, cold.theta, _info(b.store)]


def test_warm_retrain_after_append_matches_cold():
    twin(_warm_retrain)


def _rescale(m):
    b, cols = _favorita(m)
    factors = m.core.compute_scale_factors(b.store, b.features, b.label)
    direct = m.cofactors_factorized(b.store, b.vorder, cols, backend="numpy",
                                    scale=factors)
    lazy = b.store.cofactors(b.vorder, cols, backend="numpy").rescale(factors)
    np.testing.assert_allclose(lazy.matrix(), direct.matrix(), rtol=1e-9, atol=1e-9)
    return [lazy.matrix(), _info(b.store)]


def test_rescale_matches_engine_scaled_compute():
    twin(_rescale)


def _fig1(m):
    b = m.data.figure1_schema()
    cols = b.features + [b.label]
    b.store.cofactors(b.vorder, cols, backend="numpy")
    b.store.append("Sales", m.Relation.from_columns("d", {"P": [0, 1]},
                                                    {"Sale": [5.0, 6.0]}))
    return [_warm_vs_cold(m, b, cols), _info(b.store), vc_state(b.store)]


def test_append_fig1_schema():
    twin(_fig1)


# ---------------------------------------------------------------------------
# The FD re-check of each delta
# ---------------------------------------------------------------------------

def _fd_bundle(m):
    b = m.data.fd_star_schema(n_cat=2, domain=12, dep_domain=4, n_rows=400, seed=5)
    b.store.infer_fds()
    return b


def _fd_key(m):
    b = _fd_bundle(m)
    reduced = b.store.cat_cofactors(b.vorder, ["x", "y"], CAT2, backend="numpy",
                                    reduce_fds=True)
    assert list(reduced.cat) == b.store.fd_reduction(CAT2).kept
    full = b.store.cat_cofactors(b.vorder, ["x", "y"], CAT2, backend="numpy")
    assert list(full.cat) == CAT2
    n = b.store.cache_info()["cat_entries"]
    b.store.drop_fd("c0", "d0")
    b.store.drop_fd("c1", "d1")
    assert (n, b.store.cache_info()["cat_entries"]) == (2, 1)
    return [reduced.matrix(), full.matrix(), _info(b.store)]


def test_cat_cache_key_carries_fd_signature():
    twin(_fd_key)


def _fd_reduced_append(m):
    b = _fd_bundle(m)
    b.store.cat_cofactors(b.vorder, ["x", "y"], CAT2, backend="numpy",
                          reduce_fds=True)
    rng = np.random.default_rng(9)
    n = 23
    b.store.append("Fact", m.Relation.from_columns(
        "d",
        {f"c{i}": rng.integers(0, 12, n).astype(np.int32) for i in range(2)},
        {"x": rng.normal(0, 2, n), "y": rng.normal(0, 2, n),
         "promo": rng.integers(0, 2, n).astype(np.float64)},
    ))
    warm = b.store.cat_cofactors(b.vorder, ["x", "y"], CAT2, backend="numpy",
                                 reduce_fds=True)
    red = b.store.fd_reduction(CAT2)
    cold = m.cat_cofactors_factorized(b.store, b.vorder, ["x", "y"], red.kept,
                                      backend="numpy", use_view_cache=False)
    np.testing.assert_allclose(warm.matrix(), cold.matrix(), rtol=1e-12, atol=1e-9)
    cat_cfg = dataclasses.replace(m.closed, categorical=tuple(CAT2))
    w = m.core.linear_regression(b.store, b.vorder, FEATS2, "y",
                                 dataclasses.replace(cat_cfg, use_cache=True))
    f = m.core.linear_regression(b.store, b.vorder, FEATS2, "y",
                                 dataclasses.replace(cat_cfg, use_fds=False))
    np.testing.assert_allclose(w.theta, f.theta, rtol=0, atol=1e-10)
    return [warm.matrix(), w.theta, _info(b.store), vc_state(b.store)]


def test_append_maintains_reduced_entries():
    twin(_fd_reduced_append)


def _fd_extend(m):
    b = _fd_bundle(m)
    b.store.append("Dim0", m.Relation.from_columns(
        "d", {"c0": [12], "d0": [2]}, {"w0": [0.0]}, {"c0": 13, "d0": 4}))
    fd = {(f.lhs, f.rhs): f for f in b.store.fds()}[("c0", "d0")]
    assert len(fd.mapping) == 13 and fd.mapping[12] == 2
    return [fd.mapping, fd.source]


def test_append_extends_mapping_with_new_ids():
    twin(_fd_extend)


def _conflict(m, b):
    d0 = b.store.get("Dim0")
    return m.Relation.from_columns(
        "d", {"c0": [0], "d0": [(int(d0.keys["d0"][0]) + 1) % 4]}, {"w0": [0.0]})


def _fd_falsified(m):
    b = _fd_bundle(m)
    b.store.cat_cofactors(b.vorder, ["x", "y"], CAT2, backend="numpy",
                          reduce_fds=True)
    b.store.append("Dim0", _conflict(m, b))
    pairs = {(f.lhs, f.rhs) for f in b.store.fds()}
    assert ("c0", "d0") not in pairs and ("c1", "d1") in pairs
    cat_cfg = dataclasses.replace(m.closed, categorical=tuple(CAT2))
    on = m.core.linear_regression(b.store, b.vorder, FEATS2, "y", cat_cfg)
    off = m.core.linear_regression(b.store, b.vorder, FEATS2, "y",
                                   dataclasses.replace(cat_cfg, use_fds=False))
    np.testing.assert_allclose(on.theta, off.theta, rtol=0, atol=1e-10)
    return [sorted(pairs), on.theta, _info(b.store)]


def test_append_falsifies_inferred_fd():
    twin(_fd_falsified)


def _fd_declared(m):
    b = _fd_bundle(m)
    b.store.add_fd("c0", "d0")
    rows, version, info = b.store.get("Dim0").num_rows, b.store.version, _info(b.store)
    with pytest.raises(ValueError, match="declared FD"):
        b.store.append("Dim0", _conflict(m, b))
    assert b.store.get("Dim0").num_rows == rows and b.store.version == version
    assert ("c0", "d0") in {(f.lhs, f.rhs) for f in b.store.fds()}
    assert _info(b.store) == info
    return [info]


def test_append_violating_declared_fd_raises_before_mutation():
    twin(_fd_declared)


# ---------------------------------------------------------------------------
# use_cache reads the store's float64 host entries
# ---------------------------------------------------------------------------

def test_use_cache_reads_host_entries_whatever_the_backend():
    """``use_cache=True`` reads the store's maintained cofactors, which are
    float64 numpy on the host whatever the config's backend and device say:
    a torch config and a numpy config give the same solution, cache only
    numpy entries, and agree with the reference at 1e-12."""
    b = PS.fd_star_schema(n_cat=2, domain=12, dep_domain=4, n_rows=400, seed=5)
    b.store.infer_fds()
    closed = dataclasses.replace(PC.VERSIONS["closed"], device="cpu",
                                 use_cache=True, categorical=tuple(CAT2))
    host = PC.linear_regression(b.store, b.vorder, FEATS2, "y",
                                dataclasses.replace(closed, backend="numpy"))
    torch_cfg = dataclasses.replace(closed, backend="torch")
    out = PC.linear_regression(b.store, b.vorder, FEATS2, "y", torch_cfg)
    np.testing.assert_array_equal(out.theta, host.theta)
    assert out.config == torch_cfg
    assert {k[3] for k in b.store._cat_cache} == {"numpy"}
    rb = RS.fd_star_schema(n_cat=2, domain=12, dep_domain=4, n_rows=400, seed=5)
    rb.store.infer_fds()
    ref = RC.linear_regression(rb.store, rb.vorder, FEATS2, "y",
                               dataclasses.replace(RC.VERSIONS["closed"],
                                                   backend="numpy", use_cache=True,
                                                   categorical=tuple(CAT2)))
    np.testing.assert_allclose(host.theta, ref.theta, rtol=1e-12, atol=1e-12)
