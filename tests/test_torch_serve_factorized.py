"""PyTorch port, the multi-tenant factorized service held against the JAX
package's: snapshot isolation, batch coalescing (``merge_batches`` /
``scatter_results``), the service's train / score / cofactor / aggregate
requests, coalesced ≡ sequential schedules, exact per-tenant accounting and
cross-dtype view reuse — one twin of each test of
``tests/test_serve_factorized.py``, plus the port's device rules.

Every scenario runs once per package on the same numpy-seeded relations
(``torch_serve_twin.twin``): the numpy backends agree to 1e-12, the port's
torch backend (float32, ``device="cpu"``) with the reference's jax backend
to 1e-5, and counters, tenant maps, keys and error types exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

from torch_serve_twin import FP32, info, outcome, pkg, same, tight, twin, value

CAT2 = ["c0", "c1"]


def _star(m, n_dims=3, domain=8, fact_rows=300, dim_rows=40, seed=0):
    """Fact(c*, x, y) ⋈ Dim_i(c_i, w_i), bushy order, one subtree per
    dimension — the service's natural shape (feature pool {w_i} ∪ {x})."""
    VO = m.VariableOrder
    rng = np.random.default_rng(seed)
    keys = {
        f"c{i}": rng.integers(0, domain, fact_rows).astype(np.int32)
        for i in range(n_dims)
    }
    x = rng.normal(0, 2.0, fact_rows)
    y = 0.5 * x + rng.normal(0, 0.5, fact_rows)
    rels = [
        m.Relation.from_columns(
            "Fact", keys, {"x": x, "y": y},
            {f"c{i}": domain for i in range(n_dims)},
        )
    ]
    for i in range(n_dims):
        rels.append(
            m.Relation.from_columns(
                f"Dim{i}",
                {f"c{i}": rng.integers(0, domain, dim_rows).astype(np.int32)},
                {f"w{i}": rng.normal(0, 1.0, dim_rows)},
                {f"c{i}": domain},
            )
        )
    node = VO("x", [VO("y", [VO.leaf("Fact")])])
    for i in reversed(range(n_dims)):
        w = VO(f"w{i}", [VO.leaf(f"Dim{i}")])
        node = VO(f"c{i}", [w, node])
    return rels, VO.intercept([node])


def _fact_delta(m, rng, n_dims=3, domain=8, n_rows=25):
    return m.Relation.from_columns(
        "delta",
        {
            f"c{i}": rng.integers(0, domain, n_rows).astype(np.int32)
            for i in range(n_dims)
        },
        {"x": rng.normal(0, 2.0, n_rows), "y": rng.normal(0, 1.0, n_rows)},
    )


def _cof(m, store, vorder, cols, **kw):
    return m.fz.cofactors_factorized(store, vorder, cols, **{**m.bk, **kw})


# ---------------------------------------------------------------------------
# Layer 1: snapshot isolation
# ---------------------------------------------------------------------------

def _snapshot_append(m):
    rels, vorder = _star(m, seed=1)
    store = m.Store(rels)
    cols = ["w0", "x", "y"]
    oracle = _cof(m, store, vorder, cols, use_view_cache=False)
    snap = store.snapshot()
    store.append("Fact", _fact_delta(m, np.random.default_rng(2)))
    assert not snap.is_current and snap.live_version == store.version
    held = m.FactorizedEngine(snap, vorder, cols, **m.bk).cofactors()
    np.testing.assert_allclose(held.matrix(), oracle.matrix(), rtol=0, atol=0)
    fresh = _cof(m, store, vorder, cols)
    assert fresh.count > oracle.count  # live store did move
    return {"held": held.matrix(), "fresh": fresh.matrix()}


@pytest.mark.parametrize(**FP32)
def test_snapshot_reader_bit_identical_across_append(fp32):
    twin(_snapshot_append, fp32)


def _snapshot_put(m):
    rels, vorder = _star(m, seed=3)
    store = m.Store(rels)
    cols = ["w1", "x", "y"]
    oracle = _cof(m, store, vorder, cols, use_view_cache=False)
    snap = store.snapshot()
    dim = store.get("Dim1")
    rng = np.random.default_rng(4)
    store.put(
        m.Relation.from_columns(
            "Dim1",
            {"c1": dim.keys["c1"][:10]},
            {"w1": rng.normal(0, 1.0, 10)},
            dict(dim.domains),
        )
    )
    held = m.FactorizedEngine(snap, vorder, cols, **m.bk).cofactors()
    np.testing.assert_allclose(held.matrix(), oracle.matrix(), rtol=0, atol=0)
    fresh = _cof(m, store, vorder, cols)
    assert fresh.count != oracle.count
    return {"held": held.matrix(), "fresh": fresh.matrix()}


def test_snapshot_reader_bit_identical_across_put():
    twin(_snapshot_put)


def _snapshot_fd(m):
    bundle = m.data.fd_star_schema(n_cat=2, seed=5)
    store, vorder = bundle.store, bundle.vorder
    store.infer_fds()
    cat = CAT2 + ["d0", "d1"]
    snap = store.snapshot()
    before = snap.fd_reduction(cat).signature()
    oracle = snap.cat_cofactors(
        vorder, ["x", "y"], cat, backend="numpy", reduce_fds=True
    )
    store.drop_fd("c0", "d0")
    assert not snap.is_current  # FD mutation breaks currency, not version
    assert snap.fd_reduction(cat).signature() == before
    assert store.fd_reduction(cat).signature() != before
    held = snap.cat_cofactors(
        vorder, ["x", "y"], cat, backend="numpy", reduce_fds=True
    )
    assert list(held.cat) == list(oracle.cat)  # d0 still reduced away
    np.testing.assert_allclose(held.matrix(), oracle.matrix(), rtol=0, atol=0)
    return {"cat": list(held.cat), "held": held.matrix(),
            "signature": repr(before)}


def test_snapshot_fd_catalog_frozen_across_drop_fd():
    twin(_snapshot_fd)


def _engine_holds(m):
    """An engine constructed before a mutation keeps serving the frozen
    catalog: batch 2 on the same engine ≡ batch 1, bit for bit."""
    rels, vorder = _star(m, seed=6)
    store = m.Store(rels)
    cols = ["w0", "w2", "x", "y"]
    eng = m.FactorizedEngine(store, vorder, cols, use_view_cache=False, **m.bk)
    first = eng.cofactors()
    store.append("Fact", _fact_delta(m, np.random.default_rng(7)))
    second = eng.cofactors()  # mid-request mutation landed between batches
    np.testing.assert_allclose(second.matrix(), first.matrix(), rtol=0, atol=0)
    return {"first": first.matrix(), "passes": eng.passes,
            "node_visits": eng.node_visits}


@pytest.mark.parametrize(**FP32)
def test_engine_holds_snapshot_across_mid_request_append(fp32):
    twin(_engine_holds, fp32)


def _stale_engine(m):
    rels, vorder = _star(m, seed=8)
    store = m.Store(rels)
    cols = ["w0", "x", "y"]
    snap = store.snapshot()
    store.append("Fact", _fact_delta(m, np.random.default_rng(9)))
    eng = m.FactorizedEngine(snap, vorder, cols, **m.bk)
    got = eng.cofactors()
    assert eng.vc_hits == 0  # stale engine must neither probe...
    assert store.cache_info()["view_cache_entries"] == 0  # ...nor publish
    return {"cof": got.matrix(), "info": dict(store.cache_info())}


def test_stale_snapshot_engine_stays_out_of_view_cache():
    twin(_stale_engine)


# ---------------------------------------------------------------------------
# Layer 2: merge_batches / scatter
# ---------------------------------------------------------------------------

def _merge(m):
    Q, P = m.AggregateQuery, m.BatchPart
    parts = [
        P(rid=1, features=("x", "w0"),
          queries=(Q("cof", (), 2), Q("g", ("c0", "c1"), 1))),
        P(rid=2, features=("w1", "x"),
          queries=(Q("cof", (), 1), Q("p", ("c1", "c0"), 0))),
    ]
    merged = m.fz.merge_batches(parts)
    assert merged.features == ["x", "w0", "w1"]  # union, first-seen order
    # () and {c0,c1} each collapse to one query at the max degree
    assert [(q.group_by, q.degree) for q in merged.queries] == [
        ((), 2),
        (("c0", "c1"), 1),
    ]
    assert merged.assignments[(1, "cof")] == merged.assignments[(2, "cof")]
    assert merged.assignments[(1, "g")] == merged.assignments[(2, "p")]
    return {"features": merged.features,
            "queries": [(q.name, q.group_by, q.degree) for q in merged.queries],
            "assignments": sorted(merged.assignments.items())}


def test_merge_batches_unions_and_dedupes():
    twin(_merge)


def _merge_duplicates(m):
    Q = m.AggregateQuery
    with pytest.raises(ValueError, match="duplicate query name"):
        m.fz.merge_batches([
            m.BatchPart(rid=1, features=("x",),
                        queries=(Q("q", (), 2), Q("q", ("c0",), 1)))
        ])
    return {}


def test_merge_batches_rejects_duplicate_names_within_request():
    twin(_merge_duplicates)


def _scatter(m):
    rels, vorder = _star(m, seed=10)
    store = m.Store(rels, view_cache_bytes=0)
    Q = m.AggregateQuery
    parts = [
        m.BatchPart(rid="a", features=("w0", "x"),
                    queries=(Q("cof", (), 2), Q("g", ("c1",), 1))),
        m.BatchPart(rid="b", features=("x", "w1", "w2"),
                    queries=(Q("cof", (), 2),)),
    ]
    merged = m.fz.merge_batches(parts)
    shared = m.FactorizedEngine(
        store, vorder, merged.features, **m.bk
    ).run_batch(merged.queries)
    out = m.fz.scatter_results(merged, parts, shared)
    for part in parts:
        private = m.FactorizedEngine(
            store, vorder, list(part.features), **m.bk
        ).run_batch(list(part.queries))
        for q in part.queries:
            mine, ref = out[part.rid][q.name], private[q.name]
            assert mine.features == list(part.features if q.degree else ())
            perm = [mine.features.index(f) for f in ref.features]
            rtol = 2e-5 if m.fp32 else 1e-12  # one traversal vs another
            same(value({"b": mine})["b"]["count"], ref.count, rtol)
            if q.degree >= 1:
                same(mine.lin[:, perm], ref.lin, rtol)
            if q.degree == 2:
                same(mine.quad[:, perm][:, :, perm], ref.quad, rtol)
    return {rid: value(res) for rid, res in out.items()}


@pytest.mark.parametrize(**FP32)
def test_scatter_matches_private_engines(fp32):
    twin(_scatter, fp32)


# ---------------------------------------------------------------------------
# Layer 3: the service
# ---------------------------------------------------------------------------

def _train(m):
    rels, vorder = _star(m, seed=11)
    store = m.Store(rels)
    svc = m.Service(store)
    feats = ["w0", "x"]
    t = svc.train("alice", vorder, feats, "y")
    svc.run()
    cfg = dataclasses.replace(
        m.reg.VERSIONS["closed"], backend="numpy", use_cache=True
    )
    ref = m.reg.linear_regression(store, vorder, feats, "y", cfg)
    rtol = 1e-4 if m.fp32 else 1e-9
    np.testing.assert_allclose(t.result().theta, ref.theta, rtol=rtol, atol=rtol)
    s = svc.score("alice", vorder, feats, "y", t.result().theta)
    svc.run()
    assert s.result().rmse < 1.0  # the model genuinely fits the planted y
    return {"train": outcome(t), "score": outcome(s), "info": info(svc)}


@pytest.mark.parametrize(**FP32)
def test_service_train_matches_linear_regression(fp32):
    twin(_train, fp32)


def _window(m):
    """Reads admitted in the same cycle as a write all see the pre-write
    catalog; the write is visible from the next cycle on."""
    rels, vorder = _star(m, seed=12)
    store = m.Store(rels)
    svc = m.Service(store)
    cols = ["x", "y"]
    oracle = _cof(m, m.Store(rels), vorder, cols, use_view_cache=False)
    t1 = svc.cofactors("a", vorder, cols)
    tw = svc.append("w", "Fact", _fact_delta(m, np.random.default_rng(13)))
    t2 = svc.cofactors("b", vorder, cols)  # queued BEFORE the drain
    svc.drain()
    # the same traversal either way: bitwise on the numpy engine
    rtol = 1e-6 if m.fp32 else 0
    np.testing.assert_allclose(t1.result().matrix(), oracle.matrix(), rtol=rtol)
    np.testing.assert_allclose(t2.result().matrix(), oracle.matrix(), rtol=rtol)
    assert tw.result().num_rows == 325  # 300 base fact rows + 25 appended
    t3 = svc.cofactors("a", vorder, cols)  # next cycle: append visible
    svc.drain()
    assert t3.result().count > oracle.count
    return {"tickets": [outcome(t) for t in (t1, tw, t2, t3)], "info": info(svc)}


@pytest.mark.parametrize(**FP32)
def test_service_window_reads_see_pre_write_snapshot(fp32):
    twin(_window, fp32)


def _failed(m):
    rels, vorder = _star(m, seed=14)
    svc = m.Service(m.Store(rels))
    bad = svc.append("t", "Nope", _fact_delta(m, np.random.default_rng(0)))
    ok = svc.cofactors("t", vorder, ["x", "y"])
    svc.run()
    assert ok.result().count > 0  # one bad request never wedges the cycle
    with pytest.raises(KeyError):
        bad.result()
    with pytest.raises(RuntimeError, match="not served yet"):
        m.Service(m.Store(rels)).cofactors("t", vorder, ["x"]).result()
    return {"tickets": [outcome(bad), outcome(ok)], "info": info(svc)}


def test_service_failed_requests_resolve_with_errors():
    twin(_failed)


def _run_schedule(m, seed, coalesce, n_ops=14):
    """One deterministic random schedule against a fresh store; returns
    ticket outcomes in submission order and the service's info."""
    rels, vorder = _star(m, seed=100)  # schema fixed; schedule varies by seed
    rng = np.random.default_rng(seed)
    svc = m.Service(m.Store(rels), coalesce=coalesce)
    pool = ["w0", "w1", "w2", "x"]
    tickets = []
    for _ in range(n_ops):
        r = rng.random()
        if r < 0.18:
            tickets.append(svc.append(
                "writer", "Fact",
                _fact_delta(m, rng, n_rows=int(rng.integers(5, 30)))))
        elif r < 0.30:
            svc.drain()
        else:
            tenant = f"t{int(rng.integers(0, 3))}"
            feats = sorted(
                rng.choice(pool, size=int(rng.integers(1, 4)), replace=False)
            )
            if rng.random() < 0.5:
                tickets.append(svc.cofactors(tenant, vorder, feats + ["y"]))
            else:
                tickets.append(svc.aggregates(
                    tenant, vorder, feats,
                    [m.AggregateQuery("cof", (), 2),
                     m.AggregateQuery("g", (f"c{int(rng.integers(0, 3))}",), 1)],
                ))
    svc.run()
    return [outcome(t) for t in tickets], info(svc)


def _schedules(m, seed):
    """Coalesced ≡ sequential per-request results at 1e-12."""
    got, info_c = _run_schedule(m, seed, coalesce=True)
    want, info_s = _run_schedule(m, seed, coalesce=False)
    assert info_c["coalesced_batches"] >= 0
    for g, w in zip(got, want):
        assert "error" not in g and "error" not in w
    same(got, want, 1e-12)
    return {"coalesced": got, "sequential": want, "info_coalesced": info_c,
            "info_sequential": info_s}


@pytest.mark.parametrize("seed", range(4))
def test_coalesced_equals_sequential_deterministic(seed):
    twin(_schedules, seed=seed)


def test_coalesced_equals_sequential_property():
    """Random request/mutation schedules: coalesced ≡ sequential
    per-request results at 1e-12 in each package, and the two packages'
    records equal, whatever interleaving lands."""
    hypothesis = pytest.importorskip("hypothesis")
    st = hypothesis.strategies

    @hypothesis.settings(
        max_examples=12, deadline=None,
        suppress_health_check=[hypothesis.HealthCheck.too_slow],
    )
    @hypothesis.given(seed=st.integers(0, 60))
    def inner(seed):
        twin(_schedules, seed=seed)

    inner()


def _counters(m):
    rels, vorder = _star(m, seed=15)
    store = m.Store(rels)
    svc = m.Service(store)
    rng = np.random.default_rng(16)
    svc.cofactors("a", vorder, ["w0", "x", "y"])
    svc.cofactors("b", vorder, ["w1", "x", "y"])
    svc.train("c", vorder, ["w0", "w1"], "y")
    svc.drain()
    svc.append("w", "Fact", _fact_delta(m, rng))
    svc.cofactors("a", vorder, ["w0", "x", "y"])  # warm + post-append read
    svc.run()
    out = info(svc)
    tenants = out["tenants"].values()
    assert {"a", "b", "c", "w"} == set(out["tenants"])
    vc = store.view_cache
    assert sum(t["passes"] for t in tenants) == out["passes"]
    assert sum(t["node_visits"] for t in tenants) == out["node_visits"]
    assert sum(t["vc_hits"] for t in tenants) == vc.hits
    assert sum(t["vc_misses"] for t in tenants) == vc.misses
    assert sum(t["vc_bytes"] for t in tenants) == out["view_cache_bytes"]
    assert all(t["requests"] + t["appends"] > 0 for t in tenants)
    return out


@pytest.mark.parametrize(**FP32)
def test_per_tenant_counters_sum_to_store_totals(fp32):
    twin(_counters, fp32)


# ---------------------------------------------------------------------------
# Satellite: cross-dtype view reuse
# ---------------------------------------------------------------------------

def _fp32_warm(m):
    rels, vorder = _star(m, seed=17)
    store = m.Store(rels)
    cols = ["w0", "w1", "x", "y"]
    ref = m.fz.cofactors_factorized(store, vorder, cols, backend="numpy")
    store.reset_counters()
    kw = {"backend": m.fp32_backend, **({} if m.ref else {"device": "cpu"})}
    eng = m.FactorizedEngine(store, vorder, cols, **kw)
    got = eng.cofactors()
    assert eng.node_visits == 0  # served entirely by casting fp64 views
    assert store.node_visits == 0
    assert eng.vc_hits > 0
    scale = float(np.abs(ref.matrix()).max())
    np.testing.assert_allclose(
        got.matrix(), ref.matrix(), rtol=2e-5, atol=2e-5 * max(1.0, scale)
    )
    return {"cof": got.matrix(), "vc_hits": eng.vc_hits}


def test_fp32_warm_path_casts_fp64_views_zero_node_visits():
    twin(_fp32_warm, fp32=True)


def _fp32_service(m):
    rels, vorder = _star(m, seed=18)
    store = m.Store(rels)
    svc = m.Service(store)
    cols = ["w2", "x", "y"]
    t64 = svc.cofactors("a", vorder, cols)  # numpy/fp64, populates views
    svc.drain()
    store.reset_counters()
    t32 = svc.cofactors("b", vorder, cols, backend=m.fp32_backend)
    svc.drain()
    assert store.node_visits == 0
    out = info(svc)
    assert out["tenants"]["b"]["node_visits"] == 0
    assert out["tenants"]["b"]["vc_hits"] > 0
    scale = float(np.abs(t64.result().matrix()).max())
    np.testing.assert_allclose(
        t32.result().matrix(), t64.result().matrix(),
        rtol=2e-5, atol=2e-5 * max(1.0, scale),
    )
    return {"t64": outcome(t64), "t32": outcome(t32), "info": out}


def test_fp32_service_requests_reuse_fp64_views():
    twin(_fp32_service, fp32=True)


# ---------------------------------------------------------------------------
# The port's device rules
# ---------------------------------------------------------------------------

def test_default_service_raises_at_construction_without_a_gpu(monkeypatch):
    """The default service runs on ``cuda``: without a card it raises when
    constructed, never at its first read (where the bisection would turn
    the engine's error into a failed ticket).  ``device="cpu"`` and
    ``backend="numpy"`` are the ways onto the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = pkg(False, False)
    rels, vorder = _star(m, seed=19)
    store = m.Store(rels)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        m.sv.FactorizedService(store)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        m.sv.FactorizedService(store, backend="torch", device="cuda:0")
    with pytest.raises(ValueError, match="unknown backend"):
        m.sv.FactorizedService(store, backend="jax")
    got = []
    for kw in ({"device": "cpu"}, {"backend": "numpy"}):
        svc = m.sv.FactorizedService(store, **kw)
        t = svc.cofactors("a", vorder, ["x", "y"])
        svc.run()
        got.append(t.result().matrix())
    same(got[0], got[1], 1e-5)


def test_reads_group_by_backend_dtype_and_device():
    """Reads coalesce only within one (order, backend, dtype, device)
    group: a float64 torch read and a numpy read beside float32 torch reads
    take three traversals; a torch read on a numpy service runs on the
    service's device."""
    m = pkg(False, True)
    rels, vorder = _star(m, seed=20)
    store = m.Store(rels, view_cache_bytes=0)
    svc = m.sv.FactorizedService(store, device="cpu")
    assert svc.device == torch.device("cpu")
    a = svc.cofactors("a", vorder, ["x", "y"])
    b = svc.cofactors("b", vorder, ["w0", "y"])
    c = svc.cofactors("c", vorder, ["x", "y"], dtype=torch.float64)
    d = svc.cofactors("d", vorder, ["x", "y"], backend="numpy")
    svc.run()
    assert store.passes == 3 and svc.cache_info()["coalesced_batches"] == 1
    tight(c.result().matrix(), d.result().matrix())
    same(a.result().matrix(), d.result().matrix(), 1e-5)
    assert b.result().count == d.result().count
    host = m.sv.FactorizedService(m.Store(rels), backend="numpy", device="cpu")
    t = host.cofactors("a", vorder, ["x", "y"], backend="torch")
    host.run()
    same(t.result().matrix(), d.result().matrix(), 1e-5)
