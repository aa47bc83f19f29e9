"""PyTorch port, streaming ingest under lazy maintenance, held against the
JAX package's: the O(delta) write path, the pending-delta log and its
drains (stacked appends, the ``flush`` scope hint, zero-row appends,
compaction, the telescoping freeze of later pending relations), lazy ≡
eager, snapshots with pending deltas, and exception safety of a poisoned
fold.

Every scenario runs once per package on the same numpy-seeded relations
and deltas; the two records (matrices, ``cache_info`` counters and the
delta log's ``info()``, view-cache state) must agree — numpy backends to
1e-12, the port's torch backend (float32, on the CPU here) against the
reference's jax backend in float32 tolerance, counters and keys exactly.
"""

import types

import numpy as np
import pytest
import torch

import repro.core.categorical as RCAT
import repro.core.relation as RREL
import repro.core.store as RST
import repro.data.synthetic as RS
import repro.serve as RSV
import repro_torch.core.categorical as PCAT
import repro_torch.core.relation as PREL
import repro_torch.core.store as PST
import repro_torch.data.synthetic as PS
import repro_torch.serve as PSV

CONT = ["x", "y"]


def _pkg(ref: bool, fp32: bool) -> types.SimpleNamespace:
    """One package's surface, plus the engine keywords of the backend."""
    if ref:
        bk = {"backend": "jax"} if fp32 else {"backend": "numpy"}
        cat, rel, st, data, sv = RCAT, RREL, RST, RS, RSV
        svc = bk
    else:
        bk = {"backend": "torch", "device": "cpu"} if fp32 else {"backend": "numpy"}
        cat, rel, st, data, sv = PCAT, PREL, PST, PS, PSV
        svc = {"backend": bk["backend"], "device": "cpu"}
    return types.SimpleNamespace(
        ref=ref, bk=bk, catmod=cat, data=data, Store=st.Store,
        Relation=rel.Relation,
        Service=lambda store, **k: sv.FactorizedService(store, **{**svc, **k}),
        cat=lambda *a, **k: cat.cat_cofactors_factorized(*a, **{**bk, **k}),
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


def _delta_for(m, rel, rng, n_rows: int, grow: bool = False):
    """Random delta with the same attribute sets as ``rel``; ``grow=True``
    pushes one key column past the current domain (unseen category ids)."""
    keys = {}
    for i, a in enumerate(rel.keys):
        dom = int(rel.domains[a])
        ids = rng.integers(0, dom, n_rows).astype(np.int32)
        if grow and i == 0 and n_rows:
            ids[0] = dom
        keys[a] = ids
    values = {a: rng.normal(0, 2.0, n_rows) for a in rel.values}
    return m.Relation.from_columns("delta", keys, values)


def _clone(m, store, **kwargs):
    return m.Store([store.get(n) for n in store.names()], **kwargs)


def _close(got, want):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * scale)


FP32 = dict(argnames="fp32", argvalues=[False, True], ids=["numpy", "fp32"])


# ---------------------------------------------------------------------------
# O(delta) write path
# ---------------------------------------------------------------------------

def _write_path(m, n_warm):
    b = m.data.many_cat_schema(n_cat=3, domain=8, n_rows=300, seed=7)
    cat = [f"c{i}" for i in range(3)]
    for k in range(n_warm):  # k distinct cached queries
        b.store.cat_cofactors(b.vorder, CONT, cat[: k + 1])
    if n_warm:
        b.store.cofactors(b.vorder, CONT, backend="numpy")
    vc = b.store.view_cache
    b.store.reset_counters()
    rng = np.random.default_rng(1)
    b.store.append("Fact", _delta_for(m, b.store.get("Fact"), rng, 40))
    b.store.append("Fact", _delta_for(m, b.store.get("Fact"), rng, 25))
    assert b.store.passes == b.store.node_visits == 0
    assert b.store.cat_passes == b.store.cat_node_visits == 0
    assert vc.hits == vc.misses == 0  # the cache was never probed
    info = _info(b.store)
    assert info["maintenance"] == "lazy" and info["pending_relations"] == 1
    assert info["pending_rows"] == 65 and info["pending_appends"] == 2
    return [info, vc_state(b.store)]


@pytest.mark.parametrize("n_warm", [0, 1, 3])
def test_append_write_path_zero_visits(n_warm):
    twin(_write_path, n_warm=n_warm)


def test_maintenance_mode_validated():
    with pytest.raises(ValueError, match="maintenance"):
        PST.Store(maintenance="sometimes")


# ---------------------------------------------------------------------------
# Drain mechanics
# ---------------------------------------------------------------------------

def _stacked(m):
    b = m.data.many_cat_schema(n_cat=2, domain=8, n_rows=250, seed=8)
    cat = ["c0", "c1"]
    warm = b.store.cat_cofactors(b.vorder, CONT, cat, **m.bk)
    rng = np.random.default_rng(2)
    for n in (10, 20, 15):
        b.store.append("Fact", _delta_for(m, b.store.get("Fact"), rng, n))
    stats = b.store.flush()
    assert stats == {"relations": 1, "rows": 45, "appends": 3}
    info = _info(b.store)
    assert info["pending_rows"] == info["pending_relations"] == 0
    assert info["drains"] == 1 and info["drained_rows"] == 45
    assert b.store.flush() == {"relations": 0, "rows": 0, "appends": 0}
    assert b.store.cache_info()["drains"] == 1  # no-op flush, no drain
    visits = b.store.node_visits
    out = b.store.cat_cofactors(b.vorder, CONT, cat, **m.bk)  # folded
    assert b.store.node_visits == visits  # served, nothing re-descended
    ref = m.cat(b.store, b.vorder, CONT, cat, use_view_cache=False)
    np.testing.assert_allclose(out.matrix(), ref.matrix(), rtol=1e-5, atol=1e-3)
    assert out.matrix().shape == warm.matrix().shape
    return [info, out.matrix(), vc_state(b.store)]


@pytest.mark.parametrize(**FP32)
def test_stacked_appends_drain_in_one_pass(fp32):
    twin(_stacked, fp32=fp32)


def _scope(m):
    b = m.data.many_cat_schema(n_cat=2, domain=8, n_rows=200, seed=9)
    b.store.cat_cofactors(b.vorder, CONT, ["c0", "c1"])
    rng = np.random.default_rng(3)
    b.store.append("Fact", _delta_for(m, b.store.get("Fact"), rng, 12))
    # a small dim delta stays under the 0.5 compaction ratio of 8 base rows
    b.store.append("Dim0", _delta_for(m, b.store.get("Dim0"), rng, 3))
    assert b.store.flush(["Dim1"])["rows"] == 0  # disjoint: no drain
    assert b.store.cache_info()["pending_rows"] == 15
    assert b.store.flush(["Dim0"]) == {"relations": 2, "rows": 15, "appends": 2}
    assert b.store.cache_info()["pending_rows"] == 0
    return [_info(b.store), vc_state(b.store)]


def test_flush_names_scope_hint():
    twin(_scope)


def _zero_rows(m):
    b = m.data.many_cat_schema(n_cat=2, domain=8, n_rows=200, seed=10)
    b.store.cat_cofactors(b.vorder, CONT, ["c0"])
    empty = _delta_for(m, b.store.get("Fact"), np.random.default_rng(4), 0)
    v = b.store.version
    b.store.append("Fact", empty)
    assert b.store.version == v + 1
    assert not b.store.cache_info()["pending_appends"]  # nothing logged
    before = b.store.cat_passes
    b.store.cat_cofactors(b.vorder, CONT, ["c0"])
    assert b.store.cat_passes == before  # served from the entry
    return [_info(b.store)]


def test_zero_row_append_keeps_entries_current():
    twin(_zero_rows)


def _compaction(m, rows):
    b = m.data.many_cat_schema(n_cat=2, domain=8, n_rows=200, seed=11)
    kw = {"compact_rows": 30} if rows else {}  # else: the 0.5 ratio
    store = _clone(m, b.store, **kw)
    store.cat_cofactors(b.vorder, CONT, ["c0"])
    rng = np.random.default_rng(5)
    first = 20 if rows else 60
    store.append("Fact", _delta_for(m, store.get("Fact"), rng, first))
    assert store.cache_info()["compactions"] == 0
    store.append("Fact", _delta_for(m, store.get("Fact"), rng, first))
    info = _info(store)
    assert info["compactions"] == 1 and info["pending_rows"] == 0
    out = store.cat_cofactors(b.vorder, CONT, ["c0"])
    ref = m.cat(store, b.vorder, CONT, ["c0"], use_view_cache=False)
    np.testing.assert_allclose(out.matrix(), ref.matrix(), rtol=1e-12, atol=1e-9)
    return [info, out.matrix(), _info(store)]


@pytest.mark.parametrize("rows", [True, False], ids=["compact_rows", "compact_ratio"])
def test_compaction_bounds_pending_rows(rows):
    twin(_compaction, rows=rows)


def _telescoping(m):
    """Three relations pending at once, as one new day lands: the drain
    folds each with every later pending relation frozen to its prefix."""
    b = m.data.favorita_like(n_dates=8, n_stores=4, n_items=6, seed=3)
    cols = b.features + [b.label]
    cat = ["store_nbr", "item_nbr"]
    b.store.sufficient_stats(b.vorder, b.features, b.label, **m.bk)
    b.store.sufficient_stats(b.vorder, b.features, b.label, categorical=cat, **m.bk)
    rng = np.random.default_rng(8)
    new_day = 8
    b.store.append("SalesF", m.Relation.from_columns(
        "d",
        {"date": np.full(9, new_day, np.int32),
         "store_nbr": rng.integers(0, 4, 9).astype(np.int32),
         "item_nbr": rng.integers(0, 6, 9).astype(np.int32)},
        {"unit_sales": rng.normal(10, 2, 9), "onpromotion": rng.integers(0, 2, 9) * 1.0},
    ))
    b.store.append("Transactions", m.Relation.from_columns(
        "d", {"date": np.full(4, new_day, np.int32),
              "store_nbr": np.arange(4, dtype=np.int32)},
        {"transactions": rng.normal(1500, 300, 4)}))
    b.store.append("Oil", m.Relation.from_columns(
        "d", {"date": np.array([new_day], np.int32)}, {"dcoilwtico": [50.0]}))
    pending = _info(b.store)
    assert pending["pending_relations"] == 3
    b.store.reset_counters()
    drained = b.store.flush()
    visits = b.store.node_visits
    assert visits > 0
    cont = b.store.sufficient_stats(b.vorder, b.features, b.label, **m.bk)
    catc = b.store.sufficient_stats(b.vorder, b.features, b.label,
                                    categorical=cat, **m.bk)
    assert b.store.node_visits == visits  # the read after the drain is warm
    fresh = _clone(m, b.store)
    cold = fresh.sufficient_stats(b.vorder, b.features, b.label, refresh=True, **m.bk)
    ccold = fresh.sufficient_stats(b.vorder, b.features, b.label, categorical=cat,
                                   refresh=True, **m.bk)
    for got, want in ((cont.matrix(), cold.matrix()), (catc.matrix(), ccold.matrix())):
        bound = 1e-4 * float(np.abs(want).max())
        assert float(np.abs(got - want).max()) <= bound
    return [pending, drained, _info(b.store), cont.matrix(), catc.matrix(),
            vc_state(b.store), cols]


@pytest.mark.parametrize(**FP32)
def test_multi_relation_drain_telescopes(fp32):
    twin(_telescoping, fp32=fp32)


# ---------------------------------------------------------------------------
# Lazy ≡ eager under interleavings
# ---------------------------------------------------------------------------

def _apply_everywhere(m, stores, op: int, rng) -> str:
    """One mutation applied identically to every store."""
    lead = stores[0]
    names = lead.names()
    name = names[op % len(names)]
    rel = lead.get(name)
    kind = (op // len(names)) % 3
    if kind == 0:
        delta = _delta_for(m, rel, rng, int(rng.integers(1, 8)), grow=bool(op % 2))
        for s in stores:
            s.append(name, delta)
    elif kind == 1:
        values = {a: c + rng.normal(0, 0.1, len(c)) for a, c in rel.values.items()}
        put = m.Relation(rel.name, dict(rel.keys), values, dict(rel.domains))
        for s in stores:
            s.put(put)
    else:
        drop = None
        for s in stores:
            s.infer_fds()
            fds = s.fds()
            if drop is None and fds:
                drop = fds[int(rng.integers(0, len(fds)))]
        if drop is not None:
            for s in stores:
                s.drop_fd(drop.lhs, drop.rhs)
    return f"{('append', 'put', 'fd')[kind]}:{name}"


def _lazy_eager(m, seed):
    b = m.data.random_acyclic_schema(seed, n_branches=(seed % 3) + 1)
    lazy = b.store
    assert lazy.maintenance == "lazy"
    eager = _clone(m, lazy, maintenance="eager")
    cat = ["k0"] + [f"k{i + 1}" for i in range(len(b.features) // 2)]
    cont = b.features + [b.label]
    rng = np.random.default_rng(seed)
    rec = []
    for step in range(6):
        if step:
            rec.append(_apply_everywhere(m, [lazy, eager], int(rng.integers(0, 30)), rng))
        a = lazy.cat_cofactors(b.vorder, cont, cat)  # the read barrier drains
        c = eager.cat_cofactors(b.vorder, cont, cat)
        fresh = m.cat(lazy, b.vorder, cont, cat, use_view_cache=False)
        _close(a.matrix(), fresh.matrix())
        _close(c.matrix(), fresh.matrix())
        rec += [a.matrix(), _info(lazy), _info(eager)]
    return rec


@pytest.mark.parametrize("seed", range(5))
def test_lazy_equals_eager_interleavings_deterministic(seed):
    twin(_lazy_eager, seed=seed)


# ---------------------------------------------------------------------------
# Snapshots across pending deltas and drains
# ---------------------------------------------------------------------------

def _snapshot_pending(m):
    b = m.data.many_cat_schema(n_cat=2, domain=8, n_rows=200, seed=12)
    rng = np.random.default_rng(6)
    b.store.cat_cofactors(b.vorder, CONT, ["c0"])
    b.store.append("Fact", _delta_for(m, b.store.get("Fact"), rng, 30))
    snap = b.store.snapshot()  # taken with 30 rows pending
    assert snap.is_current and b.store.cache_info()["pending_rows"] == 30
    ref = m.cat(_clone(m, b.store), b.vorder, CONT, ["c0"], use_view_cache=False)
    # the snapshot read's barrier drains the live log without a version bump
    out = snap.cat_cofactors(b.vorder, CONT, ["c0"])
    np.testing.assert_allclose(out.matrix(), ref.matrix(), rtol=1e-12, atol=1e-9)
    assert b.store.cache_info()["pending_rows"] == 0 and snap.is_current
    _close(snap.cat_cofactors(b.vorder, CONT, ["c0"]).matrix(), ref.matrix())
    b.store.append("Fact", _delta_for(m, b.store.get("Fact"), rng, 5))
    assert not snap.is_current and snap.live_version == b.store.version
    assert snap.flush() == {"relations": 0, "rows": 0, "appends": 0}
    stale = snap.cat_cofactors(b.vorder, CONT, ["c0"])  # the frozen catalog
    _close(stale.matrix(), ref.matrix())
    return [out.matrix(), _info(b.store), snap.cache_info()]


def test_snapshot_with_pending_deltas_reads_published_rows():
    twin(_snapshot_pending)


def _snapshot_flush(m):
    b = m.data.many_cat_schema(n_cat=2, domain=8, n_rows=150, seed=13)
    b.store.append("Fact", _delta_for(m, b.store.get("Fact"),
                                      np.random.default_rng(7), 9))
    snap = b.store.snapshot()
    assert snap.flush()["rows"] == 9  # forwarded to the live store
    assert b.store.cache_info()["pending_rows"] == 0
    return [_info(b.store)]


def test_snapshot_flush_forwards_while_current():
    twin(_snapshot_flush)


# ---------------------------------------------------------------------------
# Exception safety of a poisoned fold
# ---------------------------------------------------------------------------

def _poisoned_drain(m, monkeypatch, via_hook):
    b = m.data.many_cat_schema(n_cat=2, domain=8, n_rows=250, seed=14)
    b.store.cofactors(b.vorder, CONT, backend="numpy")
    b.store.cat_cofactors(b.vorder, CONT, ["c0"])
    b.store.append("Fact", _delta_for(m, b.store.get("Fact"),
                                      np.random.default_rng(8), 15))
    rows_after = b.store.get("Fact").num_rows

    def boom(*a, **k):
        raise RuntimeError("poisoned drain")

    if via_hook:
        b.store.fault_hook = boom
    else:
        # the plain cofactor fold mutates its entry BEFORE the categorical
        # fold raises — the half-updated hazard
        monkeypatch.setattr(m.catmod, "cat_cofactors_factorized", boom)
    with pytest.raises(RuntimeError, match="poisoned drain"):
        b.store.flush()
    monkeypatch.undo()
    b.store.fault_hook = None
    assert b.store.get("Fact").num_rows == rows_after  # rows stay published
    info = _info(b.store)
    assert info["entries"] == info["cat_entries"] == 0
    assert info["pending_rows"] == 0  # log cleared, not wedged
    out = b.store.cat_cofactors(b.vorder, CONT, ["c0"])
    ref = m.cat(b.store, b.vorder, CONT, ["c0"], use_view_cache=False)
    np.testing.assert_allclose(out.matrix(), ref.matrix(), rtol=1e-12, atol=1e-9)
    return [info, out.matrix(), vc_state(b.store)]


@pytest.mark.parametrize("via_hook", [False, True], ids=["fold_raises", "fault_hook"])
def test_poisoned_drain_invalidates_instead_of_corrupting(monkeypatch, via_hook):
    twin(_poisoned_drain, monkeypatch=monkeypatch, via_hook=via_hook)


def _poisoned_eager(m, monkeypatch):
    b = m.data.fd_star_schema(n_cat=2, domain=12, dep_domain=4, n_rows=400, seed=5)
    b.store.infer_fds()
    store, vorder = b.store, b.vorder
    store.maintenance = "eager"  # fold on the write path
    store.cofactors(vorder, CONT, backend="numpy")
    store.cat_cofactors(vorder, CONT, ["c0"], backend="numpy")
    rows, version = store.get("Fact").num_rows, store.version

    def boom(*a, **k):
        raise RuntimeError("poisoned delta")

    monkeypatch.setattr(m.catmod, "cat_cofactors_factorized", boom)
    rng = np.random.default_rng(2)
    n = 11
    delta = m.Relation.from_columns(
        "d", {f"c{i}": rng.integers(0, 12, n).astype(np.int32) for i in range(2)},
        {"x": rng.normal(0, 1, n), "y": rng.normal(0, 1, n), "promo": np.zeros(n)},
    )
    with pytest.raises(RuntimeError, match="poisoned delta"):
        store.append("Fact", delta)
    monkeypatch.undo()
    assert store.get("Fact").num_rows == rows and store.version == version
    info = _info(store)
    assert info["entries"] == info["cat_entries"] == 0
    store.append("Fact", delta)  # a later append works and stays exact
    warm = store.cofactors(vorder, CONT, backend="numpy")
    cold = m.Store(store.relations()).cofactors(vorder, CONT, backend="numpy")
    np.testing.assert_allclose(warm.matrix(), cold.matrix(), rtol=1e-12, atol=1e-9)
    return [info, warm.matrix(), _info(store)]


def test_eager_poisoned_delta_leaves_the_catalog_untouched(monkeypatch):
    twin(_poisoned_eager, monkeypatch=monkeypatch)


# ---------------------------------------------------------------------------
# Service: idle-window folding between drain cycles
# ---------------------------------------------------------------------------

def test_service_flush_policy_validated():
    for m in (_pkg(True, False), _pkg(False, False)):
        b = m.data.many_cat_schema(n_cat=2, domain=8, n_rows=200, seed=20)
        with pytest.raises(ValueError, match="flush_policy"):
            m.Service(b.store, flush_policy="eventually")


def _service_idle(m):
    """Default policy: a cycle that ends with no queued reads folds the
    pending writes, so the next read starts warm with nothing pending."""
    b = m.data.many_cat_schema(n_cat=2, domain=8, n_rows=200, seed=21)
    svc = m.Service(b.store)
    rng = np.random.default_rng(9)
    t1 = svc.cofactors("a", b.vorder, CONT)
    svc.drain()
    svc.append("w", "Fact", _delta_for(m, b.store.get("Fact"), rng, 12))
    svc.drain()  # write lands, queue empty afterwards -> idle fold
    assert b.store.cache_info()["pending_rows"] == 0
    b.store.reset_counters()
    t2 = svc.cofactors("a", b.vorder, CONT)
    svc.drain()
    assert b.store.node_visits == 0  # idle fold kept the entry warm
    return [t1.result().matrix(), t2.result().matrix(),
            dict(svc.cache_info()), vc_state(b.store)]


@pytest.mark.parametrize(**FP32)
def test_service_idle_policy_folds_after_writes(fp32):
    twin(_service_idle, fp32=fp32)


def _service_never(m):
    b = m.data.many_cat_schema(n_cat=2, domain=8, n_rows=200, seed=22)
    svc = m.Service(b.store, flush_policy="never")
    rng = np.random.default_rng(10)
    svc.append("w", "Fact", _delta_for(m, b.store.get("Fact"), rng, 8))
    svc.drain()
    assert b.store.cache_info()["pending_rows"] == 8
    stats = svc.flush()  # the explicit idle-window pass
    assert b.store.cache_info()["pending_rows"] == 0
    return [stats, dict(svc.cache_info())]


def test_service_never_policy_defers_until_explicit_flush():
    twin(_service_never)


def _service_counters(m, policy):
    """Per-tenant shares still sum to store totals when drain work happens
    inside service-triggered folds (charged to the tenants that wrote)."""
    b = m.data.many_cat_schema(n_cat=2, domain=8, n_rows=200, seed=23)
    svc = m.Service(b.store, flush_policy=policy)
    rng = np.random.default_rng(11)
    svc.cofactors("a", b.vorder, CONT)
    svc.train("c", b.vorder, ["x"], "y")
    svc.drain()
    svc.append("w", "Fact", _delta_for(m, b.store.get("Fact"), rng, 10))
    svc.cofactors("b", b.vorder, CONT)
    svc.run()
    if policy == "never":
        svc.flush()
    info = dict(svc.cache_info())
    tenants = info["tenants"].values()
    vc = b.store.view_cache
    assert sum(t["passes"] for t in tenants) == info["passes"]
    assert sum(t["node_visits"] for t in tenants) == info["node_visits"]
    assert sum(t["vc_hits"] for t in tenants) == vc.hits
    assert sum(t["vc_misses"] for t in tenants) == vc.misses
    assert b.store.cache_info()["pending_rows"] == 0
    return info


@pytest.mark.parametrize("policy", ["idle", "always", "never"])
def test_service_counters_stay_exact_across_flush_policies(policy):
    twin(_service_counters, policy=policy)
