"""PyTorch port, persistent view cache, held against the JAX package's.

Every scenario runs twice, once per package, on the same numpy-seeded
relations and deltas, and records what it observes: cofactor matrices,
counters, and the cache's full state (keys in LRU order, covered
relations, stamps, each view's key layout and blocks).  The two records
must agree:

* keys, key layouts, group order, counters (``passes`` / ``node_visits``
  / ``cat_*``, view-cache hits / misses / evictions / entries / bytes) and
  stamps exactly;
* the numpy backends to 1e-12, the port's torch backend (float32, on the
  CPU here) against the reference's jax backend in float32 tolerance.

Each scenario also carries the reference test's own assertions, so both
packages are held to them.
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
import repro.core.variable_order as RVO
import repro.core.view_cache as RVC
import repro.data.synthetic as RS
import repro_torch.core as PC
import repro_torch.core.categorical as PCAT
import repro_torch.core.factorize as PF
import repro_torch.core.relation as PREL
import repro_torch.core.store as PST
import repro_torch.core.variable_order as PVO
import repro_torch.core.view_cache as PVC
import repro_torch.data.synthetic as PS
from repro_torch.kernels import ops as kops

CONT = ["x", "y"]


def _pkg(ref: bool, fp32: bool) -> types.SimpleNamespace:
    """One package's surface, plus the engine keywords of the backend."""
    if ref:
        bk = {"backend": "jax"} if fp32 else {"backend": "numpy"}
        mods = (RC, RCAT, RF, RREL, RST, RVO, RVC, RS)
    else:
        bk = {"backend": "torch", "device": "cpu"} if fp32 else {"backend": "numpy"}
        mods = (PC, PCAT, PF, PREL, PST, PVO, PVC, PS)
    core, cat, fac, rel, st, vo, vc, data = mods
    return types.SimpleNamespace(
        ref=ref, bk=bk, core=core, data=data, Store=st.Store,
        Relation=rel.Relation, VariableOrder=vo.VariableOrder,
        ViewCache=vc.ViewCache, ViewKey=vc.ViewKey,
        FactorizedEngine=fac.FactorizedEngine,
        AggregateQuery=fac.AggregateQuery,
        cofactors_factorized=fac.cofactors_factorized,
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


def _info(store):
    return {k: v for k, v in store.cache_info().items() if k != "max_bytes"}


# ---------------------------------------------------------------------------
# Counter audits
# ---------------------------------------------------------------------------

def _warm_batch(m):
    b = m.data.many_cat_schema(n_cat=4, domain=8, n_rows=400, seed=1)
    cat = [f"c{i}" for i in range(4)]
    s1, s2 = {}, {}
    cold = m.cat(b.store, b.vorder, CONT, cat, stats=s1)
    warm = m.cat(b.store, b.vorder, CONT, cat, stats=s2)
    assert s1["node_visits"] > 0 and s1["vc_misses"] > 0
    assert s2["node_visits"] == 0 and s2["vc_hits"] > 0 and s2["vc_misses"] == 0
    np.testing.assert_array_equal(warm.matrix(), cold.matrix())
    return [cold.matrix(), s1, s2, _info(b.store), vc_state(b.store)]


@pytest.mark.parametrize("fp32", [False, True], ids=["numpy", "fp32"])
def test_warm_batch_zero_node_visits(fp32):
    twin(_warm_batch, fp32=fp32)


def _overlapping(m):
    b = m.data.many_cat_schema(n_cat=5, domain=8, n_rows=400, seed=2)
    cat = [f"c{i}" for i in range(5)]
    m.cat(b.store, b.vorder, CONT, cat[:4])
    s = {}
    out = m.cat(b.store, b.vorder, CONT, cat[1:5], stats=s)
    assert s["vc_hits"] > 0
    ref = m.cat(b.store, b.vorder, CONT, cat[1:5], use_view_cache=False)
    np.testing.assert_array_equal(out.matrix(), ref.matrix())
    return [out.matrix(), s, _info(b.store), vc_state(b.store)]


def test_overlapping_query_sets_share_subtrees():
    twin(_overlapping)


def _trimming(m):
    b = m.data.many_cat_schema(n_cat=3, domain=6, n_rows=300, seed=3)
    eng = m.FactorizedEngine(b.store, b.vorder, CONT, **m.bk)
    eng.run_batch([m.AggregateQuery("base", (), 2)])
    eng2 = m.FactorizedEngine(b.store, b.vorder, CONT, **m.bk)
    out = eng2.run_batch([m.AggregateQuery("cnt", (), 0)])["cnt"]
    assert eng2.node_visits == 0 and eng2.vc_hits > 0
    assert out.lin is None and out.quad is None
    return [out.count, eng.node_visits, eng2.vc_hits, vc_state(b.store)]


@pytest.mark.parametrize("fp32", [False, True], ids=["numpy", "fp32"])
def test_degree_trimming_from_cached_views(fp32):
    twin(_trimming, fp32=fp32)


def _bushy_star(m, n_dims=3, domain=8, fact_rows=400, dim_rows=600, seed=4):
    """Fact(c0..c_{n-1}, x, y) ⋈ Dim_i(c_i, w_i) under a bushy order: each
    dimension in its own subtree, so sibling subtrees off the appended
    relation's root path show in the visit counters."""
    rng = np.random.default_rng(seed)
    keys = {f"c{i}": rng.integers(0, domain, fact_rows).astype(np.int32)
            for i in range(n_dims)}
    rels = [m.Relation.from_columns(
        "Fact", keys,
        {"x": rng.normal(0, 2, fact_rows), "y": rng.normal(0, 1, fact_rows)},
        {f"c{i}": domain for i in range(n_dims)},
    )]
    for i in range(n_dims):
        rels.append(m.Relation.from_columns(
            f"Dim{i}",
            {f"c{i}": rng.integers(0, domain, dim_rows).astype(np.int32)},
            {f"w{i}": rng.normal(0, 1, dim_rows)},
            {f"c{i}": domain},
        ))
    VO = m.VariableOrder
    node = VO("x", [VO("y", [VO.leaf("Fact")])])
    for i in reversed(range(n_dims)):
        node = VO(f"c{i}", [VO(f"w{i}", [VO.leaf(f"Dim{i}")]), node])
    return m.Store(rels), VO.intercept([node])


def _root_path(m):
    store, vorder = _bushy_star(m)
    cat = ["c0", "c1", "c2"]
    m.cat(store, vorder, CONT, cat)
    cold_visits = store.node_visits
    rng = np.random.default_rng(0)
    delta = _delta_for(m, store.get("Fact"), rng, 40)
    store.reset_counters()
    store.append("Fact", delta)
    assert store.node_visits == 0  # lazy write path folds nothing
    before = vc_state(store)
    drained = store.flush()
    append_visits = store.node_visits
    # only nodes covering Fact are re-evaluated; every Dim_i subtree view
    # is a cache hit during the delta folds
    assert 0 < append_visits < cold_visits and store.view_cache.hits > 0
    s = {}
    out = m.cat(store, vorder, CONT, cat, stats=s)
    assert s["node_visits"] == 0
    ref = m.cat(store, vorder, CONT, cat, use_view_cache=False)
    np.testing.assert_allclose(out.matrix(), ref.matrix(), rtol=1e-5, atol=1e-3)
    return [cold_visits, before, drained, append_visits, _info(store),
            vc_state(store), out.matrix(), ref.matrix()]


@pytest.mark.parametrize("fp32", [False, True], ids=["numpy", "fp32"])
def test_append_folds_root_path_only(fp32):
    twin(_root_path, fp32=fp32)


def _unseen_ids(m):
    b = m.data.many_cat_schema(n_cat=3, domain=6, n_rows=300, seed=5)
    cat = [f"c{i}" for i in range(3)]
    m.cat(b.store, b.vorder, CONT, cat)
    delta = _delta_for(m, b.store.get("Fact"), np.random.default_rng(1), 30,
                       grow=True)
    b.store.append("Fact", delta)
    out = m.cat(b.store, b.vorder, CONT, cat)
    ref = m.cat(b.store, b.vorder, CONT, cat, use_view_cache=False)
    np.testing.assert_allclose(out.matrix(), ref.matrix(), rtol=1e-12, atol=1e-9)
    return [out.matrix(), out.domains, _info(b.store), vc_state(b.store)]


def test_append_with_unseen_category_ids():
    twin(_unseen_ids)


def _put_invalidates(m):
    b = m.data.many_cat_schema(n_cat=3, domain=6, n_rows=300, seed=6)
    cat = [f"c{i}" for i in range(3)]
    m.cat(b.store, b.vorder, CONT, cat)
    before = len(b.store.view_cache)
    b.store.put(b.store.get("Dim0"))
    after = len(b.store.view_cache)
    assert 0 < after < before
    assert all("Dim0" not in e.relations for _, e in b.store.view_cache.items())
    survivors = vc_state(b.store)
    out = m.cat(b.store, b.vorder, CONT, cat)
    ref = m.cat(b.store, b.vorder, CONT, cat, use_view_cache=False)
    np.testing.assert_array_equal(out.matrix(), ref.matrix())
    return [before, after, survivors, out.matrix(), _info(b.store)]


def test_put_invalidates_covering_subtrees_only():
    twin(_put_invalidates)


def _counters(m):
    b = m.data.many_cat_schema(n_cat=2, domain=6, n_rows=200, seed=7)
    m.cofactors_factorized(b.store, b.vorder, CONT, backend="numpy")
    i1 = _info(b.store)
    assert i1["passes"] == 1 and i1["node_visits"] > 0 and i1["cat_passes"] == 0
    b.store.cat_cofactors(b.vorder, CONT, ["c0"])
    i2 = _info(b.store)
    assert i2["passes"] == 2 and i2["cat_passes"] == 1
    b.store.reset_counters()
    i3 = _info(b.store)
    for k in ("passes", "node_visits", "cat_passes", "cat_node_visits",
              "view_cache_hits", "view_cache_misses", "view_cache_evictions"):
        assert i3[k] == 0
    return [i1, i2, i3]


def test_unified_counters_and_reset():
    twin(_counters)


# ---------------------------------------------------------------------------
# Eviction / bytes accounting
# ---------------------------------------------------------------------------

def _lru(m):
    b = m.data.many_cat_schema(n_cat=4, domain=8, n_rows=600, seed=8)
    rels = b.store.relations()
    tiny = m.Store(rels, view_cache_bytes=20_000)  # force evictions
    cat = [f"c{i}" for i in range(4)]
    out = m.cat(tiny, b.vorder, CONT, cat)
    info = _info(tiny)
    assert info["view_cache_bytes"] <= 20_000 and info["view_cache_evictions"] > 0
    ref = m.cat(tiny, b.vorder, CONT, cat, use_view_cache=False)
    np.testing.assert_array_equal(out.matrix(), ref.matrix())
    off = m.Store(rels, view_cache_bytes=0)
    m.cat(off, b.vorder, CONT, cat)
    assert off.cache_info()["view_cache_entries"] == 0
    return [out.matrix(), info, vc_state(tiny)]


@pytest.mark.parametrize("fp32", [False, True], ids=["numpy", "fp32"])
def test_lru_eviction_bounded_and_correct(fp32):
    twin(_lru, fp32=fp32)


class _V:
    """Minimal view stub: ``n`` float64 counts, no key columns."""

    def __init__(self, n=5):
        self.keys = {}
        self.c = np.zeros(n)
        self.l = None
        self.q = None


def _unit_lru(m):
    vc = m.ViewCache(max_bytes=100)

    def key(i, degree=0):
        return m.ViewKey(("sig",), "numpy", "float64", i, (), frozenset(), degree)

    vc.put(key(0), _V(), frozenset({"R"}), version=0)
    vc.put(key(1), _V(), frozenset({"S"}), version=0)
    assert len(vc) == 2 and vc.bytes == 80
    vc.get(key(0), 0)  # refresh 0 — key(1) becomes LRU
    vc.put(key(2), _V(), frozenset({"T"}), version=0)
    assert vc.evictions == 1 and len(vc) == 2
    assert vc.get(key(1), 0) is None
    assert vc.get(key(0), 0) is not None
    assert vc.get(key(2), 99) is None  # version mismatch drops the entry
    assert len(vc) == 1
    vc.put(key(0, degree=2), _V(), frozenset({"R"}), version=0)
    assert vc.get(key(0, degree=0), 0) is None  # subsumed, not duplicated
    vc.invalidate_relation("R")
    assert len(vc) == 0 and vc.bytes == 0
    return [vc.info()]


def test_view_cache_unit_lru():
    twin(_unit_lru)


def _evict_all(m):
    b = m.data.many_cat_schema(n_cat=2, domain=6, n_rows=200, seed=9)
    store = b.store
    cold = m.cofactors_factorized(store, b.vorder, CONT, **m.bk)
    cold_visits = store.node_visits
    m.cat(store, b.vorder, CONT, ["c0"])
    warm_info = _info(store)
    assert warm_info["view_cache_entries"] > 0
    store.reset_counters()
    m.cofactors_factorized(store, b.vorder, CONT, **m.bk)
    assert store.node_visits == 0  # warm: served by the cache
    vc = store.view_cache
    evictions = vc.evictions
    n = vc.evict_all()
    assert n == warm_info["view_cache_entries"]
    after = vc.info()
    assert after["entries"] == 0 and after["bytes"] == 0
    assert after["evictions"] == evictions + n
    store.reset_counters()
    again = m.cofactors_factorized(store, b.vorder, CONT, **m.bk)
    assert store.node_visits == cold_visits  # recomputed from the leaves
    np.testing.assert_array_equal(again.matrix(), cold.matrix())
    return [n, warm_info, {k: v for k, v in after.items() if k != "max_bytes"},
            store.node_visits, again.matrix(), vc_state(store)]


@pytest.mark.parametrize("fp32", [False, True], ids=["numpy", "fp32"])
def test_evict_all_empties_the_cache_and_reads_recompute(fp32):
    twin(_evict_all, fp32=fp32)


def _replace_budget(m):
    vc = m.ViewCache(max_bytes=100)

    def key(i):
        return m.ViewKey(("sig",), "numpy", "float64", i, (), frozenset(), 0)

    vc.put(key(0), _V(5), frozenset({"R"}), version=0)
    vc.put(key(1), _V(5), frozenset({"S"}), version=0)
    vc.replace(key(1), _V(11))  # grows to 88 bytes -> over budget
    assert vc.bytes <= vc.max_bytes
    assert vc.evictions == 1 and vc.get(key(0), 0) is None
    assert vc.get(key(1), 0) is not None
    return [vc.info()]


def test_replace_respects_byte_budget():
    twin(_replace_budget)


def test_view_nbytes_of_a_tensor_never_goes_through_numpy(monkeypatch):
    """A view's blocks may live on the card: their bytes come from the
    tensor's metadata.  Meta tensors have no storage, so any host copy of
    them would raise; ``np.asarray`` is also made to refuse tensors."""
    real = np.asarray

    def no_tensors(a, *args, **kw):
        assert not isinstance(a, torch.Tensor), "a tensor went through numpy"
        return real(a, *args, **kw)

    monkeypatch.setattr(np, "asarray", no_tensors)
    view = types.SimpleNamespace(
        keys={"a": np.zeros(7, dtype=np.int32)},
        c=torch.empty(7, device="meta"),
        l=torch.empty(7, 3, device="meta"),
        q=torch.empty(7, 3, 3, dtype=torch.float64, device="meta"),
    )
    assert PVC.view_nbytes(view) == 7 * 4 + 7 * 4 + 21 * 4 + 63 * 8
    vc = PVC.ViewCache(max_bytes=10_000)
    key = PVC.ViewKey(("sig",), "torch", "float32", 0, (), frozenset(), 2)
    vc.put(key, view, frozenset({"R"}), version=0)
    assert vc.bytes == PVC.view_nbytes(view)


# ---------------------------------------------------------------------------
# cached ≡ uncached under mutation interleavings
# ---------------------------------------------------------------------------

def _cached_vs_uncached(m, store, vorder, cont, cat):
    cached = m.cat(store, vorder, cont, cat)
    fresh = m.cat(store, vorder, cont, cat, use_view_cache=False)
    scale = max(1.0, float(np.abs(fresh.matrix()).max()))
    np.testing.assert_allclose(cached.matrix(), fresh.matrix(), rtol=1e-12,
                               atol=1e-12 * scale)
    return cached.matrix()


def _apply_op(m, store, op: int, rng) -> str:
    names = store.names()
    name = names[op % len(names)]
    rel = store.get(name)
    kind = (op // len(names)) % 3
    if kind == 0:  # append (occasionally with unseen ids)
        store.append(name, _delta_for(m, rel, rng, int(rng.integers(1, 8)),
                                      grow=bool(op % 2)))
    elif kind == 1:  # put: replace with a perturbed copy
        values = {a: c + rng.normal(0, 0.1, len(c)) for a, c in rel.values.items()}
        store.put(m.Relation(rel.name, dict(rel.keys), values, dict(rel.domains)))
    else:  # FD churn
        store.infer_fds()
        fds = store.fds()
        if fds:
            fd = fds[int(rng.integers(0, len(fds)))]
            store.drop_fd(fd.lhs, fd.rhs)
    return f"{('append', 'put', 'fd')[kind]}:{name}"


def _interleavings(m, seed):
    b = m.data.random_acyclic_schema(seed, n_branches=(seed % 3) + 1)
    cat = ["k0"] + [f"k{i + 1}" for i in range(len(b.features) // 2)]
    cont = b.features + [b.label]
    rng = np.random.default_rng(seed)
    rec = [_cached_vs_uncached(m, b.store, b.vorder, cont, cat)]
    for _op in range(5):
        rec.append(_apply_op(m, b.store, int(rng.integers(0, 30)), rng))
        rec.append(_cached_vs_uncached(m, b.store, b.vorder, cont, cat))
        rec.append(_info(b.store))
        rec.append(vc_state(b.store))
    return rec


@pytest.mark.parametrize("seed", range(6))
def test_cached_equals_uncached_interleavings_deterministic(seed):
    twin(_interleavings, seed=seed)


def _warm_retrain(m):
    b = m.data.fd_star_schema(n_cat=2, domain=8, dep_domain=3, n_rows=300, seed=9)
    b.store.infer_fds()
    cfg = dataclasses.replace(m.core.VERSIONS["closed"], backend="numpy")
    if not m.ref:
        cfg = dataclasses.replace(cfg, device="cpu")
    warm_cfg = dataclasses.replace(cfg, use_cache=True)
    rec = [m.core.linear_regression(b.store, b.vorder, ["x"], "y", warm_cfg).theta]
    rng = np.random.default_rng(2)
    for _ in range(3):
        b.store.append("Fact", _delta_for(m, b.store.get("Fact"), rng, 25))
        warm = m.core.linear_regression(b.store, b.vorder, ["x"], "y", warm_cfg)
        fresh = m.core.linear_regression(b.store, b.vorder, ["x"], "y", cfg)
        np.testing.assert_allclose(warm.theta, fresh.theta, rtol=1e-8, atol=1e-8)
        rec += [warm.theta, _info(b.store)]
    return rec


def test_store_cofactors_warm_after_mutations():
    twin(_warm_retrain)


def _mixed_degrees(m):
    b = m.data.many_cat_schema(n_cat=2, domain=6, n_rows=250, seed=11)
    e1 = m.FactorizedEngine(b.store, b.vorder, CONT, **m.bk)
    e1.run_batch([m.AggregateQuery("g", ("c0",), 1)])  # degree-1 entries first
    e2 = m.FactorizedEngine(b.store, b.vorder, CONT, **m.bk)
    e2.run_batch([m.AggregateQuery("base", (), 2)])  # degree-2 entries after
    b.store.append("Fact", _delta_for(m, b.store.get("Fact"), np.random.default_rng(4), 25))
    b.store.flush()  # folds both degrees, highest first
    state = vc_state(b.store)
    out = m.cat(b.store, b.vorder, CONT, ["c0"])
    ref = m.cat(b.store, b.vorder, CONT, ["c0"], use_view_cache=False)
    np.testing.assert_allclose(out.matrix(), ref.matrix(), rtol=1e-5, atol=1e-3)
    return [state, out.matrix(), _info(b.store)]


@pytest.mark.parametrize("fp32", [False, True], ids=["numpy", "fp32"])
def test_append_after_mixed_degree_batches(fp32):
    twin(_mixed_degrees, fp32=fp32)


def _stale_engine(m):
    b = m.data.many_cat_schema(n_cat=2, domain=6, n_rows=250, seed=12)
    stale = m.FactorizedEngine(b.store, b.vorder, CONT, backend="numpy")
    rel = b.store.get("Fact")
    rng = np.random.default_rng(5)
    values = {a: c + rng.normal(0, 1, len(c)) for a, c in rel.values.items()}
    b.store.put(m.Relation(rel.name, dict(rel.keys), values, dict(rel.domains)))
    stale.run_batch([m.AggregateQuery("base", (), 2)])  # snapshot semantics
    assert len(b.store.view_cache) == 0  # nothing stale was published
    fresh = m.cofactors_factorized(b.store, b.vorder, CONT, backend="numpy")
    ref = m.cofactors_factorized(b.store, b.vorder, CONT, backend="numpy",
                                 use_view_cache=False)
    np.testing.assert_array_equal(fresh.matrix(), ref.matrix())
    return [fresh.matrix(), _info(b.store)]


def test_stale_engine_does_not_poison_cache():
    twin(_stale_engine)


# ---------------------------------------------------------------------------
# The port's own design points: device-resident views and their folds
# ---------------------------------------------------------------------------

def _cross_dtype(m):
    """A float64 view of a node serves a float32 engine by a cast (onto the
    engine's device in the port) — a warm float32 batch over float64-cached
    subtrees visits no node."""
    b = m.data.many_cat_schema(n_cat=2, domain=6, n_rows=250, seed=13)
    m.cofactors_factorized(b.store, b.vorder, CONT, backend="numpy")
    kw = {"backend": "jax"} if m.ref else {"backend": "torch", "device": "cpu"}
    eng = m.FactorizedEngine(b.store, b.vorder, CONT, **kw)
    out = eng.cofactors()
    assert eng.node_visits == 0 and eng.vc_hits > 0
    return [out.matrix(), eng.vc_hits, eng.vc_misses, _info(b.store)]


def test_float64_views_serve_a_float32_engine():
    twin(_cross_dtype)


def test_drain_keeps_blocks_on_their_device_and_regroups_through_segment_blocks(
    monkeypatch,
):
    """A torch-backend drain folds each cached view with ``torch.cat`` and
    one ``segment_blocks`` regroup: the folded blocks are tensors again, and
    every merge regroups through the kernel entry point (on a CUDA tensor,
    kernel 3; on the CPU, its plain version)."""
    m = _pkg(False, True)
    b = m.data.many_cat_schema(n_cat=2, domain=6, n_rows=250, seed=14)
    m.cat(b.store, b.vorder, CONT, ["c0", "c1"])
    n_entries = len(b.store.view_cache)
    b.store.append("Fact", _delta_for(m, b.store.get("Fact"), np.random.default_rng(6), 30))
    calls = []
    merging = []
    real_blocks, real_merge = kops.segment_blocks, PF.FactorizedEngine._merge_views

    def blocks(*a, **k):
        if merging:
            calls.append((tuple(a[0].shape), a[4]))
        return real_blocks(*a, **k)

    def merge(self, a, b_, degree):
        merging.append(1)
        try:
            return real_merge(self, a, b_, degree)
        finally:
            merging.pop()

    monkeypatch.setattr(kops, "segment_blocks", blocks)
    monkeypatch.setattr(PF.FactorizedEngine, "_merge_views", merge)
    b.store.flush()
    folded = [e for _, e in b.store.view_cache.items() if "Fact" in e.relations]
    assert folded and len(calls) == len(folded) <= n_entries
    for e in folded:
        for blk in (e.view.c, e.view.l, e.view.q):
            assert blk is None or isinstance(blk, torch.Tensor)
    # each merge regroups cached ⊎ delta rows into at most that many groups
    assert all(num <= rows for (rows,), num in calls)


def test_exact_hit_moves_onto_the_engine_device():
    """A view key names no device, so an engine can hit a view that another
    engine built on another device.  It is served on the engine's own
    device (meta tensors here stand in for the card: they hold no data, so
    the test only reads where the blocks live); the cached entry stays where
    it was built, and an engine on that device gets it as it is."""
    m = _pkg(False, True)
    b = m.data.many_cat_schema(n_cat=2, domain=6, n_rows=250, seed=15)
    m.cofactors_factorized(b.store, b.vorder, CONT, backend="torch", device="cpu")
    cached = list(b.store.view_cache.items())
    assert cached
    for device in ("meta", "cpu"):
        eng = m.FactorizedEngine(
            b.store, b.vorder, CONT, backend="torch", device=device
        )
        for key, entry in cached:
            view = eng._vc_get(eng._nodes[key.node], key.keep, key.degree)
            assert view is not None and view.degree == key.degree
            for blk, was in zip((view.c, view.l, view.q),
                                (entry.view.c, entry.view.l, entry.view.q)):
                if blk is None:
                    continue
                assert blk.device.type == device and blk.dtype == was.dtype
                assert (blk is was) == (device == "cpu")
                assert was.device.type == "cpu"
            assert list(view.keys) == list(entry.view.keys)
        assert eng.vc_hits == len(cached) and eng.vc_misses == 0


def test_result_entries_are_keyed_by_device(monkeypatch):
    """A torch read on one device never gets the entry another device's
    read cached (its blocks live there, and the drain folds it there); a
    numpy entry lives on the host whatever ``device`` says."""
    m = _pkg(False, True)
    b = m.data.many_cat_schema(n_cat=2, domain=6, n_rows=250, seed=16)
    cpu = b.store.cofactors(b.vorder, CONT, backend="torch", device="cpu")
    cpu_cat = b.store.cat_cofactors(b.vorder, CONT, ["c0"], backend="torch",
                                    device="cpu")
    host = b.store.cofactors(b.vorder, CONT, backend="numpy", device="cpu")
    built = []

    class Engine:
        def __init__(self, *a, device, **k):
            built.append(("cont", str(device)))

        def cofactors(self):
            return "meta entry"

    def cat(*a, device, stats, **k):
        built.append(("cat", str(device)))
        stats.update(passes=0, node_visits=0)
        return "meta cat entry"

    monkeypatch.setattr(PF, "FactorizedEngine", Engine)
    monkeypatch.setattr(PCAT, "cat_cofactors_factorized", cat)
    store = b.store
    assert store.cofactors(b.vorder, CONT, backend="torch", device="meta") == "meta entry"
    assert store.cat_cofactors(b.vorder, CONT, ["c0"], backend="torch",
                               device="meta") == "meta cat entry"
    assert built == [("cont", "meta"), ("cat", "meta")]
    # every entry is served again on its own device, computing nothing
    assert store.cofactors(b.vorder, CONT, backend="torch", device="meta") == "meta entry"
    assert store.cofactors(b.vorder, CONT, backend="torch", device="cpu") is cpu
    assert store.cat_cofactors(b.vorder, CONT, ["c0"], backend="torch",
                               device="cpu") is cpu_cat
    assert store.cofactors(b.vorder, CONT, backend="numpy", device="meta") is host
    assert len(built) == 2
    assert store.cache_info()["entries"] == 3
    assert store.cache_info()["cat_entries"] == 2
