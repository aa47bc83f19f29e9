"""PyTorch port, the service under deterministic seeded faults held against
the JAX package's — one twin of each test of ``tests/test_serve_faults.py``.

Every scenario drives the port's ``FaultInjector`` (wrapping the real
store) through ``FactorizedService``, and the reference's likewise, on the
same numpy-seeded relations.  In each package: every admitted ticket
resolves or fails with a typed error; after the faults the store's reads
equal a never-faulted store's at 1e-12 with no delta debt left; per-tenant
counters still sum to the store totals.  Across the packages
(``torch_serve_twin.twin``): the ``fired`` sequences of one seed, the
ticket outcomes, ``cache_info()`` with its tenant map, ``retries``,
``shed`` and the quarantine records' kinds, equal.
"""

import numpy as np
import pytest

from torch_serve_twin import FP32, info, outcome, pkg, same, tenant_sums_audit, tight, twin

DOMAIN = 8
N_ROWS = 260


def _schema(m, seed=0):
    """Fact(c0, c1, x, y) ⋈ Dim0(c0, w0) ⋈ Dim1(c1, w1), bushy order."""
    VO = m.VariableOrder
    rng = np.random.default_rng(seed)
    keys = {
        f"c{i}": rng.integers(0, DOMAIN, N_ROWS).astype(np.int32)
        for i in range(2)
    }
    x = rng.normal(0, 2.0, N_ROWS)
    y = 0.5 * x + rng.normal(0, 0.5, N_ROWS)
    rels = [
        m.Relation.from_columns(
            "Fact", keys, {"x": x, "y": y}, {f"c{i}": DOMAIN for i in range(2)},
        )
    ]
    for i in range(2):
        rels.append(
            m.Relation.from_columns(
                f"Dim{i}",
                {f"c{i}": rng.integers(0, DOMAIN, 30).astype(np.int32)},
                {f"w{i}": rng.normal(0, 1.0, 30)},
                {f"c{i}": DOMAIN},
            )
        )
    node = VO("x", [VO("y", [VO.leaf("Fact")])])
    for i in reversed(range(2)):
        w = VO(f"w{i}", [VO.leaf(f"Dim{i}")])
        node = VO(f"c{i}", [w, node])
    return rels, VO.intercept([node])


def _delta(m, seed=50, n_rows=20):
    rng = np.random.default_rng(seed)
    return m.Relation.from_columns(
        "delta",
        {f"c{i}": rng.integers(0, DOMAIN, n_rows).astype(np.int32)
         for i in range(2)},
        {"x": rng.normal(0, 2.0, n_rows), "y": rng.normal(0, 1.0, n_rows)},
    )


def _fresh_matrix(m, seed, feats, appended=()):
    """Oracle: the same logical content on a never-faulted store."""
    rels, vorder = _schema(m, seed)
    store = m.Store(rels)
    for d in appended:
        store.append("Fact", d)
    store.flush()
    return m.fz.cofactors_factorized(
        store, vorder, list(feats), backend="numpy", use_view_cache=False
    ).matrix()


def _check(m, t, want):
    """A served read against its float64 oracle (float32 reach on the
    float32 engines)."""
    got = t.result().matrix()
    if m.fp32:
        same(got, want, 1e-5)
    else:
        tight(got, want)


def _consistent(m, svc, inj, seed, vorder, appended=()):
    """Post-fault closure: state ≡ fresh store at 1e-12, zero delta debt,
    per-tenant counters sum to store totals exactly."""
    inj.disarm()
    feats = ["w0", "w1", "x", "y"]
    t = svc.cofactors("_audit", vorder, feats)
    svc.run()
    _check(m, t, _fresh_matrix(m, seed, feats, appended))
    assert inj.store.cache_info()["pending_rows"] == 0
    tenant_sums_audit(svc.cache_info())
    return outcome(t)


def _record(svc, inj, tickets, audit):
    return {"tickets": [outcome(t) for t in tickets], "fired": list(inj.fired),
            "info": info(svc), "audit": audit}


# ---------------------------------------------------------------------------
# node-visit faults: bisection, retry, exhaustion
# ---------------------------------------------------------------------------

def _bisected(m):
    """A transient fault poisons the MERGED traversal; the service bisects,
    the halves re-run clean (one-shot trap), every ticket resolves
    correctly, nothing is quarantined."""
    rels, vorder = _schema(m, 3)
    inj = m.sv.FaultInjector(m.Store(rels), seed=3)
    svc = m.Service(inj, window=4)
    featsets = [["w0", "x", "y"], ["w1", "x", "y"], ["x", "y"], ["w0", "w1", "y"]]
    tickets = [svc.cofactors(f"t{i}", vorder, fs) for i, fs in enumerate(featsets)]
    inj.fail_at_node_visit(3, transient=True)
    svc.run()
    assert [k for k, _ in inj.fired] == ["node_visit"]
    for t, fs in zip(tickets, featsets):
        _check(m, t, _fresh_matrix(m, 3, fs))
    out = svc.cache_info()
    assert out["retries"] == 0 and out["quarantined"] == 0
    return _record(svc, inj, tickets, _consistent(m, svc, inj, 3, vorder))


@pytest.mark.parametrize(**FP32)
def test_transient_node_fault_bisected_out_of_coalesced_window(fp32):
    twin(_bisected, fp32)


def _poisoned(m):
    """One genuinely bad request in a coalesced window fails ALONE: the
    bisection narrows the failure to it, quarantines it, and serves the
    three innocent co-riders correctly."""
    rels, vorder = _schema(m, 4)
    inj = m.sv.FaultInjector(m.Store(rels), seed=4)
    svc = m.Service(inj, window=4)
    good_fs = [["w0", "x", "y"], ["x", "y"], ["w1", "y"]]
    good = [svc.cofactors(f"g{i}", vorder, fs) for i, fs in enumerate(good_fs)]
    bad = svc.cofactors("evil", vorder, ["no_such_feature", "x"])
    svc.run()
    # the engine's raise type for a bad feature list is an implementation
    # detail here; the twin compares it across the packages
    with pytest.raises(Exception):  # noqa: B017
        bad.result()
    for t, fs in zip(good, good_fs):
        _check(m, t, _fresh_matrix(m, 4, fs))
    out = svc.cache_info()
    assert out["quarantined"] == 1
    assert out["tenants"]["evil"]["failures"] == 1
    (rec,) = svc.quarantined()
    assert rec["tenant"] == "evil" and rec["kind"] == "cofactors"
    return _record(svc, inj, good + [bad], _consistent(m, svc, inj, 4, vorder))


def test_poisoned_request_isolated_by_bisection():
    twin(_poisoned)


def _retry(m):
    rels, vorder = _schema(m, 5)
    inj = m.sv.FaultInjector(m.Store(rels), seed=5)
    svc = m.Service(inj, retry=m.sv.RetryPolicy(max_attempts=3, backoff=0.001))
    t = svc.cofactors("a", vorder, ["w0", "x", "y"])
    inj.fail_at_node_visit(2, transient=True)
    svc.run()
    _check(m, t, _fresh_matrix(m, 5, ["w0", "x", "y"]))
    out = svc.cache_info()
    assert out["retries"] == 1
    assert out["tenants"]["a"]["retries"] == 1
    assert out["quarantined"] == 0  # recovered, not quarantined
    return _record(svc, inj, [t], _consistent(m, svc, inj, 5, vorder))


@pytest.mark.parametrize(**FP32)
def test_retry_with_backoff_recovers_transient_fault(fp32):
    twin(_retry, fp32)


def _exhaustion(m):
    """Under a near-certain per-visit hazard every retry fails too: the
    ticket fails typed after max_attempts, is quarantined with its attempt
    count, and the service keeps serving."""
    rels, vorder = _schema(m, 6)
    inj = m.sv.FaultInjector(m.Store(rels), seed=6)
    svc = m.Service(inj, retry=m.sv.RetryPolicy(max_attempts=2, backoff=0.0005))
    inj.arm_random_node_faults(0.95, transient=True)
    t = svc.cofactors("a", vorder, ["x", "y"])
    svc.run()  # returns: no wedge even when everything faults
    with pytest.raises(m.sv.TransientInjectedFault):
        t.result()
    (rec,) = svc.quarantined()
    assert rec["attempts"] == 2
    assert svc.cache_info()["retries"] == 1
    return _record(svc, inj, [t], _consistent(m, svc, inj, 6, vorder))


def test_retry_exhaustion_fails_ticket_without_wedging():
    twin(_exhaustion)


def _terminal(m):
    rels, vorder = _schema(m, 7)
    inj = m.sv.FaultInjector(m.Store(rels), seed=7)
    svc = m.Service(inj, retry=m.sv.RetryPolicy(max_attempts=5))
    inj.fail_at_node_visit(2, transient=False)  # NOT retryable
    t = svc.cofactors("a", vorder, ["x", "y"])
    svc.run()
    with pytest.raises(m.sv.InjectedFault):
        t.result()
    assert svc.cache_info()["retries"] == 0
    return _record(svc, inj, [t], _consistent(m, svc, inj, 7, vorder))


def test_terminal_fault_fails_fast_despite_retry_policy():
    twin(_terminal)


# ---------------------------------------------------------------------------
# fold faults: lazy drain, idle flush, eager append
# ---------------------------------------------------------------------------

def _idle_fold(m):
    """A fold that dies mid-drain is absorbed by the service (counted and
    quarantined, never raised at a caller); the next read recomputes and
    matches a fresh store exactly."""
    rels, vorder = _schema(m, 8)
    inj = m.sv.FaultInjector(m.Store(rels), seed=8)
    svc = m.Service(inj, flush_policy="never")
    t0 = svc.cofactors("reader", vorder, ["w0", "x", "y"])
    svc.run()  # warm caches → the append below leaves real fold debt
    d = _delta(m, 51)
    tw = svc.append("writer", "Fact", d)
    svc.run()
    assert inj.store.cache_info()["pending_rows"] > 0
    inj.fail_next_fold(transient=False)
    stats = svc.flush()  # absorbed, not raised
    assert stats["rows"] == 0
    assert [k for k, _ in inj.fired] == ["fold"]
    out = svc.cache_info()
    assert out["fold_failures"] == 1
    recs = svc.quarantined()
    assert recs and recs[-1]["kind"] == "fold"
    return _record(svc, inj, [t0, tw],
                   _consistent(m, svc, inj, 8, vorder, appended=[d]))


@pytest.mark.parametrize(**FP32)
def test_poisoned_idle_fold_absorbed_and_state_recovers(fp32):
    twin(_idle_fold, fp32)


def _barrier_fold(m):
    """A transient fold fault at the drain cycle's read barrier is
    absorbed; the retry path (recompute on invalidated entries) serves the
    read correctly in the same run."""
    rels, vorder = _schema(m, 9)
    inj = m.sv.FaultInjector(m.Store(rels), seed=9)
    svc = m.Service(inj, retry=m.sv.RetryPolicy(max_attempts=3, backoff=0.001))
    svc.cofactors("reader", vorder, ["w1", "x", "y"])
    svc.run()
    d = _delta(m, 52)
    svc.append("writer", "Fact", d)
    svc.run()
    inj.fail_next_fold(transient=True)
    t = svc.cofactors("reader", vorder, ["w1", "x", "y"])
    svc.run()
    _check(m, t, _fresh_matrix(m, 9, ["w1", "x", "y"], [d]))
    return _record(svc, inj, [t],
                   _consistent(m, svc, inj, 9, vorder, appended=[d]))


def test_poisoned_read_barrier_fold_retried_to_success():
    twin(_barrier_fold)


def _eager_append(m):
    """Under eager maintenance a poisoned delta raises out of the append
    with the catalog EXACTLY as before: the write ticket fails, readers
    never see a partial append."""
    rels, vorder = _schema(m, 10)
    inj = m.sv.FaultInjector(m.Store(rels, maintenance="eager"), seed=10)
    svc = m.Service(inj)
    svc.cofactors("reader", vorder, ["w0", "x", "y"])
    svc.run()  # caches populated → the append has entries to fold into
    inj.fail_next_fold(transient=False)
    bad = svc.append("writer", "Fact", _delta(m, 53))
    svc.run()
    with pytest.raises(m.sv.InjectedFault):
        bad.result()
    assert svc.cache_info()["tenants"]["writer"]["failures"] == 1
    # catalog untouched: state ≡ fresh store WITHOUT the delta
    return _record(svc, inj, [bad],
                   _consistent(m, svc, inj, 10, vorder, appended=()))


def test_eager_poisoned_append_rejected_store_untouched():
    twin(_eager_append)


# ---------------------------------------------------------------------------
# cache-pressure storms
# ---------------------------------------------------------------------------

def _storms(m):
    """Evicting the ENTIRE view cache at every snapshot forces cold
    recomputes mid-workload: results stay exact, only the hit/miss mix
    moves."""
    rels, vorder = _schema(m, 11)
    inj = m.sv.FaultInjector(m.Store(rels), seed=11)
    svc = m.Service(inj)
    inj.arm_eviction_storms(every_snapshots=1)
    feats = ["w0", "w1", "x", "y"]
    d = _delta(m, 55)
    tickets = []
    for _ in range(3):
        tickets.append(svc.cofactors("a", vorder, feats))
        # a write per cycle republishes the snapshot → storm fires
        svc.append("writer", "Fact", d)
        svc.drain()
    final = svc.cofactors("a", vorder, feats)
    svc.run()
    for t, k in zip(tickets, (0, 1, 2)):
        _check(m, t, _fresh_matrix(m, 11, feats, appended=[d] * k))
    want = _fresh_matrix(m, 11, feats, appended=[d] * 3)
    _check(m, final, want)
    assert any(k == "evict_storm" for k, _ in inj.fired)
    assert inj.store.view_cache.evictions > 0
    inj.disarm()
    # post-storm warm path works again and counters audit (vc_bytes is
    # excluded: storms drop bytes outside request brackets by design)
    t = svc.cofactors("b", vorder, feats)
    svc.run()
    _check(m, t, want)
    tenant_sums_audit(svc.cache_info())
    assert inj.store.cache_info()["pending_rows"] == 0
    return _record(svc, inj, tickets + [final, t], None)


@pytest.mark.parametrize(**FP32)
def test_eviction_storms_never_change_results(fp32):
    twin(_storms, fp32)


# ---------------------------------------------------------------------------
# threaded runtime under randomized faults: the no-wedge theorem
# ---------------------------------------------------------------------------

def _gauntlet(m):
    """The full gauntlet: threaded runtime, random per-visit hazard,
    eviction storms, and a mid-run fold trap.  Every ticket resolves (value
    or typed error), the drained store equals a fresh one, and the
    accounting still sums."""
    rels, vorder = _schema(m, 12)
    inj = m.sv.FaultInjector(m.Store(rels), seed=12)
    svc = m.Service(inj, window=3,
                    retry=m.sv.RetryPolicy(max_attempts=3, backoff=0.0005))
    inj.arm_random_node_faults(0.02, transient=True)
    inj.arm_eviction_storms(every_snapshots=3)
    inj.fail_next_fold(nth=2, transient=True)
    svc.start(m.sv.RuntimeConfig(poll_interval=0.002, fold_interval=0.004))
    d = _delta(m, 54)
    featsets = [["w0", "x", "y"], ["w1", "x", "y"], ["x", "y"]]
    tickets = []
    n_appends = 0
    for i in range(24):
        if i % 6 == 5:
            tickets.append(svc.append("writer", "Fact", d))
            n_appends += 1
        else:
            fs = featsets[i % len(featsets)]
            tickets.append(svc.cofactors(f"t{i % 3}", vorder, fs))
    svc.stop(drain=True, timeout=60)
    errors = {outcome(t).get("error") for t in tickets} - {None}
    assert errors <= {"TransientInjectedFault", "ServiceStopped"}, errors
    assert sum("error" not in outcome(t) for t in tickets) > 0
    svc2 = m.Service(inj)
    inj.disarm()
    feats = ["w0", "w1", "x", "y"]
    t = svc2.cofactors("_audit", vorder, feats)
    svc2.run()
    _check(m, t, _fresh_matrix(m, 12, feats, appended=[d] * n_appends))
    assert inj.store.cache_info()["pending_rows"] == 0
    # which cycle a fault lands in is timing: the twin compares the audit
    assert {k for k, _ in inj.fired} <= {"evict_storm", "fold", "node_visit_random"}
    return {"audit": outcome(t)}


def test_threaded_runtime_under_random_faults_no_wedged_tickets():
    twin(_gauntlet)


def test_fired_sequences_equal_for_one_seed():
    """One seed, one arming, one synchronous workload: the port's injector
    fires the reference's faults in the same order, at the same visits."""

    def run(m):
        rels, vorder = _schema(m, 13)
        inj = m.sv.FaultInjector(m.Store(rels), seed=13)
        svc = m.Service(inj, window=2,
                        retry=m.sv.RetryPolicy(max_attempts=4, backoff=0.0))
        inj.arm_random_node_faults(0.2, transient=True)
        inj.arm_eviction_storms(every_snapshots=2)
        inj.fail_next_fold(nth=1, transient=True)
        d = _delta(m, 56)
        tickets = []
        for i in range(12):
            if i % 4 == 3:
                tickets.append(svc.append("writer", "Fact", d))
            else:
                tickets.append(svc.cofactors(
                    f"t{i % 3}", vorder, [["w0", "x", "y"], ["x", "y"]][i % 2]))
            if i % 2:
                svc.drain()
        svc.run()
        assert len(inj.fired) > 3
        return _record(svc, inj, tickets, None)

    same(run(pkg(False, False)), run(pkg(True, False)), 1e-12)
