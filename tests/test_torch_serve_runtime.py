"""PyTorch port, the service's concurrent runtime held against the JAX
package's: threads, deadlines, backpressure and shutdown — one twin of each
test of ``tests/test_serve_runtime.py`` but the two lockset-sanitized
stress runs, which wait for the port's ``analysis`` package.

The invariants, in each package: no wedged tickets; every threaded result
equals the oracle of SOME catalog state the store passes through (1e-12 on
the numpy engine); the terminal store equals the sequential oracle; the
per-tenant counters sum to the store totals.  Across the packages
(``torch_serve_twin.twin``): the threaded runs' ticket outcomes (value or
error type, per ticket), the terminal state, and in the deterministic
scenarios every result, ``cache_info()`` and its tenant map.
"""

import threading
import time

import numpy as np
import pytest

from torch_serve_twin import info, outcome, pkg, same, tenant_sums_audit, twin

DOMAIN = 6
FEATSETS = [("w0", "x", "y"), ("w1", "x", "y"), ("x", "y")]
SCORE_FS = ("x", "y")  # theta = [intercept, x-coef, -1 on label]
THETA = np.array([0.1, 0.5, -1.0])


def _relations(m, seed, dim0_variant=False):
    """Fact(c0, c1, x, y) ⋈ Dim_i(c_i, …, w_i).  Dim0 carries a
    *determined* key ``d0 = c0 % 3`` (unique c0 keys), so ``c0 → d0`` is
    a real FD the mutator thread can add/drop.  ``dim0_variant`` swaps
    Dim0's payload — the mutator's ``put`` alternates the two."""
    rng = np.random.default_rng(seed)
    n = 240
    keys = {
        f"c{i}": rng.integers(0, DOMAIN, n).astype(np.int32) for i in range(2)
    }
    x = rng.normal(0, 2.0, n)
    y = 0.5 * x + rng.normal(0, 0.5, n)
    rels = [
        m.Relation.from_columns(
            "Fact", keys, {"x": x, "y": y}, {f"c{i}": DOMAIN for i in range(2)}
        )
    ]
    c = np.arange(DOMAIN, dtype=np.int32)
    w0 = rng.normal(0, 1.0, DOMAIN)
    if dim0_variant:
        w0 = w0 + 10.0  # decisively different payload
    rels.append(
        m.Relation.from_columns(
            "Dim0", {"c0": c, "d0": (c % 3).astype(np.int32)}, {"w0": w0},
            {"c0": DOMAIN, "d0": 3},
        )
    )
    rels.append(
        m.Relation.from_columns(
            "Dim1", {"c1": c.copy()}, {"w1": rng.normal(0, 1.0, DOMAIN)},
            {"c1": DOMAIN},
        )
    )
    return rels


def _vorder(m):
    VO = m.VariableOrder
    node = VO("x", [VO("y", [VO.leaf("Fact")])])
    w1 = VO("w1", [VO.leaf("Dim1")])
    node = VO("c1", [w1, node])
    d0 = VO("d0", [VO("w0", [VO.leaf("Dim0")])])
    node = VO("c0", [d0, node])
    return VO.intercept([node])


def _fixed_delta(m, seed=77, n_rows=20):
    rng = np.random.default_rng(seed)
    return m.Relation.from_columns(
        "delta",
        {f"c{i}": rng.integers(0, DOMAIN, n_rows).astype(np.int32)
         for i in range(2)},
        {"x": rng.normal(0, 2.0, n_rows), "y": rng.normal(0, 1.0, n_rows)},
    )


def _oracles(m, seed, max_appends):
    """oracle[(k, variant)][featset] = cofactor matrix of the catalog
    after k appends of the fixed delta with Dim0 in the given variant —
    the full state space a run can observe."""
    vorder = _vorder(m)
    delta = _fixed_delta(m)
    out = {}
    for variant in (False, True):
        store = m.Store(_relations(m, seed, dim0_variant=variant))
        for k in range(max_appends + 1):
            if k:
                store.append("Fact", delta)
            store.flush()
            out[(k, variant)] = {
                fs: m.fz.cofactors_factorized(
                    store, vorder, list(fs), backend="numpy",
                    use_view_cache=False,
                ).matrix()
                for fs in FEATSETS
            }
    return out


def _matches(mat, oracle_mat, rtol):
    scale = max(1.0, float(np.abs(oracle_mat).max()))
    return np.allclose(mat, oracle_mat, rtol=rtol, atol=rtol * scale)


def _assert_explainable(kind, fs, value, oracles, rtol):
    """A threaded result must equal SOME reachable catalog state's oracle
    (linearizability against the state-space oracle)."""
    cands = [o[fs] for o in oracles.values()]
    if kind == "score":
        ok = any(
            np.isclose(value.sse, float(THETA @ mat @ THETA), rtol=rtol,
                       atol=1e-9 if rtol <= 1e-12 else rtol * abs(value.sse))
            for mat in cands
        )
    else:  # cofactors
        ok = any(_matches(value.matrix(), mat, rtol) for mat in cands)
    assert ok, f"{kind} result over {fs} matches no reachable state"


def _run_threaded(m, seed, n_tenants, ops_per_tenant, mutator_flips, window):
    """One threaded stress run: tenant threads (train / score / cofactors /
    append through the service) against a mutator thread doing direct
    ``put`` / ``add_fd`` / ``drop_fd`` on the shared store.  Returns
    (store, outcomes in a fixed order, service info)."""
    store = m.Store(_relations(m, seed))
    store.add_fd("c0", "d0")
    vorder = _vorder(m)
    delta = _fixed_delta(m)
    svc = m.Service(store, window=window)
    svc.start(m.sv.RuntimeConfig(poll_interval=0.002, fold_interval=0.004))
    outcomes = {}  # tid -> [(kind, featset, ticket)]
    dim0_orig = _relations(m, seed)[1]
    dim0_alt = _relations(m, seed, dim0_variant=True)[1]

    def tenant(tid):
        rng = np.random.default_rng(1000 + tid)
        mine = outcomes[tid] = []
        for i in range(ops_per_tenant):
            roll = rng.integers(0, 5)
            if roll == 0:
                mine.append(("append", None,
                             svc.append(f"t{tid}", "Fact", delta)))
            elif roll == 1:
                mine.append(("score", SCORE_FS, svc.score(
                    f"t{tid}", vorder, ["x"], label="y", theta=THETA)))
            elif roll == 2:
                mine.append(("train", None,
                             svc.train(f"t{tid}", vorder, ["x"], "y")))
            else:
                fs = FEATSETS[int(rng.integers(0, len(FEATSETS)))]
                mine.append(("cofactors", fs,
                             svc.cofactors(f"t{tid}", vorder, list(fs))))
            if i % 2:
                time.sleep(0.001)

    def mutator():
        for i in range(mutator_flips):
            store.put(dim0_alt if i % 2 == 0 else dim0_orig)
            store.drop_fd("c0", "d0")
            time.sleep(0.002)
            store.add_fd("c0", "d0")
        if mutator_flips % 2:  # always end on the original payload
            store.put(dim0_orig)

    threads = [
        threading.Thread(target=tenant, args=(tid,)) for tid in range(n_tenants)
    ] + [threading.Thread(target=mutator)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    svc.stop(drain=True, timeout=30)
    ordered = [o for tid in range(n_tenants) for o in outcomes[tid]]
    return store, ordered, svc.cache_info()


def _check_run(m, seed, store, outcomes, svc_info, rtol=1e-12):
    n_appends = sum(1 for kind, _, _ in outcomes if kind == "append")
    oracles = _oracles(m, seed, n_appends)
    for kind, fs, ticket in outcomes:
        assert ticket.done, "wedged ticket after stop()"
        value = ticket.result()  # raises if any request failed
        if kind == "append":
            continue
        if kind == "train":  # solved against SOME consistent snapshot
            assert np.isfinite(value.theta).all()
            continue
        _assert_explainable(kind, fs, value, oracles, rtol)
    # terminal state ≡ the sequential oracle (same ops in ANY serial order
    # land here: appends commute, the mutator ended on the original)
    store.flush()
    final = m.fz.cofactors_factorized(
        store, _vorder(m), list(FEATSETS[0]), backend="numpy",
        use_view_cache=False,
    ).matrix()
    assert _matches(final, oracles[(n_appends, False)][FEATSETS[0]], 1e-12)
    assert store.cache_info()["pending_rows"] == 0
    # exact accounting survived the threading (vc_bytes is not summed: the
    # mutator's direct put() invalidates entries outside any request)
    tenant_sums_audit(svc_info)
    return {
        "outcomes": [(kind, "error" in outcome(t)) for kind, _, t in outcomes],
        "final": final,
    }


def _stress(m, seed, **kw):
    store, outcomes, svc_info = _run_threaded(m, seed, **kw)
    return _check_run(m, seed, store, outcomes, svc_info)


# ---------------------------------------------------------------------------
# threaded ≡ sequential stress
# ---------------------------------------------------------------------------

def test_threaded_stress_matches_sequential_oracle():
    twin(_stress, seed=5, n_tenants=4, ops_per_tenant=6, mutator_flips=6,
         window=3)


def test_threaded_stress_unwindowed():
    twin(_stress, seed=11, n_tenants=3, ops_per_tenant=5, mutator_flips=4,
         window=None)


def test_hypothesis_schedule_variant():
    hypothesis = pytest.importorskip("hypothesis")
    st = hypothesis.strategies

    @hypothesis.settings(
        max_examples=5, deadline=None,
        suppress_health_check=list(hypothesis.HealthCheck),
    )
    @hypothesis.given(seed=st.integers(min_value=0, max_value=10**6))
    def inner(seed):
        twin(_stress, seed=seed % 97, n_tenants=3, ops_per_tenant=4,
             mutator_flips=seed % 5, window=2)

    inner()


def test_threaded_torch_service_matches_sequential_oracle():
    """The port's torch engine served from the drain worker thread (the
    kernels' plain versions on the CPU): every result within float32 reach
    of a reachable state's float64 oracle, the terminal state exact."""
    m = pkg(False, True)
    store, outcomes, svc_info = _run_threaded(
        m, 5, n_tenants=4, ops_per_tenant=6, mutator_flips=6, window=3
    )
    _check_run(m, 5, store, outcomes, svc_info, rtol=1e-5)


# ---------------------------------------------------------------------------
# tickets: timeout, deadlines
# ---------------------------------------------------------------------------

def _result_timeout(m):
    svc = m.Service(m.Store(_relations(m, 0)))
    t = svc.cofactors("a", _vorder(m), ["x", "y"])
    with pytest.raises(m.sv.ServiceTimeout):
        t.result(timeout=0.05)
    svc.drain()
    assert t.result(timeout=0.05).count > 0
    return {"ticket": outcome(t), "info": info(svc)}


def test_result_timeout_raises_typed_error():
    twin(_result_timeout)


def _sync_result(m):
    svc = m.Service(m.Store(_relations(m, 0)))
    t = svc.cofactors("a", _vorder(m), ["x", "y"])
    with pytest.raises(RuntimeError, match="not served yet"):
        t.result()
    return {"done": t.done}


def test_sync_result_without_timeout_still_raises_runtimeerror():
    twin(_sync_result)


def _deadline(m):
    svc = m.Service(m.Store(_relations(m, 0)))
    vorder = _vorder(m)
    doomed = svc.cofactors("a", vorder, ["x", "y"], deadline=0.001)
    healthy = svc.cofactors("b", vorder, ["w0", "x", "y"])
    time.sleep(0.01)
    svc.drain()
    assert healthy.done and doomed.done
    with pytest.raises(m.sv.ServiceTimeout):
        doomed.result()
    assert healthy.result().count > 0
    out = info(svc)
    assert out["tenants"]["a"]["failures"] == 1
    assert out["tenants"]["b"]["failures"] == 0
    return {"tickets": [outcome(doomed), outcome(healthy)], "info": out}


def test_deadline_expiry_fails_one_ticket_not_its_window():
    twin(_deadline)


def _default_deadline(m):
    svc = m.Service(m.Store(_relations(m, 0)), default_deadline=0.001)
    t = svc.cofactors("a", _vorder(m), ["x", "y"])
    time.sleep(0.01)
    svc.drain()
    with pytest.raises(m.sv.ServiceTimeout):
        t.result()
    return {"ticket": outcome(t), "info": info(svc)}


def test_default_deadline_applies_to_unmarked_requests():
    twin(_default_deadline)


# ---------------------------------------------------------------------------
# backpressure
# ---------------------------------------------------------------------------

def _reject(m):
    svc = m.Service(m.Store(_relations(m, 0)), max_queue=2,
                    backpressure="reject")
    vorder = _vorder(m)
    svc.cofactors("a", vorder, ["x", "y"])
    svc.cofactors("a", vorder, ["x", "y"])
    with pytest.raises(m.sv.ServiceOverloaded):
        svc.cofactors("a", vorder, ["x", "y"])
    assert svc.run() == 2
    return info(svc)


def test_backpressure_reject_raises_at_submit():
    twin(_reject)


def _shed(m):
    svc = m.Service(m.Store(_relations(m, 0)), max_queue=2,
                    backpressure="shed_oldest")
    vorder = _vorder(m)
    t1 = svc.cofactors("a", vorder, ["x", "y"])
    t2 = svc.cofactors("b", vorder, ["x", "y"])
    t3 = svc.cofactors("c", vorder, ["w0", "x", "y"])  # sheds t1
    assert t1.done
    with pytest.raises(m.sv.ServiceOverloaded):
        t1.result()
    svc.run()
    assert t2.result().count > 0 and t3.result().count > 0
    out = info(svc)
    assert out["shed"] == 1
    assert out["tenants"]["a"]["failures"] == 1
    return {"tickets": [outcome(t) for t in (t1, t2, t3)], "info": out}


def test_backpressure_shed_oldest_fails_oldest_read():
    twin(_shed)


def _block_timeout(m):
    svc = m.Service(m.Store(_relations(m, 0)), max_queue=1,
                    backpressure="block", admission_timeout=0.05)
    svc.cofactors("a", _vorder(m), ["x", "y"])
    with pytest.raises(m.sv.ServiceOverloaded):
        svc.cofactors("a", _vorder(m), ["x", "y"])
    return {"pending": svc.pending()}


def test_backpressure_block_times_out_without_a_drainer():
    twin(_block_timeout)


def _block_runtime(m):
    svc = m.Service(m.Store(_relations(m, 0)), max_queue=1,
                    backpressure="block", admission_timeout=10.0)
    svc.start(m.sv.RuntimeConfig(poll_interval=0.002))
    vorder = _vorder(m)
    tickets = [svc.cofactors("a", vorder, ["x", "y"]) for _ in range(6)]
    for t in tickets:
        assert t.result(timeout=10).count > 0
    svc.stop()
    return {"tickets": [outcome(t) for t in tickets],
            "requests": svc.cache_info()["tenants"]["a"]["requests"]}


def test_backpressure_block_admits_under_runtime():
    twin(_block_runtime)


# ---------------------------------------------------------------------------
# runtime lifecycle
# ---------------------------------------------------------------------------

def _stop_drains(m):
    svc = m.Service(m.Store(_relations(m, 0)), window=1)
    svc.start(m.sv.RuntimeConfig(poll_interval=0.002, fold_interval=0.004))
    vorder = _vorder(m)
    tickets = [svc.cofactors("a", vorder, ["x", "y"]) for _ in range(8)]
    tickets.append(svc.append("w", "Fact", _fixed_delta(m)))
    svc.stop(drain=True, timeout=30)
    assert all(t.done for t in tickets)
    for t in tickets:
        t.result()  # none failed: drain served them all
    with pytest.raises(m.sv.ServiceStopped):
        svc.cofactors("a", vorder, ["x", "y"])
    out = svc.cache_info()
    # which reads the worker serves before the append is timing: compare
    # outcomes, not values
    return {"failed": ["error" in outcome(t) for t in tickets],
            "tenants": {k: v["requests"] + v["appends"]
                        for k, v in out["tenants"].items()},
            "running": out["running"], "pending_rows": out["pending_rows"]}


def test_stop_drains_and_resolves_everything():
    twin(_stop_drains)


def _stop_no_drain(m):
    svc = m.Service(m.Store(_relations(m, 0)))
    vorder = _vorder(m)
    tickets = [svc.cofactors("a", vorder, ["x", "y"]) for _ in range(3)]
    svc.stop(drain=False)  # never started: queue is untouched
    for t in tickets:
        assert t.done
        with pytest.raises(m.sv.ServiceStopped):
            t.result()
    out = info(svc)
    assert out["tenants"]["a"]["failures"] == 3
    return {"tickets": [outcome(t) for t in tickets], "info": out}


def test_stop_without_drain_fails_pending_with_service_stopped():
    twin(_stop_no_drain)


def _restart(m):
    svc = m.Service(m.Store(_relations(m, 0)))
    svc.start()
    svc.stop()
    svc.start(m.sv.RuntimeConfig(poll_interval=0.002))
    t = svc.cofactors("a", _vorder(m), ["x", "y"])
    assert t.result(timeout=10).count > 0
    svc.stop()
    return {"ticket": outcome(t), "info": info(svc)}


def test_restart_after_stop_serves_again():
    twin(_restart)


def _background_fold(m):
    store = m.Store(_relations(m, 0))  # lazy maintenance by default
    # seed the caches so the append leaves real fold debt; the seeding read
    # is not a service request, so zero counters before auditing
    store.cofactors(_vorder(m), ["x", "y"], backend="numpy")
    store.reset_counters()
    svc = m.Service(store, flush_policy="never")
    svc.start(m.sv.RuntimeConfig(poll_interval=0.002, fold_interval=0.004))
    t = svc.append("w", "Fact", _fixed_delta(m))
    t.result(timeout=10)
    assert svc.fold_debt_rows() > 0 or store.cache_info()["drains"] > 0
    deadline = time.monotonic() + 10
    while svc.fold_debt_rows() > 0 and time.monotonic() < deadline:
        time.sleep(0.01)
    svc.stop()
    assert svc.fold_debt_rows() == 0  # the fold thread paid the debt
    assert store.cache_info()["drains"] >= 1
    # fold cost was charged to the writer, so sums still audit
    out = svc.cache_info()
    tenants = out["tenants"].values()
    assert sum(t["node_visits"] for t in tenants) == out["node_visits"]
    return {"ticket": outcome(t), "info": info(svc)}


def test_background_fold_thread_services_delta_debt():
    twin(_background_fold)


def _poisoned_cycle(m):
    svc = m.Service(m.Store(_relations(m, 0)))
    svc.start(m.sv.RuntimeConfig(poll_interval=0.002))
    VO = m.VariableOrder
    bad_vorder = VO.intercept([VO("zz", [VO.leaf("Nope")])])
    bad = svc.cofactors("a", bad_vorder, ["zz"])
    # any propagated error proves the poisoned cycle failed the request
    # instead of wedging the worker; the twin compares the type
    with pytest.raises(Exception):  # noqa: B017
        bad.result(timeout=10)
    good = svc.cofactors("a", _vorder(m), ["x", "y"])
    assert good.result(timeout=10).count > 0  # worker thread survived
    svc.stop()
    return {"tickets": [outcome(bad), outcome(good)], "info": info(svc)}


def test_worker_survives_poisoned_cycle():
    twin(_poisoned_cycle)


def test_threaded_ticket_outcomes_equal_the_sequential_run():
    """The same requests through the threaded runtime and through
    synchronous ``run()``: per ticket the same outcome (value or error
    type), the values within float32 reach on the torch engine, and the
    port's threaded run equals the reference's sequential one."""

    def requests(m, threaded):
        svc = m.Service(m.Store(_relations(m, 3)), window=2)
        if threaded:
            svc.start(m.sv.RuntimeConfig(poll_interval=0.002,
                                         fold_interval=0.004))
        vorder = _vorder(m)
        VO = m.VariableOrder
        bad = VO.intercept([VO("zz", [VO.leaf("Nope")])])
        tickets = []
        for i in range(9):
            fs = list(FEATSETS[i % 3])
            if i == 4:
                tickets.append(svc.cofactors("t1", bad, ["zz"]))
            elif i % 4 == 3:
                tickets.append(svc.append("w", "Fact", _fixed_delta(m)))
            else:
                tickets.append(svc.cofactors(f"t{i % 2}", vorder, fs))
            # one request a cycle: the worker's, or a synchronous drain
            if threaded:
                tickets[-1].wait(10)
            else:
                svc.drain()
        svc.stop()
        return [outcome(t) for t in tickets]

    for fp32 in (False, True):
        rtol = 1e-5 if fp32 else 1e-12
        want = requests(pkg(True, fp32), threaded=False)
        assert "error" in want[4] and sum("error" in w for w in want) == 1
        same(requests(pkg(True, fp32), threaded=True), want, rtol)
        same(requests(pkg(False, fp32), threaded=False), want, rtol)
        same(requests(pkg(False, fp32), threaded=True), want, rtol)
