"""PyTorch port, functional dependencies: the Store's FD catalog, reduction
planning, and FD-reduced solving with closed-form recovery, held against
the JAX package on the same ``fd_star_schema`` relations.

The anchor is the reference's identity: FD-reduced training equals the full
solve to numerical precision (1e-10) while issuing fewer GROUP BY queries.
Catalog contents (pairs, mappings, reduction plans) compare exactly; the
float64 solves compare with the reference at 1e-12 (BGD, float32 on either
side, at 1e-4).  With the float32
grouped-Gram kernel (its plain version here) the reduced and full solves
agree in what the model predicts on every join row (rtol 1e-5): θ itself is
pinned along the one-hot design's null directions only by the 0.006 ridge,
so float32 rounding of the grouped sums moves those components alone.
"""

import dataclasses

import numpy as np
import pytest

import repro.core as R
import repro.core.fd as RF
import repro.data.synthetic as RS
import repro_torch.core as P
import repro_torch.core.fd as PF
import repro_torch.data.synthetic as PS
from repro_torch.core.relation import Relation

CAT2 = ["c0", "c1", "d0", "d1"]
FEATS2 = ["x"] + CAT2
STAR = dict(n_cat=2, domain=12, dep_domain=4, n_rows=400, seed=5)


@pytest.fixture()
def bundles():
    pb, rb = PS.fd_star_schema(**STAR), RS.fd_star_schema(**STAR)
    assert pb.store.infer_fds() == rb.store.infer_fds()
    return pb, rb


def _fd_map(store):
    return {(f.lhs, f.rhs): f for f in store.fds()}


def _assert_reduction(got, want):
    assert got.order == want.order and got.kept == want.kept
    assert got.domains == want.domains and got.signature() == want.signature()
    assert set(got.dropped) == set(want.dropped)
    for g, (root, m) in want.dropped.items():
        assert got.dropped[g][0] == root
        np.testing.assert_array_equal(got.dropped[g][1], m)


def _closed(mod, factorized=True, **kw):
    cfg = dataclasses.replace(mod.VERSIONS["closed"], backend="numpy",
                              factorized=factorized, categorical=tuple(CAT2), **kw)
    return dataclasses.replace(cfg, device="cpu") if mod is P else cfg


def test_infer_fds_matches_reference(bundles):
    pb, rb = bundles
    got, want = _fd_map(pb.store), _fd_map(rb.store)
    assert list(got) == list(want)
    assert ("c0", "d0") in got and ("d0", "c0") not in got
    for key, fd in want.items():
        assert got[key].source == fd.source == "inferred"
        np.testing.assert_array_equal(got[key].mapping, fd.mapping)
    assert pb.store.infer_fds() == []  # already registered


def test_add_fd_declared_and_violations(bundles):
    store = bundles[0].store
    fd = store.add_fd("c0", "d0")
    assert fd.source == "declared" and _fd_map(store)[("c0", "d0")] is fd
    for lhs, rhs in (("d0", "c0"), ("c0", "x"), ("c0", "d1")):
        with pytest.raises(ValueError):
            store.add_fd(lhs, rhs)
    store.drop_fd("c0", "d0")
    store.drop_fd("c0", "d0")  # dropping an absent FD is a no-op
    assert ("c0", "d0") not in _fd_map(store)


def test_reduction_plans_match_reference(bundles):
    pb, rb = bundles
    for cat in (CAT2, ["d0", "c0"], ["c0", "d0", "d1", "c1"], ["c1"]):
        _assert_reduction(pb.store.fd_reduction(cat), rb.store.fd_reduction(cat))
    red = pb.store.fd_reduction(CAT2)
    assert pb.store.fd_reduction(CAT2) is red  # memoized
    assert set(red.dropped) == {"d0", "d1"} and red.root_deps() == {
        "c0": ["d0"], "c1": ["d1"]
    }
    pb.store.drop_fd("c0", "d0")
    assert set(pb.store.fd_reduction(CAT2).dropped) == {"d1"}


def test_reduction_plan_composes_chains():
    cols = dict(a=np.array([0, 1, 2, 3], np.int32), b=np.array([0, 0, 1, 1], np.int32))
    rels = lambda mod: [  # noqa: E731
        mod.Relation.from_columns("R", cols, {"v": np.zeros(4)}),
        mod.Relation.from_columns(
            "S", {"b": np.array([0, 1], np.int32), "c": np.array([1, 0], np.int32)},
            {"w": np.zeros(2)},
        ),
    ]
    store, rstore = P.Store(rels(P)), R.Store(rels(R))
    assert store.infer_fds() == rstore.infer_fds()
    red = store.fd_reduction(["a", "b", "c"])
    _assert_reduction(red, rstore.fd_reduction(["a", "b", "c"]))
    assert red.kept == ["a"]
    np.testing.assert_array_equal(red.dropped["c"][1], [1, 1, 0, 0])
    np.testing.assert_array_equal(
        PF.compose_maps(red.dropped["b"][1], np.array([1, 0], np.int64)),
        red.dropped["c"][1],
    )
    trivial = PS.fd_star_schema(n_cat=1, domain=6, dep_domain=3, n_rows=50, seed=0)
    assert trivial.store.fd_reduction(["c0", "d0"]).is_trivial


@pytest.mark.parametrize("solver", ["closed_form", "bgd"])
def test_fd_reduced_linear_equals_full_and_reference(bundles, solver):
    pb, rb = bundles
    cap = dict(solver=solver, max_iter=3000)
    out = {}
    for fds in (True, False):
        out[fds] = P.linear_regression(pb.store, pb.vorder, FEATS2, "y",
                                       _closed(P, use_fds=fds, **cap))
        want = R.linear_regression(rb.store, rb.vorder, FEATS2, "y",
                                   _closed(R, use_fds=fds, **cap))
        assert out[fds].names == want.names
        if solver == "closed_form":
            np.testing.assert_allclose(out[fds].theta, want.theta, rtol=1e-12, atol=1e-12)
        else:
            # float32 BGD on either side on the unscaled one-hot matrix: the
            # update sum Σ|ε| nears ε = 1e-6 in rounding noise, so the step
            # it stops at differs by up to 10 %; θ agrees to 1e-4
            it = want.iterations
            assert abs(out[fds].iterations - it) <= 0.1 * it
            np.testing.assert_allclose(out[fds].theta, want.theta, rtol=1e-4, atol=1e-4)
    assert out[True].names == out[False].names
    if solver == "closed_form":
        np.testing.assert_allclose(out[True].theta, out[False].theta, rtol=0, atol=1e-10)


def test_fd_reduction_issues_fewer_group_by_queries(bundles):
    pb, rb = bundles
    pb.store.view_cache.enabled = False  # both runs traverse cold
    red = pb.store.fd_reduction(CAT2)
    stats = {}
    for cat in (CAT2, red.kept):
        stats[len(cat)] = {}
        P.cat_cofactors_factorized(pb.store, pb.vorder, ["x", "y"], cat,
                                   stats=stats[len(cat)])
    assert stats[2]["passes"] == stats[4]["passes"] == 1
    assert stats[2]["node_visits"] < stats[4]["node_visits"]
    rb.store.view_cache.enabled = False
    rstats = {}
    R.cat_cofactors_factorized(rb.store, rb.vorder, ["x", "y"], red.kept,
                               stats=rstats)
    assert rstats["node_visits"] == stats[2]["node_visits"]


def test_expand_cat_cofactors_matches_full_and_reference(bundles):
    pb, rb = bundles
    red = pb.store.fd_reduction(CAT2)
    full = P.cat_cofactors_factorized(pb.store, pb.vorder, ["x", "y"], CAT2)
    reduced = P.cat_cofactors_factorized(pb.store, pb.vorder, ["x", "y"], red.kept)
    assert reduced.num_params < full.num_params
    expanded = P.expand_cat_cofactors(reduced, red)
    assert expanded.column_names() == full.column_names()
    np.testing.assert_allclose(expanded.matrix(), full.matrix(), rtol=1e-12, atol=1e-9)
    rred = rb.store.fd_reduction(CAT2)
    rreduced = R.cat_cofactors_factorized(rb.store, rb.vorder, ["x", "y"], rred.kept)
    np.testing.assert_allclose(
        expanded.matrix(), RF.expand_cat_cofactors(rreduced, rred).matrix(),
        rtol=1e-12, atol=1e-12,
    )
    assert P.expand_cat_cofactors(full, pb.store.fd_reduction(["c0"])) is full
    with pytest.raises(ValueError):
        P.expand_cat_cofactors(full, red)


def test_recover_and_penalty_blocks_match_reference():
    rng = np.random.default_rng(3)
    m = rng.integers(0, 3, 5).astype(np.int64)
    kw = dict(order=["f", "g"], kept=["f"], dropped={"g": ("f", m)},
              domains={"f": 5, "g": 3})
    red, rred = PF.FDReduction(**kw), RF.FDReduction(**kw)
    gamma = rng.normal(size=5)
    got, want = PF.recover_blocks({"f": gamma}, red), RF.recover_blocks({"f": gamma}, rred)
    for a in ("f", "g"):
        np.testing.assert_array_equal(got[a], want[a])
    r = np.zeros((3, 5))
    r[m, np.arange(5)] = 1.0
    np.testing.assert_allclose(got["f"] + r.T @ got["g"], gamma, atol=1e-12)
    np.testing.assert_array_equal(PF.penalty_blocks(red)["f"], RF.penalty_blocks(rred)["f"])
    layout = [("f", 1, 5)]
    np.testing.assert_array_equal(
        PF.apply_penalty_blocks(np.eye(7), red, layout, 0.5),
        RF.apply_penalty_blocks(np.eye(7), rred, layout, 0.5),
    )


def _break_dim0(store, dep_domain):
    old = store.get("Dim0")
    keys = {
        "c0": np.concatenate([old.keys["c0"], old.keys["c0"][:1]]),
        "d0": np.concatenate(
            [old.keys["d0"], (old.keys["d0"][:1] + 1) % dep_domain]
        ).astype(np.int32),
    }
    return Relation.from_columns(
        "Dim0", keys, {"w0": np.zeros(old.num_rows + 1)}, dict(old.domains)
    )


def test_put_reverifies_fds_and_snapshots_keep_theirs(bundles):
    store = bundles[0].store
    snap = store.snapshot()
    store.put(_break_dim0(store, 4))
    assert ("c0", "d0") not in _fd_map(store)
    assert ("c0", "d0") in {(f.lhs, f.rhs) for f in snap.fds()}
    assert set(snap.fd_reduction(CAT2).dropped) == {"d0", "d1"}
    assert set(store.fd_reduction(CAT2).dropped) == {"d1"}
    store2 = PS.fd_star_schema(n_cat=1, domain=6, dep_domain=3, n_rows=40, seed=2).store
    store2.add_fd("c0", "d0")
    rows = store2.get("Dim0").num_rows
    with pytest.raises(ValueError, match="declared FD"):
        store2.put(_break_dim0(store2, 3))
    assert store2.get("Dim0").num_rows == rows  # rolled back


def test_fd_reduced_kernel_leg_predicts_as_full(bundles):
    """The materialized leg with the float32 grouped-Gram kernel (its plain
    version on the CPU): FD-reduced and full solves predict alike on every
    join row, and both stay close to the float64 solve."""
    pb, _ = bundles
    joined = pb.store.materialize_join()
    doms = {c: pb.store.attr_domain(c) for c in CAT2}
    x, _ = P.onehot_design_matrix(joined, ["x"], CAT2, doms)
    z = np.concatenate([np.ones((x.shape[0], 1)), x], axis=1)
    exact = P.linear_regression(pb.store, pb.vorder, FEATS2, "y",
                                _closed(P, factorized=False))
    want = z @ exact.theta[:-1]
    for fds in (True, False):
        res = P.linear_regression(
            pb.store, pb.vorder, FEATS2, "y",
            _closed(P, factorized=False, use_kernel=True, use_fds=fds),
        )
        assert res.names == exact.names
        np.testing.assert_allclose(z @ res.theta[:-1], want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
        assert res.theta[1] == pytest.approx(exact.theta[1], rel=1e-5)
