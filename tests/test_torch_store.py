"""PyTorch port, store read surface: append-only encodings, domains,
moments, the materialized natural join, snapshots and the traversal
counters, held against the JAX package's ``Store`` on the same relations.

All of it is host numpy, so the contract is exact: identical id arrays and
dictionaries (first-seen order), identical moments, a row-identical join.
"""

import numpy as np
import pytest

import repro.data.synthetic as RS
from repro.core.factorize import FactorizedEngine as RFactorizedEngine
from repro.core.relation import Relation as RRelation
from repro_torch.convert import (
    store_from_numpy,
    store_to_numpy,
    vorder_from_tree,
    vorder_to_tree,
)
from repro_torch.core import (
    FactorizedEngine,
    Relation,
    Store,
    StoreReads,
    StoreSnapshot,
)
from repro_torch.data import favorita_like, figure1_schema

BUNDLES = [
    ("figure1", lambda m: m.figure1_schema()),
    ("favorita", lambda m: m.favorita_like(n_dates=8, n_stores=4, n_items=6, seed=3)),
    ("acyclic", lambda m: m.random_acyclic_schema(7)),
]


def _pair(make):
    import repro_torch.data.synthetic as PS

    return make(PS), make(RS)


@pytest.mark.parametrize("name,make", BUNDLES)
def test_encodings_match_reference(name, make):
    pb, rb = _pair(make)
    for rel in rb.store.relations():
        for attr in rel.attributes:
            got = pb.store.attr_encoding(rel.name, attr)
            want = rb.store.attr_encoding(rel.name, attr)
            assert got.dtype == want.dtype == np.int32
            np.testing.assert_array_equal(got, want)
    for rel in rb.store.relations():
        for attr in rel.attributes:
            np.testing.assert_array_equal(
                pb.store.attr_values_array(attr), rb.store.attr_values_array(attr)
            )


@pytest.mark.parametrize("name,make", BUNDLES)
def test_catalog_and_moments_match_reference(name, make):
    pb, rb = _pair(make)
    assert pb.store.names() == rb.store.names()
    assert pb.store.total_rows() == rb.store.total_rows()
    attrs = {a for r in rb.store.relations() for a in r.attributes}
    for attr in sorted(attrs):
        assert pb.store.column_moments(attr) == rb.store.column_moments(attr)
        keyed = [r for r in rb.store.relations() if attr in r.domains]
        if keyed:
            assert pb.store.attr_domain(attr) == rb.store.attr_domain(attr)
        else:
            with pytest.raises(ValueError):
                pb.store.attr_domain(attr)
    with pytest.raises(ValueError):
        pb.store.column_moments("nope")


@pytest.mark.parametrize("name,make", BUNDLES)
def test_materialize_join_row_identical(name, make):
    pb, rb = _pair(make)
    got, want = pb.store.materialize_join(), rb.store.materialize_join()
    assert got.name == want.name and got.attributes == want.attributes
    assert got.domains == want.domains
    np.testing.assert_array_equal(got.rows(), want.rows())
    sub = rb.store.names()[:2]
    np.testing.assert_array_equal(
        pb.store.materialize_join(sub).rows(), rb.store.materialize_join(sub).rows()
    )


def test_materialize_cross_product_matches_reference():
    rels = [
        dict(name="A", keys={"a": np.array([0, 1])}, values={"x": np.array([1.0, 2.0])},
             domains={"a": 2}),
        dict(name="B", keys={"b": np.array([0, 1, 2])},
             values={"y": np.array([3.0, 4.0, 5.0])}, domains={"b": 3}),
    ]
    from repro.core.store import Store as RStore

    ref = RStore([RRelation(r["name"], dict(r["keys"]), dict(r["values"]),
                            dict(r["domains"])) for r in rels])
    np.testing.assert_array_equal(
        store_from_numpy(rels).materialize_join().rows(),
        ref.materialize_join().rows(),
    )
    with pytest.raises(ValueError):
        Store().materialize_join()


def test_snapshot_is_frozen_across_put():
    b = figure1_schema()
    store = b.store
    snap = store.snapshot()
    assert isinstance(snap, StoreSnapshot) and snap.snapshot() is snap
    assert isinstance(store, StoreReads) and isinstance(snap, StoreReads)
    before = snap.get("Sales").rows().copy()
    ids_before = snap.attr_encoding("Sales", "Sale").copy()
    mom_before = snap.column_moments("Sale")
    new = Relation.from_columns("Sales", {"P": [0, 1]}, {"Sale": [100.0, 200.0]},
                                {"P": 12})
    store.put(new)
    assert not snap.is_current and store.version == snap.version + 1
    np.testing.assert_array_equal(snap.get("Sales").rows(), before)
    np.testing.assert_array_equal(snap.attr_encoding("Sales", "Sale"), ids_before)
    assert snap.column_moments("Sale") == mom_before
    assert store.column_moments("Sale")[2] != mom_before[2]
    # append-only dictionary: old values keep their ids, new ones extend
    ids = store.attr_encoding("Sales", "Sale")
    vals = store.attr_values_array("Sale")
    np.testing.assert_array_equal(vals[ids], [100.0, 200.0])
    assert ids.min() >= len(np.unique(before[:, 1]))
    assert snap.total_rows() - store.total_rows() == before.shape[0] - 2


def test_snapshot_reads_match_store():
    b = favorita_like(n_dates=6, n_stores=3, n_items=4, seed=1)
    snap = b.store.snapshot()
    assert snap.names() == b.store.names() and "SalesF" in snap
    assert snap.total_rows() == b.store.total_rows()
    assert snap.attr_domain("date") == b.store.attr_domain("date")
    np.testing.assert_array_equal(
        snap.materialize_join().rows(), b.store.materialize_join().rows()
    )
    np.testing.assert_array_equal(
        snap.attr_encoding("Oil", "date"), b.store.attr_encoding("Oil", "date")
    )


@pytest.mark.parametrize("name,make", BUNDLES)
def test_traversal_counters_match_reference(name, make):
    """passes / node_visits land on the store (through the engine's
    snapshot) exactly as in the reference with its view cache off."""
    pb, rb = _pair(make)
    cols = pb.features + [pb.label]
    for _ in range(2):
        FactorizedEngine(pb.store, pb.vorder, cols, device="cpu").cofactors()
        RFactorizedEngine(
            rb.store, rb.vorder, cols, backend="numpy", use_view_cache=False
        ).cofactors()
    assert pb.store.passes == rb.store.passes == 2
    assert pb.store.node_visits == rb.store.node_visits > 0
    pb.store.reset_counters()
    assert pb.store.passes == pb.store.node_visits == 0


def test_converted_store_serves_same_engine_results():
    rb = RS.favorita_like(n_dates=8, n_stores=4, n_items=6, seed=3)
    store = store_from_numpy(store_to_numpy(rb.store))
    vorder = vorder_from_tree(vorder_to_tree(rb.vorder))
    cols = rb.features + [rb.label]
    got = FactorizedEngine(store, vorder, cols, backend="numpy").cofactors()
    want = RFactorizedEngine(rb.store, rb.vorder, cols, backend="numpy",
                             use_view_cache=False).cofactors()
    np.testing.assert_allclose(got.matrix(), want.matrix(), rtol=1e-12, atol=0)
