"""PyTorch port, host substrate: relations, key packing, joins, variable
orders, the synthetic generators and the plain-structure converters, held
against the JAX package on the same numpy-seeded inputs.

Everything here is integer or float64 host work, so the contract is exact
equality (arrays, dtypes, signatures); the one float32 tensor op,
``segment_sum_torch``, matches ``segment_sum_jnp`` at float32 rounding.
"""

import ast
from pathlib import Path

import numpy as np
import pytest

import repro.core.relation as R
import repro.core.variable_order as RVO
import repro.data.synthetic as RS
import repro_torch.core.relation as P
import repro_torch.core.variable_order as PVO
import repro_torch.data.synthetic as PS
from repro.core.store import Store as RStore
from repro_torch.convert import (
    store_from_numpy,
    store_to_numpy,
    vorder_from_tree,
    vorder_to_tree,
)
from repro_torch.core.store import Store as PStore

PORT = Path(__file__).resolve().parent.parent / "src" / "repro_torch"


def test_port_imports_neither_jax_nor_repro():
    """No module of the port, and not ``chip_smoke.py`` (which drives it on
    the card), imports jax or the JAX package."""
    bad = []
    smoke = PORT.parent.parent / "chip_smoke.py"
    assert smoke.exists()
    for path in sorted(PORT.rglob("*.py")) + [smoke]:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                    bad.append(f"{path.relative_to(smoke.parent)}: {name}")
    assert not bad, bad
    assert len(list(PORT.rglob("*.py"))) >= 15


def _cols(rng, n, doms):
    return [rng.integers(0, d, n).astype(np.int32) for d in doms]


@pytest.mark.parametrize("doms", [[5], [3, 7], [4, 1, 9], [2**20, 2**20, 2**20, 9]])
def test_key_packing_matches_reference(doms):
    rng = np.random.default_rng(len(doms))
    cols = _cols(rng, 200, doms)
    assert P.radix_fits(doms) == R.radix_fits(doms)
    if R.radix_fits(doms):
        np.testing.assert_array_equal(
            P.composite_key(cols, doms), R.composite_key(cols, doms)
        )
    got, want = P.group_key(cols, doms), R.group_key(cols, doms)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)


def test_group_key_densifies_past_radix_limit_like_reference():
    rng = np.random.default_rng(5)
    doms = [2**40, 2**40, 2**40]
    cols = [rng.integers(0, 50, 300).astype(np.int64) for _ in doms]
    assert not P.radix_fits(doms)
    with pytest.raises(OverflowError):
        P.composite_key(cols, doms)
    np.testing.assert_array_equal(P.group_key(cols, doms), R.group_key(cols, doms))


@pytest.mark.parametrize("doms", [[6], [4, 5], [2**31, 2**31, 2**31]])
def test_join_keys_and_merge_join_match_reference(doms):
    rng = np.random.default_rng(11)
    left, right = _cols(rng, 40, [min(d, 6) for d in doms]), _cols(
        rng, 55, [min(d, 6) for d in doms]
    )
    pk, rk = P.join_keys(left, right, doms), R.join_keys(left, right, doms)
    for a, b in zip(pk, rk):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(P.sort_merge_join(*pk), R.sort_merge_join(*rk)):
        assert a.dtype == b.dtype == np.int64
        np.testing.assert_array_equal(a, b)
    for a, b in zip(P.hash_join_keys(left, right), R.hash_join_keys(left, right)):
        np.testing.assert_array_equal(a, b)


def test_sort_merge_join_empty_matches_reference():
    a = np.array([1, 2], dtype=np.int64)
    b = np.array([5, 6], dtype=np.int64)
    for x, y in zip(P.sort_merge_join(a, b), R.sort_merge_join(a, b)):
        assert x.shape == y.shape == (0,) and x.dtype == y.dtype


def test_group_ids_and_segment_sums_match_reference():
    import torch

    rng = np.random.default_rng(3)
    key = rng.integers(0, 17, 300).astype(np.int64)
    for a, b in zip(P.group_ids(key), R.group_ids(key)):
        np.testing.assert_array_equal(a, b)
    _, seg, g = P.group_ids(key)
    data = rng.standard_normal((300, 3))
    np.testing.assert_array_equal(
        P.segment_sum_np(data, seg, g), R.segment_sum_np(data, seg, g)
    )
    data32 = data.astype(np.float32)
    got = P.segment_sum_torch(torch.from_numpy(data32), seg, g)
    assert got.dtype == torch.float32 and got.shape == (g, 3)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(R.segment_sum_jnp(data32, seg, g)),
        rtol=1e-5, atol=1e-5,
    )


def test_relation_methods_match_reference():
    kw = dict(
        name="A",
        key_cols={"k": [0, 2, 1, 2]},
        value_cols={"v": [1.5, -2.0, 3.0, 0.25]},
    )
    p, r = P.Relation.from_columns(**kw), R.Relation.from_columns(**kw)
    assert p.domains == r.domains == {"k": 3}
    assert p.attributes == r.attributes and p.num_rows == r.num_rows
    np.testing.assert_array_equal(p.rows(), r.rows())
    idx = np.array([3, 0])
    np.testing.assert_array_equal(p.select(idx).rows(), r.select(idx).rows())
    np.testing.assert_array_equal(p.concat(p).rows(), r.concat(r).rows())
    np.testing.assert_array_equal(
        p.with_value("w", np.ones(4)).rows(), r.with_value("w", np.ones(4)).rows()
    )
    with pytest.raises(ValueError):
        P.Relation("bad", {"k": np.zeros(2, np.int32)}, {"v": np.zeros(3)}, {})
    d_p, d_r = P.Dictionary(["b", "a", "c", "a"]), R.Dictionary(["b", "a", "c", "a"])
    np.testing.assert_array_equal(d_p.encode(["c", "a"]), d_r.encode(["c", "a"]))
    assert d_p.decode([0, 2]) == d_r.decode([0, 2]) and len(d_p) == len(d_r)


# -- generators: bit-identical relations for equal arguments -------------------

def _assert_bundles_equal(pb, rb):
    assert pb.features == rb.features and pb.label == rb.label
    assert pb.vorder.signature() == rb.vorder.signature()
    assert pb.store.names() == rb.store.names()
    for name in rb.store.names():
        p, r = pb.store.get(name), rb.store.get(name)
        assert list(p.keys) == list(r.keys) and list(p.values) == list(r.values)
        assert p.domains == r.domains
        for a in r.attributes:
            assert p.column(a).dtype == r.column(a).dtype
            np.testing.assert_array_equal(p.column(a), r.column(a))


GENERATORS = [
    ("figure1_schema", {}),
    ("figure1_schema", dict(n_locations=6, n_products_per_loc=2, seed=4)),
    ("favorita_like", dict(n_dates=8, n_stores=4, n_items=6, seed=3)),
    ("favorita_like", dict(n_dates=12, n_stores=5, n_items=6, seed=7)),
    ("favorita_like", dict(n_dates=30, n_stores=7, n_items=11,
                           sales_fraction=0.05, seed=0)),
]


@pytest.mark.parametrize("name,kw", GENERATORS)
def test_generators_bit_identical(name, kw):
    _assert_bundles_equal(getattr(PS, name)(**kw), getattr(RS, name)(**kw))


@pytest.mark.parametrize("seed", [0, 1, 2, 7, 13, 42])
def test_random_acyclic_schema_bit_identical(seed):
    kw = dict(n_branches=2 + seed % 2, max_fanout=4, max_rows=12)
    _assert_bundles_equal(
        PS.random_acyclic_schema(seed, **kw), RS.random_acyclic_schema(seed, **kw)
    )


# -- variable orders -------------------------------------------------------------

def test_variable_order_helpers_match_reference():
    pb, rb = PS.figure1_schema(), RS.figure1_schema()
    assert pb.vorder.variables() == rb.vorder.variables()
    assert pb.vorder.relations() == rb.vorder.relations()
    assert pb.vorder.pretty() == rb.vorder.pretty()
    assert [n.name for n in pb.vorder.find_leaves()] == [
        n.name for n in rb.vorder.find_leaves()
    ]
    auto_p = PVO.variable_order_from_store(pb.store)
    auto_r = RVO.variable_order_from_store(rb.store)
    assert auto_p.signature() == auto_r.signature()
    order = ["L", "P", "Inventory", "Competitor", "Sale"]
    assert (
        PVO.variable_order_from_store(pb.store, order).signature()
        == RVO.variable_order_from_store(rb.store, order).signature()
    )
    with pytest.raises(ValueError):
        PVO.variable_order_from_store(pb.store, ["L"])


@pytest.mark.parametrize("case", ["root", "path", "leaf", "unknown"])
def test_validate_rejects_what_reference_rejects(case):
    pb, rb = PS.figure1_schema(), RS.figure1_schema()

    def bad(mod):
        V = mod.VariableOrder
        if case == "root":
            return V("L", [V.leaf("Competition")])
        if case == "path":  # Inventory's attributes are not on this path
            return V.intercept([V("Inventory", [V.leaf("Inventory")])])
        if case == "leaf":
            return V.intercept([V("L", [V("C")])])
        return V.intercept([V("L", [V.leaf("Nope")])])

    with pytest.raises((ValueError, KeyError)) as rerr:
        RVO.validate(bad(RVO), rb.store)
    with pytest.raises(rerr.type):
        PVO.validate(bad(PVO), pb.store)


# -- converters --------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3])
def test_convert_round_trips_reference_state(seed):
    rb = RS.random_acyclic_schema(seed)
    store = store_from_numpy(store_to_numpy(rb.store))
    vorder = vorder_from_tree(vorder_to_tree(rb.vorder))
    assert isinstance(store, PStore)
    assert vorder.signature() == rb.vorder.signature()
    PVO.validate(vorder, store)
    for r in rb.store.relations():
        p = store.get(r.name)
        assert p.domains == r.domains
        for a in r.attributes:
            np.testing.assert_array_equal(p.column(a), r.column(a))
    # and back into the reference's classes
    back = RStore(
        [R.Relation(d["name"], d["keys"], d["values"], d["domains"])
         for d in store_to_numpy(store)]
    )
    assert back.names() == rb.store.names()
