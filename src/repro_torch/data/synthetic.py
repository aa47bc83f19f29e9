"""Synthetic relational datasets mirroring the paper's evaluation.

* ``figure1_schema``       — the paper's running example (Fig. 1):
                             Sales(P, S), Inventory(L, P, I), Competition(L, C).
* ``favorita_like``        — a schema-faithful stand-in for the Kaggle
                             Favorita set (Fig. 8): a sales fact table joined
                             with items / stores / transactions / oil
                             dimensions; label ``unit_sales`` derived from
                             ``date, store_nbr, item_nbr, onpromotion`` plus
                             noise.
* ``many_cat_schema``      — a star of dictionary-encoded categorical keys
                             (the |cat| sweep axis of the categorical path).
* ``fd_star_schema``       — ``many_cat_schema`` with planted functional
                             dependencies ``c_i → d_i``.
* ``random_acyclic_schema``— randomized star/snowflake schemas for property
                             tests.

Every generator draws from a numpy ``default_rng(seed)`` in the same order
as the JAX package's ``repro.data.synthetic``, so the same arguments give
bit-identical relations in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from ..core.relation import Relation
from ..core.store import Store
from ..core.variable_order import VariableOrder, variable_order_from_store

__all__ = [
    "figure1_schema",
    "favorita_like",
    "fd_star_schema",
    "many_cat_schema",
    "random_acyclic_schema",
    "SchemaBundle",
]


@dataclasses.dataclass
class SchemaBundle:
    """A store + hand-crafted variable order + learning roles."""

    store: Store
    vorder: VariableOrder
    features: List[str]
    label: str


# ---------------------------------------------------------------------------
# Paper Figure 1: Sales(P, S), Inventory(L, P, I), Competition(L, C)
# ---------------------------------------------------------------------------

def figure1_schema(
    n_locations: int = 4,
    n_products_per_loc: int = 3,
    n_sales_per_product: int = 3,
    n_competitors_per_loc: int = 2,
    seed: int = 0,
) -> SchemaBundle:
    """The paper's running example, scaled by the given fan-outs.

    Variable order (paper Fig. 1c / Fig. 6):  T → L → {C, P → {S, I}}
    with Competition under C, Sales under S, Inventory under I.
    Features: Inventory, Competitor; Sale is the label.
    """
    rng = np.random.default_rng(seed)
    locs = np.arange(n_locations, dtype=np.int32)

    # Inventory(L, P, I): each location stocks its own products
    inv_l, inv_p, inv_i = [], [], []
    pid = 0
    for l in locs:
        for _ in range(n_products_per_loc):
            inv_l.append(int(l))
            inv_p.append(pid)
            inv_i.append(float(rng.integers(1, 50)))
            pid += 1
    # Sales(P, S)
    sal_p, sal_s = [], []
    for p in range(pid):
        for _ in range(n_sales_per_product):
            sal_p.append(p)
            sal_s.append(float(rng.normal(10.0, 3.0)))
    # Competition(L, C)
    com_l, com_c = [], []
    for l in locs:
        for _ in range(n_competitors_per_loc):
            com_l.append(int(l))
            com_c.append(float(rng.integers(1, 10)))

    store = Store(
        [
            Relation.from_columns(
                "Sales", {"P": sal_p}, {"Sale": sal_s}, {"P": pid}
            ),
            Relation.from_columns(
                "Inventory",
                {"L": inv_l, "P": inv_p},
                {"Inventory": inv_i},
                {"L": n_locations, "P": pid},
            ),
            Relation.from_columns(
                "Competition",
                {"L": com_l},
                {"Competitor": com_c},
                {"L": n_locations},
            ),
        ]
    )

    s = VariableOrder("Sale", [VariableOrder.leaf("Sales")])
    i = VariableOrder("Inventory", [VariableOrder.leaf("Inventory")])
    p = VariableOrder("P", [s, i])
    c = VariableOrder("Competitor", [VariableOrder.leaf("Competition")])
    l = VariableOrder("L", [c, p])
    root = VariableOrder.intercept([l])
    return SchemaBundle(
        store=store,
        vorder=root,
        features=["Inventory", "Competitor"],
        label="Sale",
    )


# ---------------------------------------------------------------------------
# Favorita-like star schema (paper Fig. 8 / §5)
# ---------------------------------------------------------------------------

def favorita_like(
    n_dates: int = 64,
    n_stores: int = 16,
    n_items: int = 32,
    sales_fraction: float = 0.5,
    seed: int = 0,
) -> SchemaBundle:
    """Sales(date, store_nbr, item_nbr, unit_sales, onpromotion) joined with
    Transactions(date, store_nbr, transactions), Oil(date, dcoilwtico),
    Items(item_nbr, perishable), Stores(store_nbr, cluster).

    The label unit_sales is a linear function of date, the store's cluster,
    the item's perishable flag and onpromotion, plus noise.  The fact table
    holds ``sales_fraction`` of all (date, store, item) triples.
    """
    rng = np.random.default_rng(seed)
    dates = np.arange(n_dates, dtype=np.int32)
    stores_ids = np.arange(n_stores, dtype=np.int32)
    items_ids = np.arange(n_items, dtype=np.int32)

    # dimensions
    cluster = rng.integers(1, 6, size=n_stores).astype(np.float64)
    perishable = rng.integers(0, 2, size=n_items).astype(np.float64)
    dcoil = np.cumsum(rng.normal(0, 1, size=n_dates)) + 50.0
    # one scalar draw per (date, store), in that order — the reference's
    # stream; a vectorized draw would consume the generator differently
    trans = np.array(
        [float(rng.integers(500, 3000)) for _ in range(n_dates * n_stores)]
    )
    trans_date = np.repeat(dates, n_stores)
    trans_store = np.tile(stores_ids, n_dates)

    # fact table: a random subset of (date, store, item)
    total = n_dates * n_stores * n_items
    n_sales = max(1, int(total * sales_fraction))
    flat = rng.choice(total, size=n_sales, replace=False)
    f_date = (flat // (n_stores * n_items)).astype(np.int32)
    rem = flat % (n_stores * n_items)
    f_store = (rem // n_items).astype(np.int32)
    f_item = (rem % n_items).astype(np.int32)
    onpromo = rng.integers(0, 2, size=n_sales).astype(np.float64)
    unit_sales = (
        5.0
        + 0.05 * f_date
        + 2.0 * cluster[f_store]
        + 3.0 * perishable[f_item]
        + 4.0 * onpromo
        + rng.normal(0, 1.0, size=n_sales)
    )

    store = Store(
        [
            Relation.from_columns(
                "SalesF",
                {"date": f_date, "store_nbr": f_store, "item_nbr": f_item},
                {"unit_sales": unit_sales, "onpromotion": onpromo},
                {"date": n_dates, "store_nbr": n_stores, "item_nbr": n_items},
            ),
            Relation.from_columns(
                "Transactions",
                {"date": trans_date, "store_nbr": trans_store},
                {"transactions": trans},
                {"date": n_dates, "store_nbr": n_stores},
            ),
            Relation.from_columns(
                "Oil", {"date": dates}, {"dcoilwtico": dcoil}, {"date": n_dates}
            ),
            Relation.from_columns(
                "Items",
                {"item_nbr": items_ids},
                {"perishable": perishable},
                {"item_nbr": n_items},
            ),
            Relation.from_columns(
                "Stores",
                {"store_nbr": stores_ids},
                {"cluster": cluster},
                {"store_nbr": n_stores},
            ),
        ]
    )

    # Variable order (Fig. 8 style): date at the root; store_nbr and item_nbr
    # below; numeric attributes at the bottom of their relation's path.
    oil = VariableOrder("dcoilwtico", [VariableOrder.leaf("Oil")])
    transv = VariableOrder("transactions", [VariableOrder.leaf("Transactions")])
    clus = VariableOrder("cluster", [VariableOrder.leaf("Stores")])
    peri = VariableOrder("perishable", [VariableOrder.leaf("Items")])
    promo = VariableOrder("onpromotion", [VariableOrder.leaf("SalesF")])
    usales = VariableOrder("unit_sales", [promo])
    item = VariableOrder("item_nbr", [peri, usales])
    storev = VariableOrder("store_nbr", [clus, transv, item])
    date = VariableOrder("date", [oil, storev])
    root = VariableOrder.intercept([date])

    # Paper §5: "unit_sales ... is derived from the features date, store_nbr,
    # item_nbr and onpromotion" — ids enter as numeric features.
    return SchemaBundle(
        store=store,
        vorder=root,
        features=["date", "store_nbr", "item_nbr", "onpromotion"],
        label="unit_sales",
    )


# ---------------------------------------------------------------------------
# Many-categorical star schema (the |cat| sweep axis)
# ---------------------------------------------------------------------------

def many_cat_schema(
    n_cat: int = 4,
    domain: int = 16,
    n_rows: int = 2000,
    seed: int = 0,
) -> SchemaBundle:
    """Fact(c0..c{n-1}, x, y) ⋈ Dim_i(c_i, w_i) for i < n_cat.

    Every c_i is a dictionary-encoded key with ``domain`` categories and
    its own dimension relation, so a categorical cofactor batch over all
    of them issues 1 + n_cat + C(n_cat, 2) aggregate outputs — the regime
    where the fused single-pass plan's shared traversal beats the
    per-attribute/per-pair passes quadratically.  The label ``y`` depends
    on a per-category effect of every attribute plus ``x`` and noise, so
    the swept models stay learnable.
    """
    rng = np.random.default_rng(seed)
    keys = {
        f"c{i}": rng.integers(0, domain, n_rows).astype(np.int32)
        for i in range(n_cat)
    }
    effects = [rng.normal(0, 1.0, domain) for _ in range(n_cat)]
    x = rng.normal(0, 2.0, n_rows)
    y = 0.5 * x + rng.normal(0, 0.5, n_rows)
    for i in range(n_cat):
        y = y + effects[i][keys[f"c{i}"]]
    rels = [
        Relation.from_columns(
            "Fact",
            keys,
            {"x": x, "y": y},
            {f"c{i}": domain for i in range(n_cat)},
        )
    ]
    for i in range(n_cat):
        rels.append(
            Relation.from_columns(
                f"Dim{i}",
                {f"c{i}": np.arange(domain, dtype=np.int32)},
                {f"w{i}": rng.normal(0, 1.0, domain)},
                {f"c{i}": domain},
            )
        )
    store = Store(rels)
    return SchemaBundle(
        store=store,
        vorder=variable_order_from_store(store),
        features=["x"],
        label="y",
    )


# ---------------------------------------------------------------------------
# Star schema with planted functional dependencies
# ---------------------------------------------------------------------------

def fd_star_schema(
    n_cat: int = 2,
    domain: int = 16,
    dep_domain: int = 4,
    n_rows: int = 2000,
    seed: int = 0,
) -> SchemaBundle:
    """``many_cat_schema`` with planted FDs: Fact(c0..c{n-1}, x, y, promo)
    ⋈ Dim_i(c_i, d_i, w_i), where each dimension carries a *determined* key
    attribute ``d_i = map_i[c_i]`` with a strictly smaller domain — the
    ``store_nbr → cluster`` pattern of the Favorita schema, expressed as a
    dictionary-encoded key so it can enter the model as a categorical
    feature.  ``Store.infer_fds()`` discovers every ``c_i → d_i`` (each
    Dim_i witnesses it), and the FD-reduced solve over
    ``cat = [c_0..c_{n-1}, d_0..d_{n-1}]`` drops all ``d_i`` blocks.

    The label ``y`` carries a per-category effect of every c_i AND every
    d_i (so the dropped blocks genuinely matter to the model), ``promo``
    is a Bernoulli label driven by the same effects for the GLM leg.
    """
    rng = np.random.default_rng(seed)
    keys = {
        f"c{i}": rng.integers(0, domain, n_rows).astype(np.int32)
        for i in range(n_cat)
    }
    maps = [
        rng.integers(0, dep_domain, domain).astype(np.int64)
        for _ in range(n_cat)
    ]
    c_eff = [rng.normal(0, 1.0, domain) for _ in range(n_cat)]
    d_eff = [rng.normal(0, 1.0, dep_domain) for _ in range(n_cat)]
    x = rng.normal(0, 2.0, n_rows)
    eta = 0.5 * x
    for i in range(n_cat):
        ids = keys[f"c{i}"]
        eta = eta + c_eff[i][ids] + d_eff[i][maps[i][ids]]
    y = eta + rng.normal(0, 0.5, n_rows)
    promo = rng.binomial(1, 1.0 / (1.0 + np.exp(-0.5 * eta))).astype(
        np.float64
    )
    rels = [
        Relation.from_columns(
            "Fact",
            keys,
            {"x": x, "y": y, "promo": promo},
            {f"c{i}": domain for i in range(n_cat)},
        )
    ]
    for i in range(n_cat):
        rels.append(
            Relation.from_columns(
                f"Dim{i}",
                {
                    f"c{i}": np.arange(domain, dtype=np.int32),
                    f"d{i}": maps[i].astype(np.int32),
                },
                {f"w{i}": rng.normal(0, 1.0, domain)},
                {f"c{i}": domain, f"d{i}": dep_domain},
            )
        )
    store = Store(rels)
    return SchemaBundle(
        store=store,
        vorder=variable_order_from_store(store),
        features=["x"],
        label="y",
    )


# ---------------------------------------------------------------------------
# Random acyclic schemas for property testing
# ---------------------------------------------------------------------------

def random_acyclic_schema(
    seed: int,
    n_branches: int = 2,
    max_fanout: int = 4,
    max_rows: int = 12,
) -> SchemaBundle:
    """A random snowflake: root key k0; branch b has relation
    R_b(k0, k_b, x_b) and child relation C_b(k_b, y_b).  Acyclic by
    construction; the hand-built variable order nests k_b under k0."""
    rng = np.random.default_rng(seed)
    n_k0 = int(rng.integers(1, max_fanout + 1))
    rels: List[Relation] = []
    branch_nodes: List[VariableOrder] = []
    features: List[str] = []
    for b in range(n_branches):
        n_kb = int(rng.integers(1, max_fanout + 1))
        rows = int(rng.integers(1, max_rows + 1))
        r_k0 = rng.integers(0, n_k0, size=rows).astype(np.int32)
        r_kb = rng.integers(0, n_kb, size=rows).astype(np.int32)
        r_x = rng.normal(0, 2, size=rows)
        rels.append(
            Relation.from_columns(
                f"R{b}",
                {"k0": r_k0, f"k{b + 1}": r_kb},
                {f"x{b}": r_x},
                {"k0": n_k0, f"k{b + 1}": n_kb},
            )
        )
        crows = int(rng.integers(1, max_rows + 1))
        c_kb = rng.integers(0, n_kb, size=crows).astype(np.int32)
        c_y = rng.normal(0, 2, size=crows)
        rels.append(
            Relation.from_columns(
                f"C{b}",
                {f"k{b + 1}": c_kb},
                {f"y{b}": c_y},
                {f"k{b + 1}": n_kb},
            )
        )
        y_node = VariableOrder(f"y{b}", [VariableOrder.leaf(f"C{b}")])
        x_node = VariableOrder(f"x{b}", [VariableOrder.leaf(f"R{b}")])
        kb_node = VariableOrder(f"k{b + 1}", [x_node, y_node])
        branch_nodes.append(kb_node)
        features.extend([f"x{b}", f"y{b}"])
    k0_node = VariableOrder("k0", branch_nodes)
    root = VariableOrder.intercept([k0_node])
    label = features[-1]
    return SchemaBundle(
        store=Store(rels),
        vorder=root,
        features=features[:-1],
        label=label,
    )
