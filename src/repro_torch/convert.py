"""Carry a catalog and a variable order across as plain structures.

The JAX package and this one keep their own classes, so state crosses
between them as plain Python and numpy:

* a relation is ``{"name": str, "keys": {attr: int array},
  "values": {attr: float array}, "domains": {attr: int}}``;
* a variable-order node is a ``(name, children, relation)`` tuple, with
  ``relation`` ``None`` for attribute nodes and the intercept.

``store_to_numpy`` / ``vorder_to_tree`` read any object with the same
attributes (either package's store and variable order);
``store_from_numpy`` / ``vorder_from_tree`` build this package's.
"""

from __future__ import annotations

from typing import List, Mapping, Sequence

import numpy as np

from .core.relation import Relation
from .core.store import Store
from .core.variable_order import VariableOrder

__all__ = [
    "store_from_numpy",
    "store_to_numpy",
    "vorder_from_tree",
    "vorder_to_tree",
]


def store_to_numpy(store) -> List[dict]:
    """One plain dict per relation of ``store``, in catalog order (arrays
    are shared, not copied)."""
    return [
        {
            "name": rel.name,
            "keys": dict(rel.keys),
            "values": dict(rel.values),
            "domains": dict(rel.domains),
        }
        for rel in store.relations()
    ]


def store_from_numpy(relations: Sequence[Mapping]) -> Store:
    """A :class:`Store` holding one :class:`Relation` per dict, with the
    columns copied as int32 keys and float64 values."""
    return Store(
        [
            Relation(
                name=r["name"],
                keys={
                    a: np.array(c, dtype=np.int32) for a, c in r["keys"].items()
                },
                values={
                    a: np.array(c, dtype=np.float64)
                    for a, c in r["values"].items()
                },
                domains={a: int(d) for a, d in r["domains"].items()},
            )
            for r in relations
        ]
    )


def vorder_to_tree(node) -> tuple:
    """Nested ``(name, children, relation)`` tuples of a variable order."""
    return (node.name, [vorder_to_tree(ch) for ch in node.children], node.relation)


def vorder_from_tree(tree: tuple) -> VariableOrder:
    """A :class:`VariableOrder` from nested ``(name, children, relation)``
    tuples."""
    name, children, relation = tree
    return VariableOrder(
        name, [vorder_from_tree(ch) for ch in children], relation
    )
