"""Variable orders (paper §2.2, §4.1).

A variable order Δ = (T, key) is a rooted forest with one node per query
attribute such that every relation's attributes lie on a single root-to-leaf
path.  The *extended* variable order (paper §4.1) additionally

  (1) attaches each relation R as a leaf below its lowest attribute, and
  (2) adds an intercept node ``T`` as the new root.

The ``key`` function — the ancestor set each subtree depends on — is
*derived* by the engine during evaluation (the union of child view keys)
instead of being user-declared.  The user only designs the tree shape; a
wrong shape is rejected by :func:`validate`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set

from .api import StoreReads

INTERCEPT = "T"

__all__ = ["VariableOrder", "validate", "variable_order_from_store", "INTERCEPT"]


@dataclasses.dataclass
class VariableOrder:
    """One node of an (extended) variable order.

    ``name``      : attribute name, or relation name for relation leaves,
                    or ``T`` for the intercept root.
    ``children``  : child nodes.
    ``relation``  : if set, this node is a relation leaf (paper §4.1 (1)).
    """

    name: str
    children: List["VariableOrder"] = dataclasses.field(default_factory=list)
    relation: Optional[str] = None

    # -- construction helpers -------------------------------------------------
    def add(self, child: "VariableOrder") -> "VariableOrder":
        self.children.append(child)
        return self

    @staticmethod
    def intercept(children: Sequence["VariableOrder"]) -> "VariableOrder":
        return VariableOrder(INTERCEPT, children=list(children))

    @staticmethod
    def leaf(relation_name: str) -> "VariableOrder":
        return VariableOrder(relation_name, relation=relation_name)

    # -- traversal -------------------------------------------------------------
    @property
    def is_relation(self) -> bool:
        return self.relation is not None

    def variables(self) -> List[str]:
        """All attribute nodes (pre-order), excluding relation leaves and T."""
        out = []
        if not self.is_relation and self.name != INTERCEPT:
            out.append(self.name)
        for ch in self.children:
            out.extend(ch.variables())
        return out

    def relations(self) -> List[str]:
        out = []
        if self.is_relation:
            out.append(self.relation)
        for ch in self.children:
            out.extend(ch.relations())
        return out

    def signature(self) -> tuple:
        """Hashable structural identity of this (sub)tree.  Two orders with
        the same shape, names and relation leaves share a signature."""
        return (
            self.name,
            self.relation,
            tuple(ch.signature() for ch in self.children),
        )

    def find_leaves(self) -> List["VariableOrder"]:
        """Paper's ``findLeaves``: all relation-leaf nodes."""
        if self.is_relation:
            return [self]
        out: List["VariableOrder"] = []
        for ch in self.children:
            out.extend(ch.find_leaves())
        return out

    def pretty(self, indent: int = 0) -> str:
        tag = f"[{self.relation}]" if self.is_relation else self.name
        lines = ["  " * indent + tag]
        for ch in self.children:
            lines.append(ch.pretty(indent + 1))
        return "\n".join(lines)


def validate(vorder: VariableOrder, store: StoreReads) -> None:
    """Check the defining property: every relation's attributes lie on the
    root-to-leaf path ending at the relation's leaf node."""
    if vorder.name != INTERCEPT:
        raise ValueError("extended variable order must be rooted at intercept T")

    def walk(node: VariableOrder, path: Set[str]) -> None:
        if node.is_relation:
            rel = store.get(node.relation)
            missing = set(rel.attributes) - path
            if missing:
                raise ValueError(
                    f"relation {node.relation}: attributes {sorted(missing)} "
                    f"not on its root-to-leaf path {sorted(path)}"
                )
            if node.children:
                raise ValueError("relation leaves must not have children")
            return
        new_path = path | ({node.name} if node.name != INTERCEPT else set())
        if not node.children:
            raise ValueError(
                f"variable {node.name} is a leaf but represents no relation "
                "(extended variable orders require relation leaves)"
            )
        for ch in node.children:
            walk(ch, new_path)

    walk(vorder, set())

    for name in set(vorder.relations()):
        if name not in store:
            raise ValueError(f"variable order references unknown relation {name}")


def variable_order_from_store(
    store: StoreReads, order: Optional[Sequence[str]] = None
) -> VariableOrder:
    """Construct a valid extended variable order automatically: a *path*
    order (single root-to-leaf attribute chain), attributes ordered by how
    many relations contain them (most-shared first), each relation attached
    below its lowest attribute."""
    rels = store.relations()
    attr_count: Dict[str, int] = {}
    for rel in rels:
        for a in rel.attributes:
            attr_count[a] = attr_count.get(a, 0) + 1
    if order is None:
        order = sorted(attr_count, key=lambda a: (-attr_count[a], a))
    else:
        missing = set(attr_count) - set(order)
        if missing:
            raise ValueError(f"order misses attributes {sorted(missing)}")

    depth = {a: i for i, a in enumerate(order)}
    nodes = [VariableOrder(a) for a in order]
    for i in range(len(nodes) - 1):
        nodes[i].add(nodes[i + 1])
    for rel in rels:
        lowest = max(rel.attributes, key=lambda a: depth[a])
        nodes[depth[lowest]].add(VariableOrder.leaf(rel.name))
    root = VariableOrder.intercept([nodes[0]] if nodes else [])
    validate(root, store)
    return root
