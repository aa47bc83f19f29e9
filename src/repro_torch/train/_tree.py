"""Parameter trees: the nested containers the training substrate maps over.

A tree is a ``dict`` (keys visited in sorted order, as JAX flattens them),
a ``list`` / ``tuple``, a dataclass instance (fields in declared order, as
a registered JAX dataclass), ``None`` (no leaves), or a leaf (a tensor, an
array or a number).  Paths print as ``jax.tree_util.keystr`` prints them
(``.params['periods']['b0']['mixer']['wq']``), so a checkpoint names its
leaves as the reference's does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Tuple

__all__ = ["flatten_up_to", "tree_leaves", "tree_map", "tree_paths", "tree_unflatten"]


def _children(tree) -> List[Tuple[str, Any]]:
    """(path piece, child) of a container, or None for a leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", c) for i, c in enumerate(tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f".{f.name}", getattr(tree, f.name)) for f in dataclasses.fields(tree)]
    return None


def _rebuild(tree, children: list):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return dict(zip(sorted(tree), children))
    if isinstance(tree, (list, tuple)):
        return type(tree)(children)
    names = [f.name for f in dataclasses.fields(tree)]
    return dataclasses.replace(tree, **dict(zip(names, children)))


def flatten_up_to(like, tree) -> list:
    """The subtrees of ``tree`` at the leaves of ``like`` (JAX's
    ``flatten_up_to``), in flattening order."""
    kids = _children(like)
    if kids is None:
        return [tree]
    out = []
    for (_, c), (_, t) in zip(kids, _children(tree)):
        out.extend(flatten_up_to(c, t))
    return out


def tree_unflatten(like, leaves):
    """``like``'s structure with ``leaves`` in flattening order."""
    it = iter(leaves)

    def build(node):
        kids = _children(node)
        if kids is None:
            return next(it)
        return _rebuild(node, [build(c) for _, c in kids])

    return build(like)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree``; each of ``rest`` is walked in
    step up to ``tree``'s structure, so at a leaf of ``tree`` ``fn`` gets
    the matching subtree of each."""
    flat = [tree_leaves(tree)] + [flatten_up_to(tree, r) for r in rest]
    return tree_unflatten(tree, [fn(*args) for args in zip(*flat)])


def tree_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``[(path, leaf)]`` in flattening order."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for piece, child in kids:
        out.extend(tree_paths(child, prefix + piece))
    return out


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_paths(tree)]
