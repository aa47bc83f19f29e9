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

LM weights cross as the reference's parameter tree of float32 numpy arrays
(nested dicts, block leaves stacked over periods); ``params_from_jax``
loads one into this package's :class:`~repro_torch.models.model.Transformer`.
A training state crosses as the reference's ``TrainState`` with numpy
leaves; ``state_from_jax`` makes this package's (whose parameters keep the
reference's tree).
"""

from __future__ import annotations

from typing import List, Mapping, Sequence

import numpy as np
import torch

from .core.relation import Relation
from .core.store import Store
from .core.variable_order import VariableOrder
from .models.model import Transformer, resolve_device, tree_path
from .train._tree import tree_map
from .train.train_step import TrainState

__all__ = [
    "params_from_jax",
    "state_from_jax",
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


def params_from_jax(tree: Mapping, cfg, device="cuda") -> Transformer:
    """A :class:`Transformer` for ``cfg`` on ``device`` holding the weights
    of the reference's parameter tree ``tree`` (float32 numpy arrays, as
    ``jax.tree.map(np.asarray, params)`` gives them).

    Layouts are the reference's (``wq [d, H, hd]``, ``wk`` / ``wv [d, KH,
    hd]``, ``wo [H, hd, d]``, ``w_gate`` / ``w_up [d, ff]``, ``w_down
    [ff, d]``, ``embed [pv, d]``; MoE ``router [d, E]``, ``we_gate`` /
    ``we_up [E, d, ff]``, ``we_down [E, ff, d]``, ``shared.*``; the Mamba,
    mLSTM and sLSTM leaves of ``models/mamba.py`` and ``models/xlstm.py``);
    layer ``i`` reads period ``i // len(pattern)`` of block ``b{i %
    len(pattern)}``.  Each leaf takes its parameter's dtype: matrices
    ``cfg.param_dtype``; norm scales, biases, the router, conv weights,
    gates and recurrences float32, as in both packages."""
    model = Transformer(cfg, device=resolve_device(device))
    with torch.no_grad():
        for name, param in model.named_parameters():
            path, period = tree_path(name, cfg)
            leaf = tree
            for key in path:
                leaf = leaf[key]
            arr = np.array(leaf if period is None else leaf[period], dtype=np.float32)
            if arr.shape != tuple(param.shape):
                raise ValueError(
                    f"{name}: tree leaf {arr.shape} != parameter {tuple(param.shape)}"
                )
            param.copy_(torch.from_numpy(arr))
    return model


def state_from_jax(state, cfg, device="cuda"):
    """This package's :class:`~repro_torch.train.TrainState` on ``device``
    from the reference's ``TrainState`` with numpy leaves (as
    ``jax.tree.map(np.asarray, state)`` gives it; any object with
    ``params``, ``opt_state``, ``step`` and ``err``): the same trees, the
    parameters cast to ``cfg.param_dtype``, optimizer and compression state
    float32, the step an int32 scalar."""
    dev = resolve_device(device)

    def put(dtype):
        return lambda a: torch.from_numpy(np.array(a, dtype=np.float32)).to(dev, dtype)

    err = None if state.err is None else tree_map(put(torch.float32), state.err)
    return TrainState(
        params=tree_map(put(cfg.param_dtype), state.params),
        opt_state=tree_map(put(torch.float32), state.opt_state),
        step=torch.tensor(int(np.asarray(state.step)), dtype=torch.int32, device=dev),
        err=err,
    )
