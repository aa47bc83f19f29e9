"""Logical-axis sharding policy (MaxText-style), on DTensor (PyTorch port
of the JAX package's ``sharding.py``, the same rules and tables).

Model code never names mesh axes.  It annotates tensors with *logical* axes
(``batch``, ``seq``, ``heads``, ``ffn``, ...) via :func:`constrain`, and
parameter leaves get logical axes from their *path* (``wq`` -> (fsdp, heads,
head_dim)).  A :class:`ShardingPolicy` maps logical axes onto mesh axes and
is installed as a context; with no active policy every annotation is a no-op,
so the same model definition serves single-device CPU tests and a sharded
train step unchanged.

Resolution rules (applied per tensor), as the reference's:

* a logical axis maps to one mesh axis or a tuple of mesh axes;
* mesh axes missing from the active mesh are dropped (single-pod vs
  multi-pod reuse one rule set);
* a mesh axis may appear **once** per spec — later logical axes that want
  an already-used mesh axis fall back to replication (MoE: expert wins
  ``model``, ffn falls back; dense: ffn takes ``model``);
* a dimension not divisible by its mesh-axis product falls back to
  replication (MQA's kv_heads=1, qwen2-moe's 60 experts on a 16-way axis);
* trailing ``None`` entries are trimmed.

Resolution reads only the mesh's axis names and sizes: a
``torch.distributed`` ``DeviceMesh`` (``mesh_dim_names`` and ``shape``)
or any stand-in whose ``shape`` maps axis names to sizes (the tests
resolve 256- and 512-chip meshes that way).  On a real ``DeviceMesh`` a
spec becomes DTensor placements, one per mesh dim: ``Shard(d)`` on every
mesh dim that tensor dim ``d`` is split over (a tuple of axes, such as
``batch`` over ``("pod", "data")``, shards one dim over several mesh dims,
the major axis first, as in JAX), ``Replicate()`` elsewhere.
:func:`constrain` redistributes a DTensor to its resolved placements (the
counterpart of ``with_sharding_constraint``) and leaves a plain tensor
alone: inside ``compat.local_map`` the tensors are each rank's shards.
:func:`on_head_shards` runs attention (the flash kernels, the dense
softmax) on each rank's batch and head shards that way.

Two built-in rule sets: ``TRAIN_RULES`` (batch-DP + FSDP over ``data``, TP
over ``model``) and ``SERVE_RULES`` (weights replicated over ``data``, TP
over ``model``, KV-cache sequence sharded over ``model`` — SP decode).
"""

from __future__ import annotations

import functools
import re
import threading
from contextlib import contextmanager
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import torch

__all__ = [
    "AxisRules",
    "BATCH_AXES",
    "CACHE_AXES",
    "NamedSharding",
    "PARAM_AXES",
    "PartitionSpec",
    "SERVE_RULES",
    "ShardingPolicy",
    "TRAIN_RULES",
    "active_policy",
    "batch_specs",
    "cache_specs",
    "constrain",
    "constrain_tree",
    "distribute_tree",
    "full_tensor",
    "is_dtensor",
    "logical_spec",
    "mesh_axes",
    "on_head_shards",
    "on_rows",
    "param_specs",
    "pinned",
    "state_specs",
    "sum_grad",
    "sum_over",
    "tree_logical_specs",
    "use_policy",
]

MeshAxes = Union[None, str, Tuple[str, ...]]

#: logical axis -> mesh axes.  ``fsdp`` is the *parameter* embed/width dim
#: (sharded over data for ZeRO-3); activation ``embed`` stays replicated.
TRAIN_RULES: Dict[str, MeshAxes] = {
    "batch": ("pod", "data"),
    "seq": None,
    # the saved (block-boundary) activations' sequence dim: mapping this to
    # "model" is Megatron-style sequence parallelism; off in the baseline
    "act_seq": None,
    "embed": None,
    "fsdp": "data",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "ffn": "model",
    "expert": "model",
    "vocab": "model",
    "kv_seq": None,
    "state": None,
    "moe_cap": "data",  # MoE dispatch-buffer capacity dim (EP layout)
}

SERVE_RULES: Dict[str, MeshAxes] = {
    "batch": ("pod", "data"),
    "seq": None,
    "act_seq": None,
    "embed": None,
    "fsdp": None,  # serving keeps full weight replicas per data shard
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "ffn": "model",
    "expert": "model",
    "vocab": "model",
    "kv_seq": "model",  # SP: decode cache sequence dim over model
    "state": "model",  # SSM / mLSTM state inner dim
    "moe_cap": "data",
}


class PartitionSpec(tuple):
    """One entry per tensor dim: None (replicated), a mesh axis name, or a
    tuple of names (split over several axes, major first); trailing Nones
    trimmed.  Compares as the tuple of its entries."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def mesh_axes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or of a stand-in whose
    ``shape`` is that mapping."""
    shape = mesh.shape
    if isinstance(shape, Mapping):
        return dict(shape)
    return dict(zip(mesh.mesh_dim_names, shape))


class AxisRules:
    """Immutable logical->mesh axis mapping with override support."""

    def __init__(self, rules: Dict[str, MeshAxes]) -> None:
        self._rules = dict(rules)

    def get(self, logical: Optional[str]) -> Tuple[str, ...]:
        if logical is None:
            return ()
        axes = self._rules.get(logical, None)
        if axes is None:
            return ()
        if isinstance(axes, str):
            return (axes,)
        return tuple(axes)

    def override(self, **updates: MeshAxes) -> "AxisRules":
        merged = dict(self._rules)
        merged.update(updates)
        return AxisRules(merged)

    def items(self):
        return self._rules.items()


class NamedSharding:
    """A resolved spec on its mesh (the reference's ``NamedSharding``):
    ``spec`` and, on a real ``DeviceMesh``, DTensor ``placements``."""

    def __init__(self, mesh, spec: PartitionSpec) -> None:
        self.mesh, self.spec = mesh, spec

    @property
    def placements(self) -> tuple:
        from torch.distributed.tensor import Replicate, Shard

        names = list(mesh_axes(self.mesh))
        out = [Replicate()] * len(names)
        for dim, entry in enumerate(self.spec):
            axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
            if [names.index(a) for a in axes] != sorted(names.index(a) for a in axes):
                raise NotImplementedError(
                    f"spec {self.spec}: dim {dim} splits over {axes} in another "
                    f"order than the mesh's {tuple(names)}")
            for a in axes:
                out[names.index(a)] = Shard(dim)
        return tuple(out)

    def distribute(self, x: torch.Tensor):
        """``x`` (the same full tensor on every rank) as a DTensor with these
        placements."""
        from torch.distributed.tensor import distribute_tensor

        return distribute_tensor(x, self.mesh, self.placements)

    def __repr__(self) -> str:
        return f"NamedSharding({self.spec!r})"


class ShardingPolicy:
    """Binds an :class:`AxisRules` to a concrete mesh."""

    def __init__(self, mesh, rules: Union[AxisRules, Dict[str, MeshAxes]]):
        self.mesh = mesh
        self.rules = rules if isinstance(rules, AxisRules) else AxisRules(rules)

    def spec(
        self, logical: Sequence[Optional[str]], shape: Optional[Sequence[int]] = None
    ) -> PartitionSpec:
        """Resolve logical axes to a PartitionSpec (see module doc rules)."""
        sizes = mesh_axes(self.mesh)
        used: set = set()
        out = []
        for i, name in enumerate(logical):
            axes = [a for a in self.rules.get(name) if a in sizes and a not in used]
            if shape is not None and axes:
                nshards = 1
                for a in axes:
                    nshards *= sizes[a]
                if shape[i] % nshards != 0:
                    axes = []
            if not axes:
                out.append(None)
            else:
                used.update(axes)
                out.append(tuple(axes) if len(axes) > 1 else axes[0])
        while out and out[-1] is None:
            out.pop()
        return PartitionSpec(*out)

    def sharding(
        self, logical: Sequence[Optional[str]], shape: Optional[Sequence[int]] = None
    ) -> NamedSharding:
        return NamedSharding(self.mesh, self.spec(logical, shape))

    def constrain(self, x, logical: Sequence[Optional[str]]):
        """``x`` redistributed to its resolved placements if it is a
        DTensor (and its gradient too, on the way back); a plain tensor (a
        local shard) as it is."""
        if not is_dtensor(x):
            return x
        return pinned(x, self.sharding(logical, x.shape).placements)


def pinned(x, placements):
    """The DTensor ``x`` at ``placements``, and its gradient at the same
    placements on the way back: the transpose of a sharding constraint is
    the same constraint, as ``with_sharding_constraint``'s is.  Without
    it, DTensor leaves a cotangent as its producer left it (a sum over a
    vocab shard stays a partial sum through the residual stream), and the
    next product's backward gathers its weight to meet it."""
    placements = tuple(placements)
    if tuple(x.placements) != placements:
        x = x.redistribute(x.device_mesh, placements)
    if x.requires_grad:
        x = x.view_as(x)  # the pin holds for this use alone
        x.register_hook(functools.partial(_grad_at, placements=placements))
    return x


def _grad_at(g, placements):
    return g if tuple(g.placements) == placements else g.redistribute(g.device_mesh, placements)


_STATE = threading.local()


def active_policy() -> Optional[ShardingPolicy]:
    return getattr(_STATE, "policy", None)


@contextmanager
def use_policy(policy: Optional[ShardingPolicy]):
    prev = active_policy()
    _STATE.policy = policy
    try:
        yield policy
    finally:
        _STATE.policy = prev


def constrain(x, logical: Sequence[Optional[str]]):
    """Annotate ``x`` with logical axes; no-op without an active policy."""
    pol = active_policy()
    if pol is None:
        return x
    return pol.constrain(x, logical)


def constrain_tree(tree, table: Dict):
    """Each DTensor leaf of ``tree`` (a ``_tree`` tree) redistributed to
    the placements its path's logical axes (``table``: ``CACHE_AXES``,
    ``BATCH_AXES``) resolve to under the active policy; other leaves as
    they are.  No-op without an active policy."""
    pol = active_policy()
    if pol is None:
        return tree
    from .train._tree import tree_paths, tree_unflatten

    return tree_unflatten(tree, [
        pol.constrain(leaf, _leaf_logical(path, leaf.dim(), table)) if is_dtensor(leaf)
        else leaf for path, leaf in tree_paths(tree)])


def logical_spec(logical: Sequence[Optional[str]], shape=None) -> PartitionSpec:
    """Resolve under the active policy (PartitionSpec() when none active)."""
    pol = active_policy()
    if pol is None:
        return PartitionSpec()
    return pol.spec(logical, shape)


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (never where ``torch.distributed`` is not
    built)."""
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def full_tensor(x):
    """A DTensor's full tensor (a collective: every rank calls it), any
    other value as it is."""
    return x.full_tensor() if is_dtensor(x) else x


def on_head_shards(fn, q, k, v, *rows):
    """``fn(q, k, v, *rows)`` on each rank's local shards of attention
    DTensors ``q [B, Sq, H, D]`` and ``k``, ``v [B, Sk, KH, D]``
    (``compat.local_map``), where all three are split alike over batch
    (dim 0) and heads (dim 2) alone; on any other mesh dim (a sequence
    split, a partial sum, unlike placements) they are replicated first.
    ``rows`` (``[B, ...]`` plain tensors or DTensors, the same on every
    rank) are split over batch as q is.  The output is placed as q."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from .compat import local_map

    if not all(is_dtensor(t) for t in (q, k, v)):
        raise ValueError("attention on shards: q, k and v must all be DTensors")
    mesh = q.device_mesh
    placements = []
    for dim in range(mesh.ndim):
        p = q.placements[dim]
        alike = all(t.placements[dim] == p for t in (k, v))
        local = p.is_replicate() or (type(p) is Shard and p.dim in (0, 2))
        placements.append(p if alike and local else Replicate())
    placements = tuple(placements)
    row_placements = tuple(p if type(p) is Shard and p.dim == 0 else Replicate()
                           for p in placements)
    q, k, v = (t.redistribute(mesh, placements) for t in (q, k, v))
    rows = [r.redistribute(mesh, row_placements) if is_dtensor(r)
            else distribute_tensor(r, mesh, row_placements) for r in rows]
    return local_map(
        fn, out_placements=list(placements),
        in_placements=(placements,) * 3 + (row_placements,) * len(rows),
        device_mesh=mesh,
    )(q, k, v, *rows)


class _SumGrad(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over ``groups``: a
    whole (replicated) input of a function run on each rank's own shard
    gets a gradient from each rank's part, and its gradient is their sum
    (Megatron's copy into the model-parallel region)."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        for g in ctx.groups:
            torch.distributed.all_reduce(grad, group=g)
        return grad, None


class _SumOver(torch.autograd.Function):
    """The transpose of :class:`_SumGrad`: the forward sums over ``groups``,
    whose ranks hold partial terms of one replicated value; the gradient of
    each rank's term is the value's gradient itself (Megatron's reduction
    into the model-parallel region)."""

    @staticmethod
    def forward(ctx, x, groups):
        x = x.clone()
        for g in groups:
            torch.distributed.all_reduce(x, group=g)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def sum_over(x: torch.Tensor, groups) -> torch.Tensor:
    """``x`` (a local tensor, each rank's partial term) summed over the
    process groups ``groups`` into the value every rank then holds, its
    gradient passed to each term as it is (:class:`_SumOver`)."""
    return _SumOver.apply(x, tuple(groups)) if groups else x


def sum_grad(x: torch.Tensor, groups) -> torch.Tensor:
    """``x`` (a local tensor, whole on every rank of the process groups
    ``groups``, read for each rank's own part of the work) with its
    gradient summed over ``groups`` (:class:`_SumGrad`); as it is where
    nothing records a gradient."""
    if not groups or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _SumGrad.apply(x, tuple(groups))


def on_rows(fn, *args, outputs: int = 1, whole=()):
    """``fn(*args)`` with DTensor ``args`` on each rank's own batch rows
    (``compat.local_map``): every argument and each of the ``outputs``
    tensors ``fn`` returns (a tuple when more than one) split over the mesh
    dims that split ``args[0]``'s dim 0 and whole on the others; the
    arguments at the indices in ``whole`` whole everywhere.  For a
    recurrence's loop, whose ops then run on local tensors rather than as
    DTensor ops a step.  Plain arguments: ``fn(*args)``."""
    if not is_dtensor(args[0]):
        return fn(*args)
    from torch.distributed.tensor import Replicate, Shard

    from .compat import local_map

    mesh = args[0].device_mesh
    rows = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                 for p in args[0].placements)
    full = (Replicate(),) * len(rows)
    ins = tuple(full if i in whole else rows for i in range(len(args)))
    # a whole argument's gradient is the sum of the row shards' parts
    split = [mesh.get_group(i) for i, p in enumerate(rows) if isinstance(p, Shard)]

    def local(*xs):
        return fn(*(sum_grad(x, split) if i in whole else x for i, x in enumerate(xs)))

    # local_map takes a list for one output, a tuple of them for several
    outs = (rows,) * outputs if outputs > 1 else list(rows)
    return local_map(local, out_placements=outs, in_placements=ins,
                     device_mesh=mesh, redistribute_inputs=True)(*args)


# ---------------------------------------------------------------------------
# Leaf-path -> logical axes (parameters, optimizer state, caches, batches)
# ---------------------------------------------------------------------------

#: parameter leaf name -> logical axes of its (unstacked) shape.
PARAM_AXES: Dict[str, Tuple[Optional[str], ...]] = {
    # embeddings / heads
    "embed": ("vocab", "fsdp"),
    "lm_head": ("fsdp", "vocab"),
    "pos_embed": (None, "fsdp"),
    "mm_proj": ("fsdp", None),
    # attention
    "wq": ("fsdp", "heads", "head_dim"),
    "wk": ("fsdp", "kv_heads", "head_dim"),
    "wv": ("fsdp", "kv_heads", "head_dim"),
    "wo": ("heads", "head_dim", "fsdp"),
    # dense MLP (also MoE shared experts)
    "w_gate": ("fsdp", "ffn"),
    "w_up": ("fsdp", "ffn"),
    "w_down": ("ffn", "fsdp"),
    # MoE
    "router": ("fsdp", None),
    "we_gate": ("expert", "fsdp", "ffn"),
    "we_up": ("expert", "fsdp", "ffn"),
    "we_down": ("expert", "ffn", "fsdp"),
    # mamba (di = expanded inner dim -> "ffn" logical axis)
    "in_proj": ("fsdp", "ffn"),
    "conv_w": ("ffn", None),
    "conv_b": ("ffn",),
    "x_proj": ("ffn", None),
    "dt_proj": (None, "ffn"),
    "dt_bias": ("ffn",),
    "A_log": ("ffn", "state"),
    "D": ("ffn",),
    "out_proj": ("ffn", "fsdp"),
    # xLSTM
    "w_z": ("fsdp", "ffn"),
    "w_gates": ("ffn", None),
    "w_in": ("fsdp", "ffn"),
    "w_out": ("fsdp", None),
    "r": ("heads", "head_dim", None),
    # norms / small vectors: replicated
    "scale": (),
    "bias": (),
    "gate_bias": (),
    "h_scale": (),
}

#: decode-cache leaf name -> logical axes.
CACHE_AXES: Dict[str, Tuple[Optional[str], ...]] = {
    "k": ("batch", "kv_seq", "kv_heads", "head_dim"),
    "v": ("batch", "kv_seq", "kv_heads", "head_dim"),
    "pos": ("batch", "kv_seq"),
    "conv": ("batch", None, "ffn"),
    "h": ("batch", "ffn", "state"),
    "S": ("batch", "heads", None, "state"),
    "n": ("batch", "heads", "state"),
    "c": ("batch", "heads", "state"),
}

#: batch-input leaf name -> logical axes.
BATCH_AXES: Dict[str, Tuple[Optional[str], ...]] = {
    "tokens": ("batch", "seq"),
    "labels": ("batch", "seq"),
    "frames": ("batch", "seq", "embed"),
    "patches": ("batch", "seq", "embed"),
    "token": ("batch", None),
    "cur_pos": (),
}

_FACTORED_SUFFIX = {"vr": -1, "vc": -2}  # adafactor factored stats
_PIECE = re.compile(r"\['([^']*)'\]|\[(\d+)\]|\.(\w+)")


def _path_names(path) -> list:
    """The names along a leaf's path: a ``_tree`` path string
    (``.params['periods']['b0']['mixer']['wq']``) or a sequence of names."""
    if isinstance(path, str):
        return [next(g for g in m.groups() if g is not None) for m in _PIECE.finditer(path)]
    return [str(p) for p in path]


def _leaf_logical(path, ndim: int, table: Dict) -> Tuple[Optional[str], ...]:
    """Resolve a leaf's logical axes from its path.

    Handles: stacked leading axes (periods/layers -> extra None dims),
    optimizer-state wrappers (mu/nu/v mirror the param), and adafactor's
    factored vr/vc (parent's axes minus the reduced dim).
    """
    names = _path_names(path)
    if not names:
        return (None,) * ndim
    last = names[-1]
    drop = None
    if last in _FACTORED_SUFFIX and len(names) >= 2 and names[-2] in table:
        drop = _FACTORED_SUFFIX[last]
        last = names[-2]
    elif last == "v" and len(names) >= 2 and names[-2] in table:
        # adafactor unfactored stat wraps the param name
        last = names[-2]
    logical = table.get(last)
    if logical is None:
        return (None,) * ndim
    logical = tuple(logical)
    if drop is not None:
        idx = len(logical) + drop
        logical = logical[:idx] + logical[idx + 1 :]
    # stacked (periods / encoder layers / microbatch) leading dims
    while len(logical) < ndim:
        logical = (None,) + logical
    if len(logical) > ndim:  # defensive: over-specified -> replicate
        return (None,) * ndim
    return logical


def tree_logical_specs(tree, policy: ShardingPolicy, table: Dict):
    """:class:`NamedSharding` tree for ``tree`` under ``policy`` via path
    rules (a ``_tree`` tree: dicts, lists, dataclasses, leaves)."""
    from .train._tree import tree_paths, tree_unflatten  # train imports models

    out = []
    for path, leaf in tree_paths(tree):
        shape = tuple(getattr(leaf, "shape", ()))
        out.append(policy.sharding(_leaf_logical(path, len(shape), table), shape))
    return tree_unflatten(tree, out)


def param_specs(params, policy: ShardingPolicy):
    return tree_logical_specs(params, policy, PARAM_AXES)


def state_specs(state, policy: ShardingPolicy):
    """Specs for a TrainState (params + optimizer state + step + err)."""
    return tree_logical_specs(state, policy, PARAM_AXES)


def cache_specs(cache, policy: ShardingPolicy):
    return tree_logical_specs(cache, policy, CACHE_AXES)


def batch_specs(batch, policy: ShardingPolicy):
    return tree_logical_specs(batch, policy, BATCH_AXES)


def distribute_tree(tree, specs):
    """Each tensor leaf of ``tree`` (the same full tensor on every rank) as
    a DTensor placed by its :class:`NamedSharding` in ``specs`` (the tree
    of :func:`tree_logical_specs`); scalars (a state's step count) and
    other leaves as they are, the same on every rank."""
    from .train._tree import tree_paths, tree_unflatten

    leaves = [leaf for _, leaf in tree_paths(tree)]
    shards = [s for _, s in tree_paths(specs)]
    return tree_unflatten(tree, [
        s.distribute(x) if isinstance(x, torch.Tensor) and x.dim() else x
        for x, s in zip(leaves, shards)
    ])
