"""Multi-pod dry run: build and count every (arch × shape) cell (PyTorch
port of the JAX package's ``launch/dryrun.py``).

Run it as its own process (``python -m repro_torch.launch.dryrun``): each
cell brings up a **fake** process group of 256 (512 multi-pod) ranks in
this process (``torch.testing``'s ``FakeStore``: every collective returns
at once, nothing is sent), builds ``make_production_mesh``'s mesh on it,
and runs the cell's program once as rank 0 on ``meta`` tensors — the
parameters, optimizer state, batches and caches of ``abstract_params`` /
``abstract_state`` / ``input_specs`` / ``init_cache``, placed as DTensors
by ``sharding.*_specs`` under the kind's policy and ``PROD_OVERRIDES``.
Nothing ever allocates: a meta tensor has a shape and no memory.  The
group is destroyed when the cell ends, so it never meets another group;
a process with a group already up is refused.

The three programs of the reference's ``_build_cell``: the train step
(``make_train_step``, microbatches and all), prefill, and one decode step
against a ``seq_len`` cache (at its last position).  One
``TorchDispatchMode`` (:class:`StepCounter`) sees every rank-local op — it
defers each DTensor op, so the DTensor dispatches its local ops with the
mode still on — and records, per device, what XLA's compiled artifact gave
the reference:

* **FLOPs**: ``torch.utils.flop_counter``'s formulas on each local
  matmul-like op (as executed: DTensor's redistributions and any
  replicated work included; what DTensor's sharding propagation runs on
  global shapes, ``roofline.skip_dispatch``, never).  Eager counting sees every loop iteration, so
  the reference's two-point depth variants and inner-scan corrections —
  work-arounds for XLA counting a while body once — do not exist here.
  ``cost_pass`` adds the same program on one device with no mesh
  (``flops_unsharded``: the program's own FLOPs).
* **bytes accessed**: each non-view op's input and output bytes (eager,
  unfused: every op reads its inputs and writes its outputs).
* **collective bytes**: ``launch.roofline.CollectiveBytes``' rule, result
  bytes of each local collective by kind.
* **memory**: torch has no compiler memory analysis.  Arguments are the
  local shards of the state and the batch (or parameters, cache and
  token); the mode tracks every storage made in the step while it lives
  (a weak reference on each), and the peak of their bytes, outputs
  included, is ``output + temp``.  No allocator rounding, no workspace
  outside torch, and no XLA-CPU upcast correction (the reference's
  ``_upcast_bytes``): ``temp_adjusted_bytes`` is ``temp_size_in_bytes``.
* On meta tensors ``kernels/ops.py`` takes the plain versions: attention
  over 2,048 tokens is counted as ``ref.flash_attention_ref`` and
  ``ref.flash_backward_ref`` compute it (the dense ``S × S`` scores in
  float32, every masked score too), not as the card's kernels do.

``calibrate`` measures whether the counted FLOPs are global or per-shard
(a known matmul on one device and sharded over ``data``), and each record
carries the result as ``flops_scope``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
import weakref
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch.utils.flop_counter import flop_registry

from repro_torch import compat
from repro_torch import sharding as shd
from repro_torch.configs import ARCHS, SHAPES, get_config, input_specs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import (
    CollectiveBytes,
    RooflineTerms,
    model_flops,
    skip_dispatch,
    total_collective_bytes,
)
from repro_torch.models import model as model_lib
from repro_torch.train._tree import tree_leaves, tree_paths, tree_unflatten
from repro_torch.train.train_step import TrainHParams, abstract_state, make_train_step

__all__ = ["PROD_OVERRIDES", "StepCounter", "calibrate", "fake_group", "main", "run_cell"]

#: per-cell production policy choices (rule overrides applied on top of the
#: kind's base rules), as the reference's: the largest train cells turn on
#: sequence-parallel activation saving (act_seq -> model).
PROD_OVERRIDES: Dict = {
    ("deepseek-67b", "train_4k"): {"act_seq": "model"},
    # jamba: the reference's hillclimb showed act_seq SP loses to plain
    # microbatching here (boundary gathers outweigh the stored carries).
    ("granite-20b", "train_4k"): {"act_seq": "model"},
    ("mixtral-8x7b", "train_4k"): {"act_seq": "model"},
    ("llava-next-mistral-7b", "train_4k"): {"act_seq": "model"},
}

#: ops that move no bytes of their own (fresh uninitialised buffers).
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided"}

METHOD = {
    "flops": "torch.utils.flop_counter formulas on every rank-local op of one run "
             "of the program (rank 0 of the fake group), DTensor redistributions and "
             "replicated work included; no depth extrapolation (eager counting sees "
             "every iteration)",
    "bytes": "input plus output bytes of every non-view rank-local op (eager, "
             "unfused)",
    "memory": "arguments: the local shards of the inputs; temp: the peak bytes of "
              "live storages made in the step less its outputs (weak references "
              "on meta storages); no allocator rounding, no XLA upcast correction",
    "attention": "kernels/ops.py takes its plain versions on meta tensors: attention "
                 "over 2,048 tokens is counted as ref.flash_attention_ref / "
                 "flash_backward_ref compute it (dense S x S float32 scores)",
}


#: the mesh name of a one-device record (``single_rank``, ``--mesh host``)
SINGLE_RANK = "host1"


def _mesh_name(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "pod16x16"


@contextlib.contextmanager
def fake_group(world: int):
    """A fake process group of ``world`` ranks, this process rank 0, for the
    duration of the block (destroyed on exit)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry run brings up its own fake process group: run it "
                           "in a process with no group up")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


class StepCounter(CollectiveBytes):
    """FLOPs, bytes accessed, collective bytes and live-storage peak of the
    rank-local ops run while on (see the module doc).  ``arguments``:
    tensors (DTensors: their local shards) whose storages exist before the
    step and are not counted as made in it."""

    def __init__(self, arguments=()) -> None:
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._made: Dict[int, int] = {}
        self._args = {id(_local(t).untyped_storage()) for t in arguments}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        defer, shadow = skip_dispatch(types)
        if defer:
            return NotImplemented
        if shadow:
            return func(*args, **kwargs)
        packet = func._overloadpacket
        if packet not in flop_registry and _composite(func):
            # a composite op the mode sees whole (inference mode keeps
            # ``matmul``): count its parts, as FlopCounterMode does
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs, out_val=out))
        self.add(func, args, out)
        outs = _flat(out)
        if not func.is_view and packet.__name__ not in _NO_TRAFFIC:
            self.bytes += (_nbytes(_flat(args)) + _nbytes(_flat(list(kwargs.values())))
                           + _nbytes(outs))
        for t in outs:
            self._track(t)
        return out

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._args or key in self._made:
            return
        n = st.nbytes()
        self._made[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._made.pop(key)

    def made_bytes(self, tensors) -> int:
        """Bytes of the distinct storages of ``tensors`` made in the step."""
        keys = {id(_local(t).untyped_storage()) for t in tensors}
        return sum(self._made.get(k, 0) for k in keys)


def _local(t: torch.Tensor) -> torch.Tensor:
    return t._local_tensor if shd.is_dtensor(t) else t


def _tensors(tree) -> list:
    """The tensor leaves of ``tree`` (dicts, lists, tuples, dataclasses)."""
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


_COMPOSITE: Dict = {}


def _composite(func) -> bool:
    """Whether ``func`` has a CompositeImplicitAutograd kernel (cached)."""
    if func not in _COMPOSITE:
        _COMPOSITE[func] = torch._C._dispatch_has_kernel_for_dispatch_key(
            func.name(), "CompositeImplicitAutograd")
    return _COMPOSITE[func]


def _flat(values) -> list:
    """The tensors among an op's arguments or results (one level of lists)."""
    if isinstance(values, torch.Tensor):
        return [values]
    out = []
    for v in values if isinstance(values, (list, tuple)) else ():
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, (list, tuple)):
            out.extend(t for t in v if isinstance(t, torch.Tensor))
    return out


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _arg_bytes(tensors) -> int:
    """Bytes of the distinct local storages of ``tensors``."""
    seen = {}
    for t in tensors:
        st = _local(t).untyped_storage()
        seen[id(st)] = st.nbytes()
    return sum(seen.values())


def _policy(mesh, kind: str, overrides: Optional[Dict] = None):
    rules = shd.TRAIN_RULES if kind == "train" else shd.SERVE_RULES
    ar = shd.AxisRules(rules)
    if overrides:
        ar = ar.override(**{k: tuple(v) if isinstance(v, list) else v
                            for k, v in overrides.items()})
    return shd.ShardingPolicy(mesh, ar)


def _place(tree, specs):
    """Each meta tensor leaf of ``tree`` as a DTensor placed by its
    :class:`~repro_torch.sharding.NamedSharding` (local chunks only: no
    collective), other leaves as they are."""
    from torch.distributed.tensor import distribute_tensor

    leaves = [leaf for _, leaf in tree_paths(tree)]
    shards = [s for _, s in tree_paths(specs)]
    return tree_unflatten(tree, [
        distribute_tensor(x, s.mesh, s.placements, src_data_rank=None)
        if isinstance(x, torch.Tensor) and x.dim() else x
        for x, s in zip(leaves, shards)
    ])


def _place_model(params, cfg, policy):
    """The :class:`~repro_torch.models.model.Transformer` ``params`` with
    every parameter a DTensor placed by its leaf's logical axes."""
    from torch import nn
    from torch.distributed.tensor import distribute_tensor

    for name, p in list(params.named_parameters()):
        path, _ = model_lib.tree_path(name, cfg)
        sharding = policy.sharding(shd._leaf_logical(path, p.dim(), shd.PARAM_AXES), p.shape)
        owner = params.get_submodule(name.rpartition(".")[0])
        dt = distribute_tensor(p.detach(), sharding.mesh, sharding.placements,
                               src_data_rank=None)
        setattr(owner, name.rpartition(".")[2], nn.Parameter(dt, requires_grad=False))
    return params


def _build_cell(cfg, shape, policy):
    """Returns (fn, args) for one cell: the program and its inputs (placed
    DTensors under ``policy``; plain meta tensors when it is None)."""
    kind = shape.kind
    place = (lambda tree, specs_fn: tree) if policy is None else (
        lambda tree, specs_fn: _place(tree, specs_fn(tree, policy)))
    if kind == "train":
        hp = TrainHParams()
        state = place(abstract_state(cfg, hp), shd.state_specs)
        batch = place(input_specs(cfg, shape), shd.batch_specs)
        return make_train_step(cfg, hp), (state, batch)

    params = model_lib.abstract_params(cfg)
    if policy is not None:
        params = _place_model(params, cfg, policy)
    if kind == "prefill":
        batch = place(input_specs(cfg, shape), shd.batch_specs)

        def fn(params, batch):
            return model_lib.prefill(params, batch, cfg, shape.seq_len)

        return fn, (params, batch)

    # decode: one new token against a seq_len cache, at its last slot
    cache = place(model_lib.init_cache(cfg, shape.global_batch, shape.seq_len, device="meta"),
                  shd.cache_specs)
    token = place({"token": input_specs(cfg, shape)["token"]}, shd.batch_specs)["token"]

    def fn(params, token, cache):
        return model_lib.decode_step(params, token, cache, shape.seq_len - 1, cfg)

    return fn, (params, token, cache)


def _count(cfg, shape, policy) -> tuple:
    """Build and run one program under :class:`StepCounter`: (counter,
    arguments, output, build seconds, count seconds)."""
    t0 = time.perf_counter()
    # the serving programs run under inference mode, where a DTensor made
    # outside it cannot be viewed: make their inputs inside it
    with torch.inference_mode(shape.kind != "train"):
        fn, args = _build_cell(cfg, shape, policy)
    arguments = []
    for a in args:
        arguments += list(a.parameters()) if isinstance(a, torch.nn.Module) else _tensors(a)
    t1 = time.perf_counter()
    counter = StepCounter(arguments)
    ctx = contextlib.nullcontext() if policy is None else shd.use_policy(policy)
    with ctx, compat.implicit_replication(), counter:
        out = fn(*args)
    t2 = time.perf_counter()
    return counter, arguments, out, t1 - t0, t2 - t1


def run_cell(
    arch: str,
    shape_name: str,
    multi_pod: bool = False,
    overrides: Optional[Dict] = None,
    verbose: bool = True,
    cost_pass: bool = True,
    cfg_overrides: Optional[Dict] = None,
    *,
    single_rank: bool = False,
    global_batch: Optional[int] = None,
    flops_scope: Optional[str] = None,
) -> Dict:
    """Build and count one cell; returns the JSON-able record.

    The production form (microbatches, full depth) runs once on the fake
    mesh; ``cost_pass`` also counts the same program on one device
    (``cost.flops_unsharded``).  ``single_rank`` counts the program on one
    device with no mesh and no group (mesh ``host1``), the form a
    single-card run takes; ``global_batch`` replaces the shape's batch.
    ``flops_scope`` (None: :func:`calibrate` measures it) goes into the
    roofline terms."""
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = SHAPES[shape_name]
    if global_batch:
        shape = dataclasses.replace(shape, global_batch=int(global_batch))
    mesh_name = SINGLE_RANK if single_rank else _mesh_name(multi_pod)
    if shape_name in cfg.skip_shapes:
        return {
            "arch": arch, "shape": shape_name, "mesh": mesh_name,
            "status": "skipped",
            "reason": "full-attention arch; long-context decode excluded "
                      "per assignment (DESIGN.md §Shape-applicability)",
        }
    merged = dict(PROD_OVERRIDES.get((arch, shape_name), {}))
    merged.update(overrides or {})
    chips = 1 if single_rank else (512 if multi_pod else 256)
    rec: Dict = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "chips": chips,
        "kind": shape.kind,
        "global_batch": shape.global_batch,
        "rule_overrides": merged,
        "cfg_overrides": cfg_overrides or {},
        "status": "ok",
        "method": METHOD,
    }
    try:
        group = contextlib.nullcontext() if single_rank else fake_group(chips)
        with group:
            policy = None
            if not single_rank:
                mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
                policy = _policy(mesh, shape.kind, merged or None)
            counter, arguments, out, rec["lower_s"], rec["compile_s"] = _count(
                cfg, shape, policy)
            out_bytes = counter.made_bytes(_tensors(out))
            rec["memory"] = {
                "argument_size_in_bytes": float(_arg_bytes(arguments)),
                "output_size_in_bytes": float(out_bytes),
                "temp_size_in_bytes": float(max(counter.peak - out_bytes, 0)),
                "temp_adjusted_bytes": float(max(counter.peak - out_bytes, 0)),
            }
            rec["memory"]["peak_bytes"] = (rec["memory"]["argument_size_in_bytes"]
                                           + float(counter.peak))
            cost = {"flops": float(counter.flops), "bytes": float(counter.bytes),
                    "coll_by_kind": dict(counter.by_kind)}
            del out, arguments, counter
        if cost_pass:
            if single_rank:
                cost["flops_unsharded"] = cost["flops"]
            else:
                plain, _, _, _, rec["cost_pass_compile_s"] = _count(cfg, shape, None)
                cost["flops_unsharded"] = float(plain.flops)
        rec["cost"] = cost
        if flops_scope is None:
            flops_scope = "per_shard" if single_rank else calibrate()["flops_scope"]
        terms = RooflineTerms(
            arch=cfg.name,
            shape=shape.name,
            mesh=mesh_name,
            chips=chips,
            hlo_flops=cost["flops"],
            hlo_bytes=cost["bytes"],
            coll_bytes=total_collective_bytes(cost["coll_by_kind"]),
            coll_by_kind=cost["coll_by_kind"],
            model_flops=model_flops(cfg, shape),
            per_device_hbm_peak=rec["memory"]["temp_adjusted_bytes"],
            flops_scope=flops_scope,
        )
        rec["roofline"] = terms.to_json()
        if verbose:
            mem_pd = rec["memory"]
            tot_mem = mem_pd["argument_size_in_bytes"] + mem_pd["temp_adjusted_bytes"]
            print(
                f"[dryrun] {arch:24s} {shape_name:12s} {mesh_name:11s} "
                f"build {rec['lower_s']:5.1f}s count {rec['compile_s']:5.1f}s "
                f"flops/dev {terms.flops_per_device:.3e} "
                f"coll {terms.coll_bytes:.3e}B "
                f"mem/dev {tot_mem/1e9:.2f}GB "
                f"bottleneck={terms.bottleneck}"
            )
    except Exception as e:
        rec["status"] = "error"
        rec["error"] = repr(e)
        rec["traceback"] = traceback.format_exc()
        if verbose:
            print(f"[dryrun] {arch} {shape_name} {mesh_name} FAILED: {e!r}")
    return rec


def calibrate() -> Dict:
    """Measure whether :class:`StepCounter`'s FLOPs are global or per-shard:
    a 1,024³ matmul on one device, then with its left operand sharded over
    ``data`` on the 256-rank fake mesh."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    n = 1024
    x = torch.empty((n, n), dtype=torch.float32, device="meta")
    with StepCounter() as c1:
        x @ x
    with fake_group(256):
        mesh = make_production_mesh(device="cpu")
        a = distribute_tensor(x, mesh, [Shard(0), Replicate()], src_data_rank=None)
        b = distribute_tensor(x, mesh, [Replicate(), Replicate()], src_data_rank=None)
        with StepCounter() as c2:
            a @ b
    f1, f2 = float(c1.flops), float(c2.flops)
    return {
        "unsharded_flops": f1,
        "sharded_flops": f2,
        "expected": 2.0 * n**3,
        "flops_scope": "per_shard" if f2 < 0.6 * f1 else "global",
    }


def all_cells():
    for arch in ARCHS:
        for shape in SHAPES.values():
            yield arch, shape.name


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", default=None, help="architecture id (default: all)")
    p.add_argument("--shape", default=None, help="shape name (default: all)")
    p.add_argument("--mesh", choices=["pod1", "pod2", "both", "host"], default="both",
                   help="host: one device, no mesh")
    p.add_argument("--out", default="benchmarks/results/dryrun_torch")
    p.add_argument("--rules", default=None,
                   help="JSON dict of logical-axis rule overrides (hillclimb)")
    p.add_argument("--cfg", default=None,
                   help="JSON dict of ModelConfig field overrides (hillclimb)")
    p.add_argument("--batch", type=int, default=None, help="global batch (default: the shape's)")
    p.add_argument("--tag", default=None, help="suffix for the output file")
    p.add_argument("--calibrate", action="store_true")
    args = p.parse_args(argv)

    if args.calibrate:
        print(json.dumps(calibrate(), indent=2))
        return 0

    overrides = json.loads(args.rules) if args.rules else None
    cfg_overrides = json.loads(args.cfg) if args.cfg else None
    meshes = {"pod1": [False], "pod2": [True], "both": [False, True], "host": [None]}[args.mesh]
    cells = [
        (a, s)
        for a, s in all_cells()
        if (args.arch is None or a == args.arch)
        and (args.shape is None or s == args.shape)
    ]
    os.makedirs(args.out, exist_ok=True)
    scope = calibrate()["flops_scope"] if args.mesh != "host" else "per_shard"
    print(f"[dryrun] counted FLOPs are {scope}")
    failures = 0
    for arch, shape in cells:
        for mp in meshes:
            # the roofline table is single-pod only: the multi-pod pass
            # proves the pod axis shards without the one-device FLOP pass
            rec = run_cell(arch, shape, multi_pod=bool(mp), overrides=overrides,
                           cfg_overrides=cfg_overrides, cost_pass=not mp,
                           single_rank=mp is None, global_batch=args.batch,
                           flops_scope=scope)
            tag = f"_{args.tag}" if args.tag else ""
            fname = f"{arch}_{shape}_{rec['mesh']}{tag}.json"
            with open(os.path.join(args.out, fname), "w") as f:
                json.dump(rec, f, indent=2)
            if rec["status"] == "error":
                failures += 1
    print(f"[dryrun] done; {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
