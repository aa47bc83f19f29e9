"""Multi-process ``torch.distributed`` runs for the port's tests (imported by
basename, as ``torch_serve_twin``).

``spawn(world, cases)`` starts ``world`` CPU processes with
``torch.multiprocessing.spawn``, joins them in one gloo group through a
``FileStore`` (no TCP rendezvous), builds the meshes of ``MESHES`` that fit
``world`` ranks, and runs every case on every mesh in every rank.  Each
rank pickles ``{(case, mesh): result}`` to a file; ``spawn`` returns the
results by rank.  ``spawn_train(world, runs)`` runs ``launch.train`` with
``--mesh`` on each rank of such a group and returns rank 0's losses, grad
norms and final state; ``spawn_pipeline(world, runs)`` runs
``train.pipeline.make_pp_loss_for_mesh`` there and returns rank 0's losses
and full gradients.  The cases build their inputs from numpy seeds
(``case_inputs``), so a test computes its oracle from the same numbers.
Nothing here imports JAX or the JAX package.
"""

from __future__ import annotations

import os
import pickle
import tempfile

import numpy as np

#: mesh name -> (world size, shape, dim names, data axes the cases shard over)
MESHES = {
    "ws2": (2, (2,), ("data",), ("data",)),
    "ws4": (4, (4,), ("data",), ("data",)),
    "ws4_pod_data": (4, (2, 2), ("pod", "data"), ("pod", "data")),
    "ws4_data_only": (4, (2, 2), ("pod", "data"), ("data",)),
}

M_ROWS = 103  # not a multiple of 2 or 4: the last shard is padded
CONT = ["x0", "x1", "x2"]
CAT = ["a", "b", "c"]
DOMAINS = {"a": 5, "b": 7, "c": 3}


def case_inputs(seed: int = 0) -> dict:
    """The numbers every case reads, from a numpy seed."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(M_ROWS, len(CONT))) * 3.0
    ids = np.stack([rng.integers(0, DOMAINS[c], M_ROWS) for c in CAT], axis=1)
    ids[:, 2] = ids[:, 0] % DOMAINS["c"]  # c is a function of a: an FD
    split = 71
    grown = ids[split:].copy()
    grown[0, 1] = DOMAINS["b"] + 2  # unseen ids in the delta grow b's domain
    return dict(x=x, ids=ids, split=split, grown=grown)


def fd_reduction():
    """c = f(a) over ``case_inputs``' ids: keep a and b, drop c."""
    from repro_torch.core.fd import FDReduction

    mapping = np.arange(DOMAINS["a"]) % DOMAINS["c"]
    return FDReduction(order=list(CAT), kept=["a", "b"],
                       dropped={"c": ("a", mapping)}, domains=dict(DOMAINS))


def _run_case(name: str, mesh, axes):
    import torch

    from repro_torch.core import distributed as D
    from repro_torch.train import compression as comp

    inp = case_inputs()
    x, ids, split = inp["x"], inp["ids"], inp["split"]
    if name == "rows":
        return D._local_rows(M_ROWS, mesh, axes)
    if name == "gram":
        lo, hi, per = D._local_rows(M_ROWS, mesh, axes)
        z = torch.from_numpy(D._design_block(x, lo, hi, per))
        return D.sharded_gram(z, mesh, axes).numpy()
    if name == "cofactors":
        return D.sharded_cofactors(x, CONT, mesh, axes)
    if name == "incremental":
        base = D.sharded_cofactors(x[:split], CONT, mesh, axes)
        return D.incremental_sharded_cofactors(base, x[split:], mesh, axes)
    if name == "cat":
        return D.sharded_cat_cofactors(x, ids, CONT, CAT, DOMAINS, mesh, axes)
    if name == "cat_fd":
        return D.sharded_cat_cofactors(x, ids, CONT, CAT, DOMAINS, mesh, axes,
                                       fd=fd_reduction())
    if name == "cat_incremental":
        base = D.sharded_cat_cofactors(x[:split], ids[:split], CONT, CAT, DOMAINS,
                                       mesh, axes)
        return D.incremental_sharded_cat_cofactors(base, x[split:], inp["grown"],
                                                   mesh, axes)
    if name == "compressed_psum":
        rank = torch.distributed.get_rank()
        rng = np.random.default_rng(100 + rank)
        grads = {"w": torch.from_numpy(rng.normal(size=(8, 8)).astype(np.float32)),
                 "b": torch.from_numpy(rng.normal(size=(5,)).astype(np.float32))}
        out, err = comp.compressed_psum(grads, comp.init_error_state(grads), axes, mesh)
        return {k: (grads[k].numpy(), out[k].numpy(), err[k].numpy()) for k in grads}
    raise ValueError(f"unknown case {name}")


def _worker(rank: int, world: int, store_path: str, out_dir: str, cases: list) -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)  # the ranks share the machine's cores

    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        results = {}
        for mesh_name, (size, shape, names, axes) in MESHES.items():
            if size != world:
                continue
            mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
            for case in cases:
                results[(case, mesh_name)] = _run_case(case, mesh, axes)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
    finally:
        dist.destroy_process_group()


def checkpoint_leaves(directory: str, step: int) -> dict:
    """{leaf path: array} of the checkpoint of ``step`` under ``directory``."""
    import json

    path = os.path.join(directory, f"step_{step:06d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    return {e["path"]: np.load(os.path.join(path, e["file"])) for e in manifest["leaves"]}


def train_result(argv: list, read: bool = True) -> dict:
    """``launch.train.run(argv + a checkpoint every step)``: ``(loss,
    grad_norm)`` by step, the final state's full tensors by path and (where
    ``read``: the rank that writes checkpoints) the step-1 checkpoint's
    leaves."""
    from repro_torch.launch import train as launch_train
    from repro_torch.train._tree import tree_paths

    with tempfile.TemporaryDirectory() as d:
        res = launch_train.run(argv + ["--checkpoint-dir", d, "--checkpoint-every", "1"],
                               log=lambda line: None)
        state = {}
        for path, x in tree_paths(res.state):
            state[path] = (x.full_tensor() if hasattr(x, "full_tensor") else x).numpy()
        first = checkpoint_leaves(d, 1) if read else None
    return dict(history=[(h["loss"], h["grad_norm"]) for h in res.history],
                state=state, step1=first)


def _train_worker(rank: int, world: int, store_path: str, out_dir: str, runs: list) -> None:
    """:func:`train_result` of each ``(name, argv)`` of ``runs`` on this rank
    (the argv names ``--mesh``); rank 0 pickles them (checkpoints are rank
    0's too)."""
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)  # the ranks share the machine's cores
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        results = {}
        for name, argv in runs:
            results[name] = train_result(argv, read=rank == 0)
        if rank == 0:
            with open(os.path.join(out_dir, "train.pkl"), "wb") as f:
                pickle.dump(results, f)
    finally:
        dist.destroy_process_group()


def spawn_train(world: int, runs: list) -> dict:
    """Run ``runs`` (``[(name, argv)]``) with ``launch.train`` on ``world``
    gloo processes; rank 0's ``{name: {"history", "state"}}``."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as d:
        mp.spawn(_train_worker, args=(world, os.path.join(d, "store"), d, list(runs)),
                 nprocs=world, join=True)
        with open(os.path.join(d, "train.pkl"), "rb") as f:
            return pickle.load(f)


def spawn(world: int, cases: list) -> list:
    """Run ``cases`` on ``world`` gloo processes; ``[{(case, mesh): result}]``
    by rank."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as d:
        mp.spawn(_worker, args=(world, os.path.join(d, "store"), d, list(cases)),
                 nprocs=world, join=True)
        out = []
        for rank in range(world):
            with open(os.path.join(d, f"rank{rank}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out


def pipeline_result(arch: str, shape: tuple, tree: dict, batch: dict, microbatches: int) -> dict:
    """``train.pipeline.make_pp_loss_for_mesh`` of the smoke config ``arch``
    on a ``("pod", "data")`` mesh of ``shape`` over the group that is up:
    the loss and every gradient's full tensor by path, for the weights of
    the reference-layout numpy ``tree`` and the numpy ``batch``."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import convert
    from repro_torch import sharding as shd
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.train._tree import tree_paths, tree_unflatten
    from repro_torch.train.pipeline import make_pp_loss_for_mesh

    cfg = get_config(arch, smoke=True)
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("pod", "data"))
    params = M.param_tree(convert.params_from_jax(tree, cfg, "cpu"), cfg)
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    fn, (psh, bsh) = make_pp_loss_for_mesh(cfg, mesh, shd.ShardingPolicy(mesh, shd.TRAIN_RULES),
                                           batch, microbatches=microbatches)
    placed = shd.distribute_tree(params, psh)
    leaves = [x.detach().requires_grad_(True) for _, x in tree_paths(placed)]
    loss = fn(tree_unflatten(placed, leaves), shd.distribute_tree(batch, bsh))
    grads = torch.autograd.grad(loss, leaves)
    return dict(loss=float(loss.detach()),
                grads={path: g.full_tensor().numpy() for (path, _), g in
                       zip(tree_paths(placed), grads)})


def _pipeline_worker(rank: int, world: int, store_path: str, out_dir: str, runs: list) -> None:
    """:func:`pipeline_result` of each ``(name, args)`` of ``runs`` whose
    mesh fits ``world`` ranks; rank 0 pickles them."""
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)  # the ranks share the machine's cores
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        results = {name: pipeline_result(*args) for name, args in runs}
        if rank == 0:
            with open(os.path.join(out_dir, "pipeline.pkl"), "wb") as f:
                pickle.dump(results, f)
    finally:
        dist.destroy_process_group()


def spawn_pipeline(world: int, runs: list) -> dict:
    """Run ``runs`` (``[(name, (arch, mesh shape, tree, batch,
    microbatches))]``) on ``world`` gloo processes; rank 0's ``{name:
    {"loss", "grads"}}``."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as d:
        mp.spawn(_pipeline_worker, args=(world, os.path.join(d, "store"), d, list(runs)),
                 nprocs=world, join=True)
        with open(os.path.join(d, "pipeline.pkl"), "rb") as f:
            return pickle.load(f)
