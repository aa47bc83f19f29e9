"""Training CLI: ``python -m repro_torch.launch.train --arch smollm-135m ...``.

Runs the full stack on one device (the card unless ``--device cpu``):
config -> token pipeline -> train step -> fault-tolerant loop (checkpoints,
watchdog, resume).  ``--smoke`` selects the reduced config so the same
driver exercises the real code path on a laptop; ``--dtype float32`` trains
float32 weights and activations in place of the config's.  A resumed run
reads the token stream from the checkpoint's step on (the pipeline's
batches are a function of the step), so it sees the batches an
uninterrupted run would have.

``--mesh DxM`` trains on a ``("data", "model")`` mesh: over the default
process group where one is up (torchrun's environment), else over a group
of one that this run starts (NCCL on ``cuda``, gloo on ``cpu``, a
``FileStore`` in a temporary directory) and ends.  D·M must equal the
world size.  The state is placed by ``sharding.state_specs`` and each batch
by ``batch_specs`` under ``launch.policy.make_policy(mesh, "train")``, and
the same step runs under that policy (``sharding.use_policy``): DTensors
through the model, the flash kernels on each rank's shards.  The loop,
checkpoints (full tensors, written by rank 0) and resume work as without a
mesh.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import shutil
import tempfile

import torch
import torch.distributed as dist

from repro_torch import compat
from repro_torch import sharding as shd
from repro_torch.configs import get_config
from repro_torch.data.tokens import TokenPipeline
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.policy import make_policy
from repro_torch.train import (
    LoopConfig,
    TrainHParams,
    init_state,
    make_train_step,
    run_loop,
)
from repro_torch.train._tree import tree_leaves
from repro_torch.train.checkpoint import latest_step
from repro_torch.train.loop import LoopResult

__all__ = ["main", "run", "setup"]


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", default="smollm-135m")
    p.add_argument("--smoke", action="store_true", help="reduced config")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--microbatches", type=int, default=None)
    p.add_argument("--compress-grads", action="store_true")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=50)
    p.add_argument("--mesh", default=None,
                   help="DxM: train on a (data, model) mesh of D·M ranks, e.g. 1x1")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--dtype", default=None, choices=("bfloat16", "float32"),
                   help="weights and activations (default: the config's)")
    return p


def setup(argv=None) -> tuple:
    """``(args, cfg, hp, pipe)``: the parsed flags, the model config, the
    train hyperparameters and the token pipeline that ``run`` trains with."""
    args = _parser().parse_args(argv)
    if args.mesh:
        mesh_shape(args.mesh)
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.microbatches:
        cfg = dataclasses.replace(cfg, microbatches=args.microbatches)
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype_name=args.dtype, param_dtype_name=args.dtype)
    hp = TrainHParams(
        peak_lr=args.lr,
        total_steps=args.steps,
        warmup_steps=max(args.steps // 20, 1),
        compress_grads=args.compress_grads,
    )
    pipe = TokenPipeline(
        vocab=cfg.vocab,
        seq_len=cfg.text_len(args.seq),
        global_batch=args.batch,
        seed=args.seed,
        n_frames=cfg.n_frames,
        n_patches=cfg.n_patches,
        d_model=cfg.d_model,
    )
    return args, cfg, hp, pipe


def mesh_shape(spec: str) -> tuple:
    """``"DxM"`` -> ``(D, M)``."""
    try:
        d, m = (int(n) for n in spec.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh {spec!r}: expected DxM, e.g. 1x1") from None
    if d < 1 or m < 1:
        raise ValueError(f"--mesh {spec!r}: both sizes must be at least 1")
    return d, m


@contextlib.contextmanager
def process_group(device: str):
    """The default process group: the one that is up, or a group of one
    started here (NCCL on ``cuda``, gloo on ``cpu``; a ``FileStore`` in a
    temporary directory) and destroyed on exit."""
    if dist.is_initialized():
        if torch.device(device).type == "cuda" and "LOCAL_RANK" in os.environ:
            torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        yield
        return
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    tmp = tempfile.mkdtemp(prefix="repro-train-group-")
    try:
        dist.init_process_group(backend, store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1)
        try:
            yield
        finally:
            dist.destroy_process_group()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def shard(state, step, mesh, device: str):
    """``(state, step)`` for the ``(data, model)`` ``mesh``: the state placed
    by ``state_specs`` and a step that places each batch by ``batch_specs``
    and runs ``step`` under the train policy, returning full metrics."""
    pol = make_policy(mesh, "train")
    state = shd.distribute_tree(state, shd.state_specs(state, pol))

    def sharded_step(state, batch):
        batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
        # plain tensors the model makes (positions, masks, RoPE tables) meet
        # DTensors as replicated
        with shd.use_policy(pol), compat.implicit_replication():
            batch = shd.distribute_tree(batch, shd.batch_specs(batch, pol))
            state, metrics = step(state, batch)
        return state, {k: shd.full_tensor(v) for k, v in metrics.items()}

    return state, sharded_step


def run(argv=None, log=print) -> LoopResult:
    """Parse ``argv``, train, and return the loop's result."""
    args, cfg, hp, pipe = setup(argv)
    group = process_group(args.device) if args.mesh else contextlib.nullcontext()
    with group:
        return _train(args, cfg, hp, pipe, log)


def _train(args, cfg, hp, pipe, log) -> LoopResult:
    state = init_state(args.seed, cfg, hp, device=args.device)
    step = make_train_step(cfg, hp)
    where = args.device
    if args.mesh:
        d, m = mesh_shape(args.mesh)
        world = dist.get_world_size()
        if d * m != world:
            raise ValueError(f"--mesh {args.mesh}: {d * m} ranks, the process group has {world}")
        mesh = make_host_mesh(d, m, device=torch.device(args.device).type)
        state, step = shard(state, step, mesh, state.step.device)
        where = f"{args.device}, mesh {d}x{m} of {world} ranks"

    n_params = sum(x.numel() for x in tree_leaves(state.params))
    log(f"[train] {cfg.name}: {n_params/1e6:.1f}M params, "
        f"{args.steps} steps @ batch {args.batch} x seq {args.seq} on {where}")

    lc = LoopConfig(
        total_steps=args.steps,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        log_every=max(args.steps // 20, 1),
        handle_signals=True,
    )
    start = (latest_step(args.checkpoint_dir) or 0) if args.checkpoint_dir else 0
    result = run_loop(state, step, pipe.batches(start), lc, log=log)
    if result.history:
        first, last = result.history[0]["loss"], result.history[-1]["loss"]
        log(f"[train] loss {first:.4f} -> {last:.4f} over "
            f"{len(result.history)} steps; stragglers={result.straggler_steps}")
    return result


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
