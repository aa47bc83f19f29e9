"""Training CLI: ``python -m repro_torch.launch.train --arch smollm-135m ...``.

Runs the full stack on one device (the card unless ``--device cpu``):
config -> token pipeline -> train step -> fault-tolerant loop (checkpoints,
watchdog, resume).  ``--smoke`` selects the reduced config so the same
driver exercises the real code path on a laptop; ``--dtype float32`` trains
float32 weights and activations in place of the config's.  A resumed run
reads the token stream from the checkpoint's step on (the pipeline's
batches are a function of the step), so it sees the batches an
uninterrupted run would have.  ``--mesh`` (sharded training) is not ported
yet.
"""

from __future__ import annotations

import argparse
import dataclasses

from repro_torch.configs import get_config
from repro_torch.data.tokens import TokenPipeline
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
                   help="DxM, e.g. 1x1; sharded training is not ported yet")
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
        raise NotImplementedError(
            "--mesh: sharded training needs the port of sharding.py, which is "
            "not done yet (ROADMAP queue 1, item 10.5)"
        )
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


def run(argv=None, log=print) -> LoopResult:
    """Parse ``argv``, train, and return the loop's result."""
    args, cfg, hp, pipe = setup(argv)
    state = init_state(args.seed, cfg, hp, device=args.device)
    step = make_train_step(cfg, hp)

    n_params = sum(x.numel() for x in tree_leaves(state.params))
    log(f"[train] {cfg.name}: {n_params/1e6:.1f}M params, "
        f"{args.steps} steps @ batch {args.batch} x seq {args.seq} on {args.device}")

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
