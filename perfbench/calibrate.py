"""Readings that the limits of ``limits/<cell>.json`` are set from; not run
by the benchmark's own runs.

    python -m perfbench.calibrate --workload <cell> --seeds 1,2,3 \
        [--control-seeds 4,5,6] [--faults half_batch] [--seconds 0]

For each seed of ``--seeds`` the cell runs as a benchmark run does (with a
window of ``--seconds``) and its compared numbers are printed; for each of
``--control-seeds`` the control is read: the reference in the precision
below the configuration's, put in the port's place (a training cell's
first steps, or a serving cell's served positions, where the control's own
first token is read against the float32 reference); each fault of
``--faults`` (``perfbench.faults``) is planted and read on the control
seeds.  One JSON line a reading on standard output.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from perfbench import faults, harness
from perfbench import weights as wmod


def control(run) -> dict:
    """The control's compared numbers on ``run``'s seed."""
    import torch

    from perfbench.reference import train as ref_train

    if run.traffic["runner"] == "train":
        from perfbench.runners import train

        flat = wmod.draw(run.config, run.seed, run.device)
        feed = train.batches(run.traffic, run.config["vocab_size"], run.seed, run.device)
        first = [(b["tokens"], b["labels"]) for b in
                 (next(feed) for _ in range(run.traffic["first_steps"]))]
        hp = run.traffic["hparams"]
        want = ref_train.train_steps(run.config, hp, flat, first, "fp32")
        low = ref_train.train_steps(run.config, hp, flat, first, "fp8")
        return {k: v["value"] for k, v in train.compare(low, want, run.limits).items()}
    from perfbench.runners import serve

    # the served tokens and the expert picks come from the port's own run
    kept = {}
    saved = serve.judge

    def capture(run_, flat, prompts, done, calls, check, **kw):
        kept.update(flat=flat, prompts=prompts, done=done, calls=calls, check=check)
        return saved(run_, flat, prompts, done, calls, check, **kw)
    serve.judge = capture
    try:
        res = harness.execute(run, harness.benchmark())
    finally:
        serve.judge = saved
    out = {f"program_{k}": v["value"] for k, v in res["checks"].items()}
    got = serve.judge(run, kept["flat"], kept["prompts"], kept["done"], kept["calls"],
                      kept["check"], mode="fp8")
    out.update(got)
    del kept
    if run.device == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--seconds", type=float, default=0.0)
    args = p.parse_args(argv)
    bench = harness.benchmark()
    cell = harness.find_cell(bench, args.workload)
    config, traffic, limits = harness.cell_files(cell)
    harness.setup_environment()
    ints = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731

    def make(seed):
        return harness.Run(name=cell["name"], cell=cell, config=config, traffic=traffic,
                           limits=limits, seed=seed, seconds=args.seconds, trace=False,
                           device="cuda", t_start=time.perf_counter())

    def emit(**row):
        print(json.dumps(row), flush=True)

    for seed in ints(args.seeds):
        res = harness.execute(make(seed), bench)
        emit(kind="program", seed=seed, correct=res["correct"],
             checks={k: v["value"] for k, v in res["checks"].items()},
             metrics={k: v["value"] for k, v in res["metrics"].items()}, notes=res["notes"])
    for seed in ints(args.control_seeds):
        emit(kind="control", seed=seed, checks=control(make(seed)))
        for name in [f for f in args.faults.split(",") if f]:
            with faults.planted(name):
                res = harness.execute(make(seed), bench)
            emit(kind=f"fault:{name}", seed=seed, correct=res["correct"],
                 checks={k: v["value"] for k, v in res["checks"].items()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
