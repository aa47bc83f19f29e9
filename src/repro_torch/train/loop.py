"""Training loop with the fault-tolerance envelope (PyTorch port of the JAX
package's ``train/loop.py``).

Production behaviours implemented (all testable on CPU):

* **checkpoint/restart** — resumes from the latest checkpoint if one exists
  (restored onto the devices of the state passed in);
* **step watchdog / straggler detection** — an EMA of step wall-time; a step
  slower than ``watchdog_factor``× the EMA is counted and logged.  On real
  multi-pod hardware the same signal triggers pre-emptive re-scheduling; in
  this repo it feeds metrics so the behaviour is observable and tested;
* **preemption handling** — SIGTERM/SIGINT set a flag; the loop finishes the
  current step, writes an emergency checkpoint and exits cleanly (the
  standard maintenance contract of a preemptible machine);
* **async checkpointing** — saves overlap subsequent steps;
* **NaN guard** — a non-finite loss aborts after saving a post-mortem
  checkpoint (restartable at the pre-NaN state).
"""

from __future__ import annotations

import dataclasses
import signal
import time
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np

from .checkpoint import Checkpointer
from .train_step import TrainState

__all__ = ["LoopConfig", "LoopResult", "run_loop"]


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 50
    keep: int = 3
    log_every: int = 10
    watchdog_factor: float = 3.0
    watchdog_warmup: int = 5  # steps before the EMA is trusted
    handle_signals: bool = False  # opt-in (tests drive the flag directly)


@dataclasses.dataclass
class LoopResult:
    state: Any
    history: List[Dict[str, float]]
    straggler_steps: int
    preempted: bool
    resumed_from: Optional[int]


def run_loop(
    state: TrainState,
    train_step: Callable,
    batches: Iterable[Dict],
    cfg: LoopConfig,
    log: Callable[[str], None] = print,
) -> LoopResult:
    ckpt = Checkpointer(cfg.checkpoint_dir, cfg.keep) if cfg.checkpoint_dir else None
    resumed_from = None
    if ckpt is not None:
        try:
            state, resumed_from = ckpt.restore_latest(state)
            log(f"[loop] resumed from step {resumed_from}")
        except FileNotFoundError:
            pass

    preempt = {"flag": False}
    old_handlers = {}
    if cfg.handle_signals:
        def _handler(signum, frame):
            preempt["flag"] = True

        for sig in (signal.SIGTERM, signal.SIGINT):
            old_handlers[sig] = signal.signal(sig, _handler)

    history: List[Dict[str, float]] = []
    stragglers = 0
    ema: Optional[float] = None
    steps_done = 0
    try:
        for batch in batches:
            step_no = int(state.step)
            if step_no >= cfg.total_steps or preempt["flag"]:
                break
            t0 = time.perf_counter()
            state, metrics = train_step(state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0

            if ema is None:
                ema = dt
            else:
                if steps_done >= cfg.watchdog_warmup and dt > cfg.watchdog_factor * ema:
                    stragglers += 1
                    log(
                        f"[watchdog] step {step_no}: {dt*1e3:.1f} ms vs EMA "
                        f"{ema*1e3:.1f} ms — straggler"
                    )
                ema = 0.9 * ema + 0.1 * dt
            steps_done += 1

            rec = {"step": step_no, "loss": loss, "sec": dt}
            rec.update(
                {
                    k: float(v)
                    for k, v in metrics.items()
                    if k not in ("loss",) and np.ndim(v) == 0
                }
            )
            history.append(rec)
            if step_no % cfg.log_every == 0:
                log(f"[loop] step {step_no}: loss={loss:.4f} ({dt*1e3:.1f} ms)")

            if not np.isfinite(loss):
                if ckpt is not None:
                    ckpt.save_sync(step_no + 1, state)
                raise FloatingPointError(
                    f"non-finite loss at step {step_no}; post-mortem saved"
                )

            if ckpt is not None and (step_no + 1) % cfg.checkpoint_every == 0:
                ckpt.save_async(int(state.step), state)

        if preempt["flag"]:
            log("[loop] preemption signal — emergency checkpoint")
        if ckpt is not None:
            ckpt.save_sync(int(state.step), state)
    finally:
        if ckpt is not None:
            ckpt.wait()
        for sig, h in old_handlers.items():
            signal.signal(sig, h)

    return LoopResult(
        state=state,
        history=history,
        straggler_steps=stragglers,
        preempted=preempt["flag"],
        resumed_from=resumed_from,
    )
