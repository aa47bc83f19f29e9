"""Training substrate: optimizers, train step, checkpointing, loop (PyTorch
port of the JAX package's ``train/``).

* ``optim``        — SGD / AdamW / Adafactor + schedules + clipping
* ``train_step``   — microbatched grad-accumulating step builder
* ``compression``  — int8 error-feedback gradient compression
* ``checkpoint``   — atomic async checkpoints, device-agnostic restore
* ``loop``         — watchdog / preemption / resume envelope

* ``pipeline``     — GPipe-style pipeline parallelism over the ``pod`` axis
  (imported on its own, as in the reference)

Sharded training places the state on a mesh through ``repro_torch.sharding``
(``launch.train --mesh``); the same step runs on DTensors.
"""

from . import checkpoint, compression, loop, optim, train_step
from .checkpoint import Checkpointer
from .loop import LoopConfig, run_loop
from .optim import make_optimizer, warmup_cosine
from .train_step import TrainHParams, TrainState, init_state, make_train_step

__all__ = [
    "Checkpointer",
    "LoopConfig",
    "TrainHParams",
    "TrainState",
    "checkpoint",
    "compression",
    "init_state",
    "loop",
    "make_optimizer",
    "make_train_step",
    "optim",
    "run_loop",
    "train_step",
    "warmup_cosine",
]
