"""Train-step builder: loss → grads → (clip, compress) → optimizer update
(PyTorch port of the JAX package's ``train/train_step.py``).

``make_train_step(cfg, ...)`` returns a ``(state, batch) -> (state,
metrics)`` function that leaves its input state as it was; ``init_state``
builds the first state.  Features:

* **microbatching** — ``cfg.microbatches`` splits the global batch, and a
  Python loop accumulates each microbatch's grads in fp32 (activations for
  one microbatch at a time);
* **global-norm clipping** (fp32);
* **int8 error-feedback gradient compression** (optional) — the residual
  state lives in ``TrainState.err``;
* the update in fp32, cast back to the parameters' dtype.

``TrainState.params`` is the reference's parameter tree
(``models.model.param_tree``: each block position's weights stacked over
periods), so the optimizer state, the clipping norm, compression's per-leaf
scales and the checkpoint's leaf names are the reference's.  The model runs
on per-layer views of it (``models.model.tree_views`` through
``torch.func.functional_call``), and autograd returns grads in the tree's
layout.

Sharding-agnostic, as the reference's: under an active ``sharding`` policy
the state's leaves are DTensors (``launch.train --mesh`` places them by
``state_specs``) and each microbatch's grads are pinned to their
parameters' placements before they are summed (``_constrain_like_params``);
without one every annotation is a no-op.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn

from .. import sharding as shd
from ..models import model as model_lib
from . import compression as comp
from ._tree import tree_leaves, tree_map, tree_paths, tree_unflatten
from .optim import Optimizer, clip_by_global_norm, make_optimizer, warmup_cosine

__all__ = ["TrainState", "abstract_state", "make_train_step", "init_state", "TrainHParams"]


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: torch.Tensor  # int32 scalar on the parameters' device
    err: Optional[Any] = None  # compression residual (None = off)


@dataclasses.dataclass(frozen=True)
class TrainHParams:
    peak_lr: float = 3e-4
    total_steps: int = 10_000
    warmup_steps: int = 100
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    compress_grads: bool = False


def init_state(seed: int, cfg, hp: TrainHParams = TrainHParams(),
               device="cuda") -> TrainState:
    """Seeded random weights for ``cfg`` on ``device`` (the card unless the
    caller asks for the CPU) as the reference's tree, with fresh optimizer
    and compression state."""
    params = model_lib.param_tree(model_lib.init_params(cfg, seed, device), cfg)
    opt = _optimizer(cfg, hp)
    err = comp.init_error_state(params) if hp.compress_grads else None
    dev = tree_leaves(params)[0].device
    return TrainState(
        params=params,
        opt_state=opt.init(params),
        step=torch.zeros((), dtype=torch.int32, device=dev),
        err=err,
    )


def abstract_state(cfg, hp: TrainHParams = TrainHParams()) -> TrainState:
    """The :class:`TrainState` of ``cfg`` on the ``meta`` device: every leaf
    has its shape and dtype and no memory (the reference's
    ``jax.eval_shape`` of ``init_state``)."""
    params = model_lib.param_tree(model_lib.abstract_params(cfg), cfg)
    return TrainState(
        params=params,
        opt_state=_optimizer(cfg, hp).init(params),
        step=torch.zeros((), dtype=torch.int32, device="meta"),
        err=comp.init_error_state(params) if hp.compress_grads else None,
    )


def _optimizer(cfg, hp: TrainHParams) -> Optimizer:
    sched = warmup_cosine(hp.peak_lr, hp.total_steps, hp.warmup_steps)
    return make_optimizer(cfg.optimizer, sched, weight_decay=hp.weight_decay)


class _TreeLoss(nn.Module):
    """``models.model.loss_fn`` of a weightless (meta) :class:`Transformer`
    whose parameters a call of ``torch.func.functional_call`` replaces with
    views of the tree."""

    def __init__(self, cfg) -> None:
        super().__init__()
        self.cfg = cfg
        self.model = model_lib.Transformer(cfg, device="meta")

    def forward(self, batch):
        return model_lib.loss_fn(self.model, batch, self.cfg)


def _constrain_like_params(grads):
    """Pin each microbatch's gradient to its parameter's placements (the
    reference's ZeRO-2 pattern: a reduce-scatter onto the FSDP-sharded
    accumulator rather than an all-reduce).  No-op without an active
    policy."""
    pol = shd.active_policy()
    if pol is None:
        return grads
    return tree_unflatten(grads, [
        pol.constrain(g, shd._leaf_logical(path, g.dim(), shd.PARAM_AXES))
        for path, g in tree_paths(grads)
    ])


def _split_microbatches(batch: Dict, n: int) -> list:
    """[B, ...] -> n dicts of [B/n, ...] per leaf."""
    b = len(next(iter(batch.values())))
    if b % n:
        raise ValueError(f"batch of {b} rows does not split into {n} microbatches")
    per = b // n
    return [{k: v[i * per : (i + 1) * per] for k, v in batch.items()} for i in range(n)]


def make_train_step(
    cfg,
    hp: TrainHParams = TrainHParams(),
    loss_fn: Optional[Callable] = None,
) -> Callable[[TrainState, Dict], Tuple[TrainState, Dict]]:
    """Returns the train step.  ``loss_fn(params, batch) -> (loss,
    metrics)`` takes the parameter tree (default: the model's cross
    entropy on ``cfg``)."""
    opt = _optimizer(cfg, hp)
    if loss_fn is None:
        module = _TreeLoss(cfg)

        def loss_fn(params, batch):
            views = {f"model.{n}": t for n, t in model_lib.tree_views(params, cfg).items()}
            return torch.func.functional_call(module, views, (batch,))

    nmicro = max(cfg.microbatches, 1)

    def grad_fn(params, batch):
        with torch.enable_grad():
            leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
            loss, metrics = loss_fn(tree_unflatten(params, leaves), batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        metrics = {k: v.detach() for k, v in metrics.items()}
        return tree_unflatten(params, grads), metrics

    def compute_grads(params, batch):
        if nmicro == 1:
            return grad_fn(params, batch)
        g_acc = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        m_acc = None
        for mb in _split_microbatches(batch, nmicro):
            grads, metrics = grad_fn(params, mb)
            grads = _constrain_like_params(grads)
            g_acc = tree_map(lambda a, g: a + g.float(), g_acc, grads)
            m_acc = metrics if m_acc is None else {
                k: m_acc[k] + v for k, v in metrics.items()}
        inv = 1.0 / nmicro
        grads = tree_map(lambda g: g * inv, g_acc)
        metrics = {k: v * inv for k, v in m_acc.items()}
        metrics["ntok"] = metrics["ntok"] * nmicro
        return grads, metrics

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        grads, metrics = compute_grads(state.params, batch)
        with torch.no_grad():
            grads, gnorm = clip_by_global_norm(grads, hp.clip_norm)
            err = state.err
            if err is not None:
                grads, err = comp.compress_decompress(grads, err)
            updates, opt_state = opt.update(
                grads, state.opt_state, state.params, state.step
            )
            params = tree_map(
                lambda p, u: (p.float() + u).to(p.dtype), state.params, updates
            )
        metrics = dict(metrics)
        metrics["grad_norm"] = gnorm
        new_state = TrainState(
            params=params,
            opt_state=opt_state,
            step=state.step + 1,
            err=err,
        )
        return new_state, metrics

    return train_step
