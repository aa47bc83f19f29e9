"""Optimizers as pure (init, update) pairs over parameter trees (PyTorch
port of the JAX package's ``train/optim.py``, the same update rules).

No ``torch.optim`` — the three optimizers the configs reference are
implemented directly, as the reference writes them:

* ``sgd``       — momentum SGD (paper-era baseline)
* ``adamw``     — decoupled weight decay Adam; fp32 moments
* ``adafactor`` — factored second moments (Shazeer & Stern 2018): for a
  [r, c] matrix the second-moment statistics are one row vector + one col
  vector instead of r·c.  Matrices factor over their last two dims;
  vectors fall back to full statistics.

Update rules run in fp32 regardless of param dtype; the cast back happens
once per step.  ``clip_by_global_norm`` and the warmup-cosine schedule are
provided here too so the train step has no other deps.  A tree is what
``_tree`` maps over; ``step`` is an integer (0-d tensor or int).
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Tuple

import torch

from ._tree import flatten_up_to, tree_leaves, tree_map, tree_unflatten

__all__ = [
    "Optimizer",
    "sgd",
    "adamw",
    "adafactor",
    "make_optimizer",
    "clip_by_global_norm",
    "global_norm",
    "warmup_cosine",
]


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, Any], Tuple[Any, Any]]
    # update(grads, opt_state, params, step) -> (updates, opt_state)


def _f32(t):
    return tree_map(lambda x: x.float(), t)


def _step_f32(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.float()
    return torch.tensor(float(step), dtype=torch.float32)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


def warmup_cosine(
    peak_lr: float,
    total_steps: int,
    warmup_steps: int = 100,
    final_frac: float = 0.1,
) -> Callable[[Any], torch.Tensor]:
    def schedule(step):
        step = _step_f32(step)
        warm = peak_lr * step / max(warmup_steps, 1)
        prog = torch.clamp(
            (step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0
        )
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup_steps, warm, peak_lr * cos)

    return schedule


# ---------------------------------------------------------------------------
# SGD
# ---------------------------------------------------------------------------

def sgd(lr: Callable, momentum: float = 0.9) -> Optimizer:
    def init(params):
        return {"mu": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)}

    def update(grads, state, params, step):
        del params
        mu = tree_map(lambda m, g: momentum * m + g.float(), state["mu"], grads)
        lr_t = lr(step)
        updates = tree_map(lambda m: -lr_t * m, mu)
        return updates, {"mu": mu}

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw(
    lr: Callable,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
) -> Optimizer:
    def init(params):
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
        return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params)}

    def update(grads, state, params, step):
        t = _step_f32(step) + 1.0
        gf = _f32(grads)
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state["mu"], gf)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state["nu"], gf)
        bc1 = 1 - b1**t
        bc2 = 1 - b2**t
        lr_t = lr(step)

        def upd(m, v, p):
            step_ = m / bc1 / (torch.sqrt(v / bc2) + eps)
            return -lr_t * (step_ + weight_decay * p.float())

        updates = tree_map(upd, mu, nu, params)
        return updates, {"mu": mu, "nu": nu}

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# Adafactor (factored second moments)
# ---------------------------------------------------------------------------

def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def adafactor(
    lr: Callable,
    decay: float = 0.8,
    eps: float = 1e-30,
    clip_threshold: float = 1.0,
    weight_decay: float = 0.0,
) -> Optimizer:
    """Factored RMS-style optimizer; no first moment (memory-lean)."""

    def init(params):
        def make(p):
            f32 = dict(dtype=torch.float32, device=p.device)
            if _factored(p.shape):
                return {
                    "vr": torch.zeros(p.shape[:-1], **f32),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32),
                }
            return {"v": torch.zeros(p.shape, **f32)}

        return {"v": tree_map(make, params)}

    def update(grads, state, params, step):
        t = _step_f32(step) + 1.0
        # increasing-decay schedule from the paper: 1 - t^{-0.8}
        beta = 1.0 - t**-decay
        lr_t = lr(step)

        def upd(g, v, p):
            gf = g.float()
            g2 = gf * gf + eps
            if "vr" in v:
                vr = beta * v["vr"] + (1 - beta) * torch.mean(g2, dim=-1)
                vc = beta * v["vc"] + (1 - beta) * torch.mean(g2, dim=-2)
                # rank-1 reconstruction of the second moment
                denom = torch.clamp(torch.mean(vr, dim=-1, keepdim=True), min=eps)
                vhat = vr[..., None] * vc[..., None, :] / denom[..., None]
                new_v = {"vr": vr, "vc": vc}
            else:
                vhat = beta * v["v"] + (1 - beta) * g2
                new_v = {"v": vhat}
            u = gf * torch.rsqrt(vhat + eps)
            # RMS clip (adafactor's built-in update clipping)
            rms = torch.sqrt(torch.mean(u * u) + eps)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            du = -lr_t * (u + weight_decay * p.float())
            return du, new_v

        flat = zip(tree_leaves(grads), flatten_up_to(grads, state["v"]),
                   flatten_up_to(grads, params))
        outs = [upd(g, v, p) for g, v, p in flat]
        updates = tree_unflatten(grads, [o[0] for o in outs])
        new_vs = tree_unflatten(grads, [o[1] for o in outs])
        return updates, {"v": new_vs}

    return Optimizer(init, update)


def make_optimizer(
    name: str, lr_schedule: Callable, weight_decay: float = 0.1
) -> Optimizer:
    if name == "adamw":
        return adamw(lr_schedule, weight_decay=weight_decay)
    if name == "adafactor":
        return adafactor(lr_schedule)
    if name == "sgd":
        return sgd(lr_schedule)
    raise ValueError(f"unknown optimizer {name}")
