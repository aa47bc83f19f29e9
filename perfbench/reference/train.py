"""Plain reference of the first training steps: the mean next-token loss of
the whole batch, its gradient in float32 (one sequence at a time, summed),
clipping by the global norm, and AdamW with decoupled weight decay, each
leaf's new value rounded to the dtype it is stored in (the configuration's
``as_run.parameters``).  The learning rate is the linear warm-up and cosine
decay that the traffic file's ``hparams`` state.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

from .decoder import Decoder, strict


def learning_rate(hp: dict, step: int) -> float:
    peak, total, warm = hp["peak_lr"], hp["total_steps"], hp["warmup_steps"]
    final = hp.get("final_frac", 0.1)
    if step < warm:
        return peak * step / max(warm, 1)
    prog = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
    return peak * (final + (1 - final) * 0.5 * (1 + math.cos(math.pi * prog)))


def train_steps(config: dict, hp: dict, weights: Dict[str, torch.Tensor],
                batches: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                mode: str = "fp32") -> dict:
    """Run ``len(batches)`` steps from ``weights`` (left as they are) on
    ``(tokens [B, S], labels [B, S])`` batches.  Returns the loss of each
    step, the first step's global gradient norm before clipping, each
    leaf's norm of the first clipped gradient, and each leaf's norm of its
    change over all the steps."""
    params = {n: t.detach().float().clone().requires_grad_(True) for n, t in weights.items()}
    dtypes = {n: t.dtype for n, t in weights.items()}
    mu = {n: torch.zeros_like(p) for n, p in params.items()}
    nu = {n: torch.zeros_like(p) for n, p in params.items()}
    b1, b2, eps, wd = hp["b1"], hp["b2"], hp["eps"], hp["weight_decay"]
    model = Decoder(config, weights, mode)
    out = {"losses": []}
    with strict():
        for step, (tokens, labels) in enumerate(batches):
            n_tok = tokens.numel()
            loss = 0.0
            for p in params.values():
                p.grad = None
            for row in range(tokens.shape[0]):
                part = model.nll_sum(tokens[row], labels[row], params) / n_tok
                part.backward()
                loss += float(part.detach())
            out["losses"].append(loss)
            with torch.no_grad():
                grads = {n: p.grad for n, p in params.items()}
                gnorm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())).item()
                scale = min(hp["clip_norm"] / max(gnorm, 1e-9), 1.0)
                grads = {n: g * scale for n, g in grads.items()}
                if step == 0:
                    out["grad_norm"] = gnorm
                    out["grad_leaf"] = {n: float(g.norm()) for n, g in grads.items()}
                lr = learning_rate(hp, step)
                t = step + 1
                for n, p in params.items():
                    mu[n].mul_(b1).add_((1 - b1) * grads[n])
                    nu[n].mul_(b2).add_((1 - b2) * grads[n] * grads[n])
                    upd = mu[n] / (1 - b1 ** t) / (torch.sqrt(nu[n] / (1 - b2 ** t)) + eps)
                    new = p - lr * (upd + wd * p)
                    p.copy_(new.to(dtypes[n]).float())
    with torch.no_grad():
        out["update_leaf"] = {n: float((p - weights[n].float()).norm())
                              for n, p in params.items()}
    return out


def leaf_gaps(got: Dict[str, float], want: Dict[str, float],
              skip: Sequence[str] = ()) -> Tuple[float, str]:
    """The worst leaf's ``|got - want|`` over ``max(want, the median leaf's
    want)``, and that leaf's name; leaves in ``skip`` left out."""
    names = [n for n in want if n not in skip]
    med = sorted(want[n] for n in names)[len(names) // 2]
    worst, at = 0.0, ""
    for n in names:
        gap = abs(got[n] - want[n]) / max(want[n], med, 1e-30)
        if gap >= worst:
            worst, at = gap, n
    return worst, at


def still_leaves(grad_leaf: Dict[str, float]) -> List[str]:
    """Leaves whose reference gradient is under a thousandth of the median
    leaf's: nought to rounding, so Adam moves them by round-off alone."""
    vals = sorted(grad_leaf.values())
    med = vals[len(vals) // 2]
    return [n for n, v in grad_leaf.items() if v < 1e-3 * med]
