"""Mixture-of-Experts feed-forward (mixtral / qwen2-moe / jamba), PyTorch port
of the JAX package's ``models/moe.py``.

GShard-style **capacity dispatch**, with the reference's semantics:

* the router runs in float32: softmax over the experts, top-k, the k gates
  renormalised to sum to 1;
* each expert holds ``capacity`` slots, ``round_up(max(int(t·k/E·cf), 1),
  128)`` capped at ``round_up(t, 128)`` for ``t`` routed tokens;
* positions are assigned **slot-major**: every token's first pick is
  placed (in token order) before any token's second pick, and so on; a
  (token, pick) pair is kept iff its position is below the capacity, so
  over-capacity pairs are dropped (their combine weight is 0);
* tokens are gathered into an ``[E, capacity, d]`` buffer, the expert
  FFNs (SwiGLU) run as batched products over the expert axis, and the
  outputs come back through a weighted scatter-add;
* shared experts (qwen2-moe) run densely beside the routed ones, ungated;
* the Switch-style load-balance loss is ``E · Σ_e frac_e · imp_e`` from
  the first pick.

``moe_apply`` routes all ``B·S`` tokens as one group; ``moe_apply_row_local``
routes each batch row as its own group (its capacity from ``S``).  Both
run the same code over a leading group axis.  Nothing here is a TPU kernel
in the reference (its dispatch and expert products are XLA ops), so all of
it is plain PyTorch.

Weights keep the reference's layouts: ``router [d, E]`` float32,
``we_gate`` / ``we_up [E, d, ff]`` and ``we_down [E, ff, d]`` in
``cfg.param_dtype``, ``shared.{w_gate, w_up} [d, ff_s]`` and
``shared.w_down [ff_s, d]``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..sharding import constrain
from .layers import MLP, dense_init, mlp_apply

__all__ = ["MoE", "capacity", "moe_apply", "moe_apply_row_local", "moe_init", "route"]


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def capacity(t: int, k: int, e: int, cf: float) -> int:
    """Slots an expert holds for ``t`` routed tokens (the reference's
    formula: 128-aligned, never more than ``round_up(t, 128)``)."""
    return min(_round_up(max(int(t * k / e * cf), 1), 128), _round_up(t, 128))


def _expert_major(w: nn.Parameter) -> nn.Parameter:
    """``[in, E, out]`` (as ``dense_init`` draws it) → ``[E, in, out]``."""
    return nn.Parameter(w.data.permute(1, 0, 2).contiguous(), requires_grad=False)


class MoE(nn.Module):
    """Router, routed experts and (if ``cfg.moe_shared_ff``) the shared
    experts of one MoE feed-forward."""

    def __init__(self, cfg, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        d, e, ff, dt = cfg.d_model, cfg.moe_experts, cfg.moe_ff, cfg.param_dtype
        self.router = dense_init(d, e, torch.float32, generator, device=device)
        self.we_gate = _expert_major(dense_init(d, (e, ff), dt, generator, device=device))
        self.we_up = _expert_major(dense_init(d, (e, ff), dt, generator, device=device))
        self.we_down = _expert_major(dense_init(ff, (e, d), dt, generator, device=device))
        if cfg.moe_shared_ff:
            self.shared = MLP(d, cfg.moe_shared_ff, "swiglu", dt, generator, device)


def moe_init(cfg, generator: Optional[torch.Generator] = None, device=None) -> MoE:
    return MoE(cfg, generator, device)


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``F.one_hot(idx, n)`` (int64) as a comparison with ``arange(n)``:
    the same values, and DTensor has a rule for it (none for one_hot's
    bounds assert under inference mode)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).long()


def route(probs: torch.Tensor, k: int, cap: int):
    """The dispatch plan of router probabilities ``probs [G, T, E]``
    (float32) for groups of ``T`` tokens and ``cap`` slots an expert:
    ``(gate_w, sel, pos, keep)``, each ``[G, T, k]`` — the renormalised
    gates, the chosen experts (descending probability), each pick's
    slot-major position inside its expert, and whether it is kept."""
    g, t, e = probs.shape
    gate_w, sel = torch.topk(probs, k, dim=-1)
    gate_w = gate_w / gate_w.sum(dim=-1, keepdim=True)
    # slot-major order: all first picks, then all second picks, ...; each
    # pick's position is the number of earlier picks of its expert
    flat = sel.transpose(1, 2).reshape(g, k * t)
    onehot = _one_hot(flat, e)
    before = torch.cumsum(onehot, dim=1) - onehot
    pos = torch.gather(before, 2, flat[..., None])[..., 0]
    pos = pos.reshape(g, k, t).transpose(1, 2)
    return gate_w, sel, pos, pos < cap


def _moe_groups(params: MoE, xg: torch.Tensor, cfg, cf: float):
    """MoE over ``xg [G, T, d]``, each group routed on its own: returns
    ``(out [G, T, d] in xg's dtype, aux)``."""
    g, t, d = xg.shape
    e, k = cfg.moe_experts, cfg.moe_topk
    cap = capacity(t, k, e, cf)
    # DTensor has no sharding rule for the dispatch's gathers and scatters
    # along a sharded token axis: route whole groups (no-op without a policy)
    xg = constrain(xg, (None, None, None))

    probs = torch.softmax(xg.float() @ params.router, dim=-1)  # [G, T, E]
    gate_w, sel, pos, keep = route(probs, k, cap)

    # slot (e, c) of group g ← its (token, weight); dropped picks go to the
    # overflow slot e·cap, which is sliced away.  Kept destinations are
    # unique, so the scatter is exact.
    dst = torch.where(keep, sel * cap + pos, e * cap).reshape(g, t * k)
    tok = torch.arange(t, device=xg.device).repeat_interleave(k).expand(g, t * k)
    slot_tok = torch.zeros((g, e * cap + 1), dtype=torch.long, device=xg.device)
    slot_tok = slot_tok.scatter(1, dst, tok)[:, :-1]
    slot_w = torch.zeros((g, e * cap + 1), dtype=torch.float32, device=xg.device)
    slot_w = slot_w.scatter(1, dst, (gate_w * keep).reshape(g, t * k))[:, :-1]
    slot_valid = (slot_w > 0).to(xg.dtype)

    xe = torch.gather(xg, 1, slot_tok[..., None].expand(g, e * cap, d))
    xe = (xe * slot_valid[..., None]).reshape(g, e, cap, d)
    ye = _experts(params, xe)  # [G, E·cap, d]

    # weighted scatter-add back to the tokens, summed in float32
    combine = (ye * slot_w[..., None].to(ye.dtype)).float()
    out = torch.zeros((g, t, d), dtype=torch.float32, device=xg.device)
    out = out.scatter_add(1, slot_tok[..., None].expand(g, e * cap, d), combine)
    out = out.to(ye.dtype)

    if hasattr(params, "shared"):
        out = out + mlp_apply(params.shared, xg, "swiglu")

    # Switch-style load-balance loss over every routed token
    frac = _one_hot(sel[..., 0], e).float().mean(dim=(0, 1))
    imp = probs.mean(dim=(0, 1))
    aux = e * torch.sum(frac * imp)
    return out.to(xg.dtype), aux


def _experts(params: MoE, xe: torch.Tensor) -> torch.Tensor:
    """SwiGLU experts over ``xe [G, E, cap, d]`` as batched products:
    returns ``[G, E·cap, d]``."""
    g, e, cap, d = xe.shape
    x = xe.transpose(0, 1).reshape(e, g * cap, d)
    h = F.silu(torch.bmm(x, params.we_gate)) * torch.bmm(x, params.we_up)
    y = torch.bmm(h, params.we_down)  # [E, G·cap, d]
    return y.reshape(e, g, cap, d).transpose(0, 1).reshape(g, e * cap, d)


def moe_apply(
    params: MoE, x: torch.Tensor, cfg, capacity_factor: Optional[float] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x ``[B, S, d]`` → (out ``[B, S, d]``, aux loss, a float32 scalar),
    all ``B·S`` tokens routed as one group."""
    b, s, d = x.shape
    cf = capacity_factor if capacity_factor is not None else cfg.moe_capacity
    out, aux = _moe_groups(params, x.reshape(1, b * s, d), cfg, cf)
    return out.reshape(b, s, d), aux


def moe_apply_row_local(
    params: MoE, x: torch.Tensor, cfg, capacity_factor: Optional[float] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-local dispatch: each batch row is its own routing group, with its
    capacity from ``S``; in the dropless regime equal to :func:`moe_apply`."""
    cf = capacity_factor if capacity_factor is not None else cfg.moe_capacity
    return _moe_groups(params, x, cfg, cf)
