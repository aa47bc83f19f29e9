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

from ..sharding import constrain, is_dtensor, sum_grad
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


def _moe_groups(params: MoE, xg: torch.Tensor, cfg, cf: float, rows: bool):
    """MoE over ``xg [G, T, d]``, each group routed on its own (``rows``:
    the groups are batch rows, placed over the batch axes; else one global
    group): returns ``(out [G, T, d] in xg's dtype, aux)``."""
    g, t, d = xg.shape
    e, k = cfg.moe_experts, cfg.moe_topk
    cap = capacity(t, k, e, cf)
    # each group whole where it is routed (DTensor has no rule for the
    # dispatch's gathers and scatters along a sharded token axis): the
    # row-local groups over the batch axes, one global group everywhere
    group = "batch" if rows else None
    xg = constrain(xg, (group, None, None))

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

    if is_dtensor(xg):
        out = _sharded_dispatch(params, xg, slot_tok, slot_w, slot_valid, e, cap, group)
    else:
        xe = torch.gather(xg, 1, slot_tok[..., None].expand(g, e * cap, d))
        xe = (xe * slot_valid[..., None]).reshape(g, e, cap, d)
        ye = _experts(params, xe)  # [G, E·cap, d]
        out = _combine(ye, slot_tok, slot_w, t)

    if hasattr(params, "shared"):
        out = out + mlp_apply(params.shared, xg, "swiglu")

    # Switch-style load-balance loss over every routed token
    frac = _one_hot(sel[..., 0], e).float().mean(dim=(0, 1))
    imp = probs.mean(dim=(0, 1))
    aux = e * torch.sum(frac * imp)
    return out.to(xg.dtype), aux


def _combine(ye, slot_tok, slot_w, t: int) -> torch.Tensor:
    """The weighted scatter-add of expert outputs ``ye [G, slots, d]`` back
    to ``t`` tokens, summed in float32, in ``ye``'s dtype."""
    g, n, d = ye.shape
    combine = (ye * slot_w[..., None].to(ye.dtype)).float()
    out = torch.zeros((g, t, d), dtype=torch.float32, device=ye.device)
    return out.scatter_add(1, slot_tok[..., None].expand(g, n, d), combine).to(ye.dtype)


def _sharded_dispatch(params: MoE, xg, slot_tok, slot_w, slot_valid, e: int, cap: int,
                      group):
    """Gather, experts and combine for DTensor groups ``xg [G, T, d]``, in
    the reference's expert-parallel layout: the ``[G, E, cap, d]`` buffers
    placed by ``(group, "expert", "moe_cap", "embed")`` (experts over
    ``model`` where it divides them, else whole; capacity over ``data``),
    each rank gathering and scattering its own slots on local tensors
    (``compat.local_map``), so no flattened slot axis is ever split.  The
    result is a partial sum over the mesh dims that split the slots."""
    from torch.distributed.tensor import Partial, Shard

    from ..compat import local_map

    g, t, d = xg.shape
    slot_tok, slot_w, slot_valid = (
        constrain(s.reshape(g, e, cap), (group, "expert", "moe_cap"))
        for s in (slot_tok, slot_w, slot_valid))
    slots = tuple(slot_tok.placements)
    groups = tuple(xg.placements)
    mesh = xg.device_mesh

    # the groups are whole over the mesh dims that split the slots: their
    # gradient is the sum of each rank's slots' parts
    split = [mesh.get_group(i) for i, (p, q) in enumerate(zip(slots, groups))
             if isinstance(p, Shard) and not isinstance(q, Shard)]

    def gather(x, tok, valid):
        x = sum_grad(x, split)
        gl = tok.shape[0]
        xe = torch.gather(x, 1, tok.reshape(gl, -1)[..., None].expand(gl, -1, d))
        return xe.reshape(tok.shape + (d,)) * valid[..., None]

    xe = local_map(gather, out_placements=list(slots), in_placements=(groups, slots, slots),
                   device_mesh=mesh, redistribute_inputs=True)(xg, slot_tok, slot_valid)
    ye = constrain(_experts_einsum(params, xe, group), (group, "expert", "moe_cap", "embed"))

    def combine(y, tok, w):
        gl = y.shape[0]
        return _combine(y.reshape(gl, -1, d), tok.reshape(gl, -1), w.reshape(gl, -1), t)

    summed = tuple(Partial() if isinstance(p, Shard) and p.dim > 0 else p for p in slots)
    return local_map(combine, out_placements=list(summed),
                     in_placements=(tuple(ye.placements), slots, slots),
                     device_mesh=mesh, redistribute_inputs=True)(ye, slot_tok, slot_w)


def _experts_einsum(params: MoE, xe: torch.Tensor, group) -> torch.Tensor:
    """SwiGLU experts over ``xe [G, E, cap, d]`` as products over the
    four-dimensional buffer (no flattening of a split axis), the weights
    gathered along ``d`` and split over ``ffn`` as the rules say: each
    rank's own capacity slice and ``ffn`` slice; ``[G, E, cap, d]``,
    partial over ``ffn``'s axis."""
    w_gate, w_up = (constrain(w, ("expert", None, "ffn")) for w in (params.we_gate, params.we_up))
    w_down = constrain(params.we_down, ("expert", "ffn", None))
    h = F.silu(torch.einsum("gecd,edf->gecf", xe, w_gate)) * torch.einsum(
        "gecd,edf->gecf", xe, w_up)
    return torch.einsum("gecf,efd->gecd", constrain(h, (group, "expert", "moe_cap", "ffn")),
                        w_down)


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
    out, aux = _moe_groups(params, x.reshape(1, b * s, d), cfg, cf, rows=False)
    return out.reshape(b, s, d), aux


def moe_apply_row_local(
    params: MoE, x: torch.Tensor, cfg, capacity_factor: Optional[float] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-local dispatch: each batch row is its own routing group, with its
    capacity from ``S``; in the dropless regime equal to :func:`moe_apply`."""
    cf = capacity_factor if capacity_factor is not None else cfg.moe_capacity
    return _moe_groups(params, x, cfg, cf, rows=True)
