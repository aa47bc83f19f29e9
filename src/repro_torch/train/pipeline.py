"""Pipeline parallelism over the ``pod`` axis (GPipe-style, looped SPMD;
PyTorch port of the JAX package's ``train/pipeline.py``).

At 2 pods the multi-pod mesh's outer axis can either replicate (outer DP —
the dry-run default) or **pipeline**: each pod holds a slice of the depth
and microbatch activations stream pod0 -> pod1 — turning the cross-pod
traffic from a full gradient all-reduce into boundary activations
(B_micro × S × d per tick).

Schedule: the reference's looped formulation.  Every stage runs the SAME
program for ``M + stages − 1`` ticks; at tick t, stage 0 injects
microbatch t (the last one again in the drain phase), every stage applies
its blocks, and the boundary activations rotate forward one stage.  The
last stage's head and loss count where valid (``t ≥ stages − 1``).  The
bubble ticks run as in the reference, so an MoE config's router aux
(averaged over all ticks, then over stages) is the reference's.

The rotation is a ``torch.autograd.Function`` around
``dist.batch_isend_irecv``: its backward sends the gradient the other way,
so autograd on each rank runs the backward drain tick by tick, in the same
order on every rank.  Stage 0 takes its input through ``torch.where`` (as
the reference's ``jnp.where``), and every stage's last output joins the
loss with weight zero, so each rank's graph reaches every rotation.  The
pod sum of the loss and the data mean are all-reduces whose backward is
the identity (every rank seeds its own copy of the same scalar).
:func:`make_pp_loss_for_mesh` takes the leaves to the stage's whole slices
in one Function whose backward, after the ring's, sums each gradient over
the ranks that used the leaf: a period leaf over ``data``, every other leaf
(the tied embedding: stage 0's lookup and the last stage's head) over
``pod`` and ``data`` — the cotangent psum that ``shard_map`` applies to a
replicated input.

Scope (the reference's): homogeneous decoder-only patterns with RoPE or no
positions (``ValueError`` for an encoder, a patch prefix or learned
positions, which the reference's schedule would drop), depth split evenly
across stages.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.distributed as dist
from torch import nn

from .. import sharding as shd
from ..models import model as model_lib
from ..models.layers import apply_norm
from ._tree import tree_paths, tree_unflatten

__all__ = ["pipeline_loss_fn", "make_pp_loss_for_mesh"]


class _Rotate(torch.autograd.Function):
    """Boundary activations one stage forward around the ring (``ppermute``);
    the backward sends the gradient one stage back."""

    @staticmethod
    def forward(ctx, y, group, nxt, prv):
        ctx.group, ctx.nxt, ctx.prv = group, nxt, prv
        return _exchange(y, group, send_to=nxt, recv_from=prv)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group, send_to=ctx.prv, recv_from=ctx.nxt), None, None, None


def _exchange(x: torch.Tensor, group, *, send_to: int, recv_from: int) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, send_to, group), dist.P2POp(dist.irecv, out, recv_from, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _SumAcross(torch.autograd.Function):
    """All-reduce sum whose backward is the identity: every rank holds the
    reduced value and seeds its own backward with it (Megatron's
    reduce-from-region)."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def _sum_across(x: torch.Tensor, group) -> torch.Tensor:
    if group is None or dist.get_world_size(group) == 1:
        return x
    return _SumAcross.apply(x, group)


class _StageSlices(torch.autograd.Function):
    """Each DTensor leaf as this stage's slice, whole along every other dim
    (a period leaf keeps its ``axis`` shard, any other leaf is gathered
    whole).  The backward takes every leaf's local gradient at once, after
    the whole pipeline's backward, as a partial sum over the ranks that did
    not split the slice, and reduces it onto the leaf's placements: in one
    order on every rank, so these collectives never interleave with the
    ring's sends."""

    @staticmethod
    def forward(ctx, mesh, axis, periods, *leaves):
        from torch.distributed.tensor import Replicate, Shard

        pod = list(mesh.mesh_dim_names).index(axis)
        ctx.mesh, ctx.pod, ctx.periods = mesh, pod, periods
        ctx.placements = [x.placements for x in leaves]
        ctx.shapes = [(x.shape, x.stride()) for x in leaves]
        out = []
        for x, stacked in zip(leaves, periods):
            keep = [Shard(0) if stacked and d == pod else Replicate() for d in range(mesh.ndim)]
            out.append(x.redistribute(mesh, keep).to_local())
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        from torch.distributed.tensor import DTensor, Partial, Shard

        mesh, out = ctx.mesh, []
        for g, stacked, placements, (shape, stride) in zip(
                grads, ctx.periods, ctx.placements, ctx.shapes):
            partial = [Shard(0) if stacked and d == ctx.pod else Partial()
                       for d in range(mesh.ndim)]
            g = DTensor.from_local(g.contiguous(), mesh, partial, run_check=False,
                                   shape=shape, stride=stride)
            out.append(g.redistribute(mesh, placements))
        return (None, None, None, *out)


def _check_scope(cfg, stages: int) -> None:
    if cfg.is_encoder_decoder or cfg.n_patches or cfg.pos == "learned":
        raise ValueError(
            f"{cfg.name}: the pipeline runs decoder-only models with RoPE or no "
            f"positions (the reference's scope)"
        )
    if cfg.n_periods % stages:
        raise ValueError(f"{cfg.name}: {cfg.n_periods} periods do not split into "
                         f"{stages} stages")


def _stage_cfg(cfg, stages: int):
    return dataclasses.replace(cfg, n_layers=cfg.n_layers // stages)


class _Stage(nn.Module):
    """The whole schedule on one stage's blocks (a weightless meta
    :class:`~repro_torch.models.model.Transformer` of ``n_layers / stages``
    layers, whose parameters ``functional_call`` replaces)."""

    def __init__(self, cfg, stages: int) -> None:
        super().__init__()
        self.cfg, self.stages = cfg, stages
        self.model = model_lib.Transformer(_stage_cfg(cfg, stages), device="meta")

    def forward(self, tokens, labels, microbatches: int, group):
        cfg, stages, m, params = self.cfg, self.stages, microbatches, self.model
        stage = dist.get_rank(group) if group is not None else 0
        nxt = prv = None
        if stages > 1:
            nxt = dist.get_global_rank(group, (stage + 1) % stages)
            prv = dist.get_global_rank(group, (stage - 1) % stages)
        b, s = tokens.shape
        if b % m:
            raise ValueError(f"batch of {b} rows does not split into {m} microbatches")
        mb_tokens = tokens.reshape(m, b // m, s)
        mb_labels = labels.reshape(m, b // m, s)
        ticks = m + stages - 1
        dev = params.embed.device
        first = torch.tensor(stage == 0, device=dev)
        buf = torch.zeros((b // m, s, cfg.d_model), dtype=cfg.dtype, device=dev)
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        tok_sum = torch.zeros((), dtype=torch.float32, device=dev)
        aux_sum = torch.zeros((), dtype=torch.float32, device=dev)
        for t in range(ticks):
            injected = nn.functional.embedding(mb_tokens[min(t, m - 1)].long(), params.embed)
            x = torch.where(first, injected.to(cfg.dtype), buf)
            aux = torch.zeros((), dtype=torch.float32, device=dev)
            for blk in params.blocks:
                x = x + model_lib._mixer_apply(blk, apply_norm(x, blk.mixer_norm, cfg.norm), cfg)
                x, a = model_lib._ffn(blk, x, cfg)
                if a is not None:
                    aux = aux + a
            aux_sum = aux_sum + aux / ticks
            out = t - (stages - 1)
            if stage == stages - 1 and 0 <= out < m:
                lsum, ntok = self._head_loss(x, mb_labels[out])
                loss_sum, tok_sum = loss_sum + lsum, tok_sum + ntok
            if t < ticks - 1 and stages > 1:
                buf = _Rotate.apply(x, group, nxt, prv)
        # the last tick's output joins the graph with weight zero, so that
        # every rank's backward reaches each rotation (see the module doc)
        loss_sum = loss_sum + 0.0 * x.float().sum()
        loss_sum = _sum_across(loss_sum, group)
        tok_sum = _sum_across(tok_sum.detach(), group)
        aux_sum = _sum_across(aux_sum, group) / stages
        ce = loss_sum / torch.clamp(tok_sum, min=1.0)
        nm = model_lib.num_moe_layers(cfg)
        return ce + cfg.router_aux * aux_sum / nm if nm else ce

    def _head_loss(self, x, labels) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        x = apply_norm(x, self.model.final_norm, cfg.norm)
        logits = model_lib._head(self.model, x, cfg)
        labels = labels.long()
        mask = (labels >= 0).float()
        logz = torch.logsumexp(logits, dim=-1)
        tgt = torch.gather(logits, -1, labels.clamp(min=0)[..., None])[..., 0]
        return ((logz - tgt) * mask).sum(), mask.sum()


def pipeline_loss_fn(params: Dict, batch: Dict, cfg, *, stages: int, microbatches: int,
                     group=None) -> torch.Tensor:
    """This rank's pipelined loss: ``params`` is the reference's parameter
    tree (``models.model.param_tree``) whose ``periods`` leaves carry this
    stage's ``n_periods / stages`` slice, ``batch`` this rank's rows
    (``tokens``, ``labels``).  ``group`` is the pod axis's process group,
    whose rank is the stage (None: a single stage, no communication).
    Returns the masked cross entropy over every microbatch (``Σ nll / Σ
    mask``, summed over the stages), plus the router aux averaged over
    ticks and stages, as a float32 scalar equal on every stage."""
    _check_scope(cfg, stages)
    if group is not None and dist.get_world_size(group) != stages:
        raise ValueError(f"the pod group has {dist.get_world_size(group)} ranks, "
                         f"not {stages}")
    module = _Stage(cfg, stages)
    views = {f"model.{n}": t
             for n, t in model_lib.tree_views(params, _stage_cfg(cfg, stages)).items()}
    return torch.func.functional_call(
        module, views, (batch["tokens"], batch["labels"], microbatches, group))


def _stage_slice_specs(params_abs, mesh, policy, axis: str = "pod"):
    """Shardings for PP: periods' leading (depth) dim over ``axis``; other
    leaves follow the normal policy rules."""
    base = shd.param_specs(params_abs, policy)
    out = []
    for path, spec in tree_paths(base):
        if "periods" in shd._path_names(path):
            rest = tuple(spec.spec)[1:]
            # drop any use of ``axis`` elsewhere in the spec (depth owns it)
            rest = tuple(None if (a == axis or (isinstance(a, tuple) and axis in a)) else a
                         for a in rest)
            spec = shd.NamedSharding(mesh, shd.PartitionSpec(axis, *rest))
        out.append(spec)
    return tree_unflatten(base, out)


def make_pp_loss_for_mesh(cfg, mesh, policy, batch_abs, *, microbatches: int,
                          axis: str = "pod"):
    """The pipelined loss on ``mesh`` (a ``DeviceMesh`` with ``axis``; any
    other dim is data parallel) and its input shardings.

    Returns ``(fn(params, batch) -> scalar, (param_shardings,
    batch_shardings))``: ``params`` is the FULL model's parameter tree as
    DTensors placed by ``param_shardings`` (depth dim sharded over
    ``axis``: each stage stores only its slice; ``sharding.distribute_tree``
    places a full tree), ``batch`` DTensors by ``batch_shardings`` (rows
    over ``data``).  Each stage computes with its slice whole (the FSDP
    and tensor shards gathered), and the loss is averaged over the data
    shards.  Differentiable: the gradients land on ``params``' placements,
    summed as the module doc says.
    """
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    stages = mesh.size(names.index(axis))
    _check_scope(cfg, stages)
    # the pipeline owns ``axis``: batch parallelism must not use it
    policy = shd.ShardingPolicy(mesh, policy.rules.override(batch="data"))
    params_abs = model_lib.param_tree(model_lib.abstract_params(cfg), cfg)
    param_sh = _stage_slice_specs(params_abs, mesh, policy, axis)
    batch_sh = shd.batch_specs(batch_abs, policy)
    periods = [
        "periods" in shd._path_names(path) for path, _ in tree_paths(params_abs)]
    group = mesh.get_group(axis)
    data_group = mesh.get_group("data") if "data" in names else None

    def fn(params, batch):
        leaves = [x for _, x in tree_paths(params)]
        local = tree_unflatten(params, _StageSlices.apply(mesh, axis, periods, *leaves))
        rows = {k: v.redistribute(mesh, [Shard(0) if n == "data" else Replicate()
                                         for n in names]).to_local()
                for k, v in batch.items()}
        # constrain() must be inert per-shard: the stage holds plain tensors
        with shd.use_policy(None):
            loss = pipeline_loss_fn(local, rows, cfg, stages=stages,
                                    microbatches=microbatches, group=group)
        # mean over the data-parallel shards too
        if data_group is not None and dist.get_world_size(data_group) > 1:
            loss = _sum_across(loss, data_group) / dist.get_world_size(data_group)
        return loss

    return fn, (param_sh, batch_sh)

