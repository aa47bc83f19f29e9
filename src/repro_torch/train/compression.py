"""Int8 error-feedback gradient compression for the DP all-reduce (PyTorch
port of the JAX package's ``train/compression.py``).

Quantizing gradients to int8 cuts the data-parallel all-reduce's bytes 2x
(vs bf16) / 4x (vs fp32); **error feedback** (Seide et al. 2014) keeps SGD
convergence: the quantization residual is carried into the next step, so the
compression error telescopes instead of accumulating.

    e_t      : residual state (same tree as grads, fp32)
    c_t      = quantize(g_t + e_t)
    e_{t+1}  = (g_t + e_t) - dequantize(c_t)
    ĝ_t      = all_reduce(c_t) -> dequantize

Quantization is per-leaf symmetric int8 (scale = max|x| / 127).  On a mesh
the int8 payload is what crosses the wire — ``compressed_psum`` gathers it
over the named dims' process groups of a ``DeviceMesh``.  In the train step
the same math runs as a grad transform (quantize→dequantize with error
feedback), so convergence behaviour is testable off-mesh.
"""

from __future__ import annotations

import math
from typing import Any, Sequence, Tuple

import torch
import torch.distributed as dist

from ._tree import flatten_up_to, tree_leaves, tree_map, tree_unflatten

__all__ = [
    "init_error_state",
    "compress_decompress",
    "quantize_int8",
    "dequantize_int8",
    "compressed_psum",
]


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    xf = x.float()
    scale = torch.clamp(torch.max(torch.abs(xf)) / 127.0, min=1e-30)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_state(params) -> Any:
    return tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params
    )


def _per_leaf(one, grads, err):
    outs = [one(g, e) for g, e in zip(tree_leaves(grads), flatten_up_to(grads, err))]
    return (
        tree_unflatten(grads, [o[0] for o in outs]),
        tree_unflatten(grads, [o[1] for o in outs]),
    )


def compress_decompress(grads, err):
    """Error-feedback int8 round trip.  Returns (ĝ, new_err)."""

    def one(g, e):
        tot = g.float() + e
        q, scale = quantize_int8(tot)
        deq = dequantize_int8(q, scale)
        return deq.to(g.dtype), tot - deq

    return _per_leaf(one, grads, err)


def compressed_psum(grads, err, axis_names: Sequence[str], mesh):
    """The on-mesh form: int8 quantize -> **all-gather(int8)** -> local
    dequant-sum, with error feedback, over the process groups of ``mesh``'s
    dims ``axis_names`` (every rank of them calls it with its own grads).

    Why all-gather and not an all-reduce: summing int8 across P shards
    needs ≥ log2(127·P) bits, so an all-reduce would carry int32 on the
    wire — zero savings.  Gathering the int8 payloads and reducing locally
    moves ~n·(P−1)/P bytes per device vs ~2·n·2·(P−1)/P for a ring bf16
    all-reduce: **4× fewer wire bytes** (+ one fp32 scale per leaf).
    Intended for a scarce-link axis with P small, since the gather buffer
    is [P, n] int8.

    The per-shard scale is MAX-all-reduced so every shard dequantizes with
    a common factor; error feedback keeps convergence.
    """
    groups = [mesh.get_group(mesh_dim=a) for a in axis_names]
    sizes = [dist.get_world_size(g) for g in groups]
    nshards = math.prod(sizes)

    def one(g, e):
        tot = g.float() + e
        scale = torch.clamp(torch.max(torch.abs(tot)) / 127.0, min=1e-30)
        for grp in groups:
            dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=grp)
        q = torch.clamp(torch.round(tot / scale), -127, 127).to(torch.int8)
        gathered = q  # int8 on the wire, gathered over one dim at a time
        for grp, size in zip(groups, sizes):
            parts = [torch.empty_like(gathered) for _ in range(size)]
            dist.all_gather(parts, gathered, group=grp)
            gathered = torch.stack(parts)
        summed = torch.sum(gathered.reshape(nshards, *q.shape).float(), dim=0)
        deq_local = q.float() * scale
        mean = summed * scale / nshards
        return mean.to(g.dtype), tot - deq_local

    return _per_leaf(one, grads, err)
