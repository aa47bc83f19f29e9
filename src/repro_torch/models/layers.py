"""Shared neural layers for the LM architectures (PyTorch port).

Mirrors the JAX package's ``models/layers.py``: the same functions with the
same names and arithmetic, and ``nn.Module`` containers for the weights.
Weights keep the JAX layouts (``[in, *out]``) so a converted parameter tree
loads leaf for leaf, and are drawn from an explicit ``torch.Generator``
(2-sigma truncated normals, fan-in scaled, as the reference's
``truncated_normal``); a module built with ``generator=None`` holds
uninitialised weights for ``repro_torch.convert.params_from_jax`` to fill.

Dtype policy: weights are created in ``cfg.param_dtype``; norms and rotary
tables compute in float32 and cast back to the activation dtype.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..sharding import constrain

__all__ = [
    "MLP",
    "Norm",
    "apply_norm",
    "apply_rotary",
    "dense_init",
    "embed_init",
    "layer_norm",
    "mlp_apply",
    "rms_norm",
    "rotary_embedding",
    "sinusoidal_positions",
    "truncated_normal",
]


def truncated_normal(
    shape: Sequence[int],
    dtype: torch.dtype,
    stddev: float,
    generator: Optional[torch.Generator],
    device=None,
) -> nn.Parameter:
    """A weight of ``shape``: a normal of ``stddev`` truncated at ±2σ, drawn
    in float32 on the generator's device and cast to ``dtype``; left
    uninitialised (on ``device``) when ``generator`` is None."""
    if generator is None:
        return nn.Parameter(
            torch.empty(tuple(shape), dtype=dtype, device=device),
            requires_grad=False,
        )
    t = torch.empty(tuple(shape), dtype=torch.float32, device=generator.device)
    nn.init.trunc_normal_(
        t, std=stddev, a=-2.0 * stddev, b=2.0 * stddev, generator=generator
    )
    return nn.Parameter(t.to(dtype), requires_grad=False)


def dense_init(
    in_dim: int,
    out_shape: Union[int, Sequence[int]],
    dtype: torch.dtype,
    generator: Optional[torch.Generator],
    scale: Optional[float] = None,
    device=None,
) -> nn.Parameter:
    """Weight ``[in_dim, *out_shape]``; fan-in scaled init."""
    if isinstance(out_shape, int):
        out_shape = (out_shape,)
    stddev = scale if scale is not None else in_dim**-0.5
    return truncated_normal((in_dim, *out_shape), dtype, stddev, generator, device)


def embed_init(vocab: int, dim: int, dtype, generator, device=None) -> nn.Parameter:
    return truncated_normal((vocab, dim), dtype, 0.02, generator, device)


class Norm(nn.Module):
    """``rms`` / ``ln`` carry a float32 scale (+ bias); ``np_ln`` (OLMo) is
    parameter-free."""

    def __init__(self, dim: int, kind: str, device=None) -> None:
        super().__init__()
        if kind not in ("rms", "ln", "np_ln"):
            raise ValueError(f"unknown norm kind {kind}")
        self.kind = kind
        if kind in ("rms", "ln"):
            self.scale = nn.Parameter(
                torch.ones(dim, dtype=torch.float32, device=device),
                requires_grad=False,
            )
        if kind == "ln":
            self.bias = nn.Parameter(
                torch.zeros(dim, dtype=torch.float32, device=device),
                requires_grad=False,
            )


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale).to(x.dtype)


def layer_norm(
    x: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    eps: float = 1e-5,
) -> torch.Tensor:
    xf = x.float()
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    out = (xf - mean) * torch.rsqrt(var + eps)
    if scale is not None:
        out = out * scale
    if bias is not None:
        out = out + bias
    return out.to(x.dtype)


def apply_norm(x: torch.Tensor, params: Norm, kind: str) -> torch.Tensor:
    if kind == "rms":
        return rms_norm(x, params.scale)
    if kind == "ln":
        return layer_norm(x, params.scale, params.bias)
    if kind == "np_ln":
        return layer_norm(x)  # OLMo's non-parametric LayerNorm
    raise ValueError(f"unknown norm kind {kind}")


# ---------------------------------------------------------------------------
# MLP: SwiGLU (llama family) or GELU (whisper / gpt-bigcode family)
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """``w_gate`` / ``w_up`` ``[d_model, d_ff]`` (no gate for GELU),
    ``w_down`` ``[d_ff, d_model]``."""

    def __init__(
        self,
        d_model: int,
        d_ff: int,
        kind: str,
        dtype: torch.dtype,
        generator: Optional[torch.Generator] = None,
        device=None,
    ) -> None:
        super().__init__()
        if kind not in ("swiglu", "gelu"):
            raise ValueError(f"unknown mlp kind {kind}")
        self.kind = kind
        if kind == "swiglu":
            self.w_gate = dense_init(d_model, d_ff, dtype, generator, device=device)
        self.w_up = dense_init(d_model, d_ff, dtype, generator, device=device)
        self.w_down = dense_init(d_ff, d_model, dtype, generator, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp_apply(self, x, self.kind)


def mlp_apply(params: MLP, x: torch.Tensor, kind: str) -> torch.Tensor:
    """``x [..., d]`` → ``[..., d]``.  Under a sharding policy the weights
    are placed as the rules split them: gate and up column-split over
    ``ffn`` and down row-split, each gathered along ``d`` alone (FSDP's
    gather), so each rank multiplies its own ``d_ff`` slice of ``x``'s rows
    and the caller's placement of the output is the one reduction over
    ``ffn``'s axis (no-ops without a policy)."""

    def col(w):
        return constrain(w, (None, "ffn"))

    if kind == "swiglu":
        h = F.silu(x @ col(params.w_gate)) * (x @ col(params.w_up))
    elif kind == "gelu":
        # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(x @ col(params.w_up), approximate="tanh")
    else:
        raise ValueError(f"unknown mlp kind {kind}")
    return h @ constrain(params.w_down, ("ffn", None))


# ---------------------------------------------------------------------------
# Positions: RoPE and sinusoidal
# ---------------------------------------------------------------------------

def rotary_embedding(positions: torch.Tensor, head_dim: int, theta: float = 10000.0):
    """cos/sin tables ``[*, head_dim/2]`` (float32) for integer ``positions``."""
    half = head_dim // 2
    exponent = -torch.arange(half, dtype=torch.float32, device=positions.device) / half
    freqs = theta**exponent
    angles = positions.float()[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x ``[B, S, H, D]``; cos/sin ``[B, S, D/2]``.  Half-split layout: the
    first and second halves of each head are the rotated pairs."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    return torch.cat([out1, out2], dim=-1).to(x.dtype)


def sinusoidal_positions(num: int, dim: int) -> np.ndarray:
    """Classic transformer sinusoids [num, dim] (whisper-style stub)."""
    pos = np.arange(num)[:, None]
    div = np.exp(-np.log(10000.0) * np.arange(0, dim, 2) / dim)
    table = np.zeros((num, dim), dtype=np.float32)
    table[:, 0::2] = np.sin(pos * div)
    table[:, 1::2] = np.cos(pos * div)
    return table
