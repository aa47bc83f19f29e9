"""Mamba (S6) selective-state-space block — jamba's sequence mixer (PyTorch
port of the JAX package's ``models/mamba.py``).

in_proj → causal depthwise conv(K) → selective SSM → gated out_proj, with
the recurrence

    h_t = exp(dt_t · A) ⊙ h_{t-1} + (dt_t · B_t) x_t        h ∈ [d_inner, N]
    y_t = h_t · C_t + D ⊙ x_t

The full-sequence pass is **chunked**: a loop over chunks of
``cfg.mamba_chunk`` tokens carries (h, the conv tail), and inside a chunk
the recurrence is an inclusive scan of (a, b) pairs composed as (a2·a1,
a2·b1 + b2), the reference's ``_combine``, in log2(chunk) doubling steps.
So the working set is ``[B, chunk, d_inner, N]`` whatever the length.  The
reference falls back to one chunk of the whole sequence when the length is
not a multiple of the chunk (``[B, S, d_inner, N]`` float32 tensors); the
port takes a shorter last chunk instead, with the same outputs.  Decode is
the O(1) step carrying (conv window, h).

Nothing here is a TPU kernel in the reference (its scan is XLA's), so all of
it is plain PyTorch.  Weights keep the reference's layouts and dtypes:
``in_proj [d, 2·di]``, ``x_proj [di, r + 2N]``, ``dt_proj [r, di]``,
``out_proj [di, d]`` in ``cfg.param_dtype``; ``conv_w [di, K]``,
``conv_b``, ``dt_bias``, ``D [di]`` and ``A_log [di, N]`` float32.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import dense_init

__all__ = [
    "Mamba",
    "init_mamba_cache",
    "mamba_apply",
    "mamba_decode",
    "mamba_init",
]


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Mamba(nn.Module):
    """The weights of one Mamba mixer (S4D-real ``A``; ``dt_bias`` the
    inverse softplus of a log-uniform dt in [1e-3, 0.1])."""

    def __init__(self, cfg, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        d, di, n = cfg.d_model, cfg.mamba_d_inner, cfg.mamba_d_state
        r, kk, dt = cfg.mamba_dt_rank, cfg.mamba_d_conv, cfg.param_dtype
        if generator is not None:
            device = generator.device
        f32 = dict(dtype=torch.float32, device=device)
        self.in_proj = dense_init(d, 2 * di, dt, generator, device=device)
        self.conv_w = _param(dense_init(kk, di, torch.float32, generator, device=device).data.T.contiguous())
        self.conv_b = _param(torch.zeros(di, **f32))
        self.x_proj = dense_init(di, r + 2 * n, dt, generator, device=device)
        self.dt_proj = dense_init(r, di, dt, generator, device=device)
        if generator is None:
            self.dt_bias = _param(torch.empty(di, **f32))
        else:
            u = torch.rand(di, generator=generator, **f32)
            dt0 = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
            self.dt_bias = _param(dt0 + torch.log(-torch.expm1(-dt0)))
        self.A_log = _param(torch.log(torch.arange(1, n + 1, **f32)).repeat(di, 1))
        self.D = _param(torch.ones(di, **f32))
        self.out_proj = dense_init(di, d, dt, generator, device=device)


def mamba_init(cfg, generator: Optional[torch.Generator] = None, device=None) -> Mamba:
    return Mamba(cfg, generator, device)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: x ``[B, S, di]``, w ``[di, K]`` → ``[B, S, di]``
    (float32 sums of the K shifted inputs, cast back to x's dtype)."""
    k, s = w.shape[1], x.shape[1]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(k):
        out = out + pad[:, i : i + s].float() * w[:, i]
    return (out + b).to(x.dtype)


def _ssm_inputs(params: Mamba, xc: torch.Tensor, cfg):
    """Per-step ``(dA, dBx, C)``: ``[B, S, di, N]`` float32 decays and
    inputs, and ``C [B, S, N]`` in xc's dtype."""
    n, r = cfg.mamba_d_state, cfg.mamba_dt_rank
    x_dbl = xc @ params.x_proj
    dt_r, b_ssm, c_ssm = torch.split(x_dbl, [r, n, n], dim=-1)
    dt = F.softplus((dt_r @ params.dt_proj).float() + params.dt_bias)  # [B, S, di]
    a = -torch.exp(params.A_log)  # [di, N]
    da = torch.exp(dt[..., None] * a)
    dbx = dt[..., None] * b_ssm[..., None, :].float() * xc[..., None].float()
    return da, dbx, c_ssm


def _scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of ``h_t = a_t · h_{t-1} + b_t`` along dim 1 (h before
    the first step folded into ``b_0``): (a, b) pairs composed as (a2·a1,
    a2·b1 + b2) at doubling offsets."""
    off, c = 1, a.shape[1]
    while off < c:
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]], dim=1)
        if 2 * off < c:
            a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return b


def _chunk(params: Mamba, x_c: torch.Tensor, h: torch.Tensor, tail: torch.Tensor, cfg):
    """One chunk: x_c ``[B, C, d]``, carried state ``h [B, di, N]`` and conv
    tail ``[B, K-1, di]`` → (out ``[B, C, d]``, h, tail).  Its ``[B, C, di,
    N]`` temporaries die with the call."""
    di, kk = cfg.mamba_d_inner, cfg.mamba_d_conv
    xz = x_c @ params.in_proj
    xi, z = xz[..., :di], xz[..., di:]
    halo = torch.cat([tail, xi], dim=1)  # [B, C+K-1, di]
    conv = _causal_conv(halo, params.conv_w, params.conv_b)
    xc = F.silu(conv[:, kk - 1 :])
    da, dbx, c_ssm = _ssm_inputs(params, xc, cfg)
    # fold the carried-in state into the first step: h_0 = a_0·h_in + b_0
    dbx = torch.cat([da[:, :1] * h[:, None] + dbx[:, :1], dbx[:, 1:]], dim=1)
    hs = _scan(da, dbx)  # [B, C, di, N]
    y = torch.einsum("bsin,bsn->bsi", hs, c_ssm.float())
    y = y + params.D * xc.float()
    y = y.to(x_c.dtype) * F.silu(z)
    new_tail = halo[:, -(kk - 1) :] if kk > 1 else tail
    return y @ params.out_proj, hs[:, -1].clone(), new_tail


def mamba_apply(params: Mamba, x: torch.Tensor, cfg, return_state: bool = False):
    """Full-sequence forward: x ``[B, S, d]`` → ``[B, S, d]`` (and, with
    ``return_state``, the decode cache ``{"conv": [B, K-1, di]`` in
    ``cfg.dtype``, ``"h": [B, di, N]`` float32``}``).  Any length: chunks
    of ``cfg.mamba_chunk`` tokens, the last one shorter if need be."""
    b, s, _ = x.shape
    di, kk, n = cfg.mamba_d_inner, cfg.mamba_d_conv, cfg.mamba_d_state
    h = torch.zeros((b, di, n), dtype=torch.float32, device=x.device)
    tail = torch.zeros((b, kk - 1, di), dtype=x.dtype, device=x.device)
    outs = []
    for start in range(0, s, cfg.mamba_chunk):
        out_c, h, tail = _chunk(params, x[:, start : start + cfg.mamba_chunk], h, tail, cfg)
        outs.append(out_c)
    out = torch.cat(outs, dim=1)
    if not return_state:
        return out
    return out, {"conv": tail.to(cfg.dtype), "h": h}


# ---------------------------------------------------------------------------
# Decode path: O(1) per token
# ---------------------------------------------------------------------------

def init_mamba_cache(cfg, batch: int, device=None) -> dict:
    di, n, kk = cfg.mamba_d_inner, cfg.mamba_d_state, cfg.mamba_d_conv
    return {
        "conv": torch.zeros((batch, kk - 1, di), dtype=cfg.dtype, device=device),
        "h": torch.zeros((batch, di, n), dtype=torch.float32, device=device),
    }


def mamba_decode(params: Mamba, x: torch.Tensor, cache: dict, cfg) -> Tuple[torch.Tensor, dict]:
    """One step: x ``[B, 1, d]`` → (``[B, 1, d]``, new cache)."""
    di = cfg.mamba_d_inner
    xz = x @ params.in_proj
    xi, z = xz[..., :di], xz[..., di:]
    window = torch.cat([cache["conv"], xi.to(cfg.dtype)], dim=1)
    conv = torch.einsum("bki,ik->bi", window.float(), params.conv_w)
    xc = F.silu(conv + params.conv_b).to(x.dtype)[:, None, :]
    da, dbx, c_ssm = _ssm_inputs(params, xc, cfg)
    h = da[:, 0] * cache["h"] + dbx[:, 0]  # [B, di, N]
    y = torch.einsum("bin,bn->bi", h, c_ssm[:, 0].float())
    y = y + params.D * xc[:, 0].float()
    y = y[:, None, :].to(x.dtype) * F.silu(z)
    return y @ params.out_proj, {"conv": window[:, 1:], "h": h}
