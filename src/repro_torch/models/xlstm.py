"""xLSTM blocks: mLSTM (matrix memory, chunkwise-parallel) and sLSTM (scalar
memory, sequential), PyTorch port of the JAX package's ``models/xlstm.py``;
``xlstm-1.3b`` interleaves them 7:1.

mLSTM is linear attention with per-step scalar gates:

    C_t = f_t·C_{t-1} + i_t·(k_t v_tᵀ)      C ∈ [hd, hd]   (matrix memory)
    n_t = f_t·n_{t-1} + i_t·k_t
    h_t = (q_tᵀ C_t) / max(|q_tᵀ n_t|, 1)

The full-sequence pass uses the **chunkwise form**: inside a chunk,
quadratic attention with log-space decay ratios; between chunks, the
float32 state (C, n) carried by a loop.  Like the reference, it takes
lengths up to ``cfg.xlstm_chunk`` or multiples of it, and raises
``ValueError`` for any other (where the reference asserts).  sLSTM keeps
exponential gating with a scalar memory per unit; its recurrence, block-
diagonal per head, is a sequential loop over time (the blocks laid out as
one ``[d, 4d]`` matrix, so a step's recurrence is one product).  Decode is the O(1)
step of either.

As in the reference, the input gate is capped, ``exp(min(ĩ, 0))``, in place
of the max-tracking stabiliser, and the forget gates are sigmoids.  Nothing
here is a TPU kernel in the reference (its scans are XLA's), so all of it is
plain PyTorch.  Weights keep the reference's layouts and dtypes (matrices
in ``cfg.param_dtype``; ``conv_w [di, 4]``, ``conv_b``, ``w_gates``,
``gate_bias``, ``h_scale``, sLSTM's ``r [H, hd, 4·hd]`` and ``bias``
float32).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..sharding import constrain, on_rows
from .layers import dense_init, rms_norm
from .mamba import _causal_conv

__all__ = [
    "MLSTM",
    "SLSTM",
    "init_mlstm_cache",
    "init_slstm_cache",
    "mlstm_apply",
    "mlstm_decode",
    "mlstm_init",
    "slstm_apply",
    "slstm_decode",
    "slstm_init",
]


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

class MLSTM(nn.Module):
    """``w_up`` / ``w_z [d, di]``, ``wq`` / ``wk`` / ``wv [di, H, hd]``,
    ``w_gates [di, 2H]`` (input then forget), ``w_down [di, d]``."""

    def __init__(self, cfg, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        d, di = cfg.d_model, cfg.xlstm_d_inner
        h, hd, dt = cfg.n_heads, cfg.xlstm_head_dim, cfg.param_dtype
        if generator is not None:
            device = generator.device
        f32 = dict(dtype=torch.float32, device=device)
        self.w_up = dense_init(d, di, dt, generator, device=device)
        self.w_z = dense_init(d, di, dt, generator, device=device)
        self.conv_w = _param(dense_init(4, di, torch.float32, generator, device=device).data.T.contiguous())
        self.conv_b = _param(torch.zeros(di, **f32))
        self.wq = dense_init(di, (h, hd), dt, generator, device=device)
        self.wk = dense_init(di, (h, hd), dt, generator, device=device)
        self.wv = dense_init(di, (h, hd), dt, generator, device=device)
        self.w_gates = dense_init(di, 2 * h, torch.float32, generator, device=device)
        # forget gates biased open, the usual LSTM trick
        self.gate_bias = _param(torch.cat([torch.zeros(h, **f32), torch.full((h,), 3.0, **f32)]))
        self.h_scale = _param(torch.ones((h, hd), **f32))
        self.w_down = dense_init(di, d, dt, generator, device=device)


def mlstm_init(cfg, generator: Optional[torch.Generator] = None, device=None) -> MLSTM:
    return MLSTM(cfg, generator, device)


def _mlstm_qkvg(params: MLSTM, xn: torch.Tensor, cfg):
    """``(xu, z, q, k, v, gates)``: the up and gate projections, per-head q
    / k / v ``[B, S, H, hd]`` and the float32 gate pre-activations ``[B, S,
    2H]`` (input, then forget; :func:`_gate_values` takes them)."""
    # xu whole along d_inner under a policy: the heads cannot split over an
    # axis that does not divide them (z stays split, as its product is)
    xu = constrain(xn @ params.w_up, ("batch", "seq", None))
    z = xn @ params.w_z
    # the causal conv on each rank's batch rows (DTensor's pad along the
    # sequence fails to redistribute on some torch versions)
    xc = on_rows(_conv_silu, xu, params.conv_w, params.conv_b, whole=(1, 2))
    wq, wk, wv = (_heads(w) for w in (params.wq, params.wk, params.wv))
    q = torch.einsum("bse,ehd->bshd", xc, wq)
    k = torch.einsum("bse,ehd->bshd", xc, wk) * cfg.xlstm_head_dim**-0.5
    v = torch.einsum("bse,ehd->bshd", xu, wv)
    gates = xc.float() @ params.w_gates + params.gate_bias
    return xu, z, q, k, v, gates


def _heads(w: torch.Tensor) -> torch.Tensor:
    """A ``[di, H, hd]`` head projection gathered along ``di`` (FSDP's gather
    before use), its heads split as the policy says; no-op without one."""
    return constrain(w, (None, "heads", "head_dim"))


def _conv_silu(x, w, b):
    return F.silu(_causal_conv(x, w, b))


def _gate_values(gates: torch.Tensor):
    """``(i_gate, log_f)`` ``[B, S, H]`` of the pre-activations ``[B, S,
    2H]``: the capped input gate, in (0, 1], and the log decay, < 0."""
    h = gates.shape[-1] // 2
    return torch.exp(torch.clamp(gates[..., :h], max=0.0)), F.logsigmoid(gates[..., h:])


def _mlstm_chunk(q, k, v, ig, lf, s_state, n_state):
    """One chunk of the chunkwise form: q / k / v ``[B, C, H, hd]`` float32,
    gates ``[B, C, H]``, carried state ``S [B, H, hd, hd]`` and ``n [B, H,
    hd]``.  Returns (h ``[B, C, H, hd]``, S', n')."""
    c = q.shape[1]
    cum = torch.cumsum(lf, dim=1)  # [B, C, H] inclusive log-decay
    # intra-chunk: scores(t, τ) = q_t·k_τ · exp(cum_t − cum_τ) · i_τ, τ ≤ t
    qk = torch.einsum("bthd,bshd->bhts", q, k)
    cum_h = cum.transpose(1, 2)  # [B, H, C]
    ratio = cum_h[..., :, None] - cum_h[..., None, :]
    causal = torch.ones((c, c), dtype=torch.bool, device=q.device).tril()
    decay = torch.where(causal, torch.exp(ratio), 0.0)
    scores = qk * decay * ig.transpose(1, 2)[:, :, None, :]
    num_intra = torch.einsum("bhts,bshd->bthd", scores, v)
    den_intra = scores.sum(dim=-1).transpose(1, 2)  # [B, C, H]
    # inter-chunk: the carried state scaled by exp(cum_t)
    et = torch.exp(cum)
    num_inter = torch.einsum("bthd,bhde->bthe", q, s_state) * et[..., None]
    den_inter = torch.einsum("bthd,bhd->bth", q, n_state) * et
    den = torch.clamp((den_intra + den_inter).abs(), min=1.0)
    h = (num_intra + num_inter) / den[..., None]
    # state update: S' = exp(tot)·S + Σ_τ exp(tot − cum_τ)·i_τ·k_τ v_τᵀ
    tot = cum[:, -1]  # [B, H]
    w_tau = torch.exp(tot[:, None] - cum) * ig  # [B, C, H]
    kw = k * w_tau[..., None]
    s_new = torch.exp(tot)[..., None, None] * s_state + torch.einsum("bshd,bshe->bhde", kw, v)
    n_new = torch.exp(tot)[..., None] * n_state + kw.sum(dim=1)
    return h, s_new, n_new


def _mlstm_scan(q, k, v, gates, *, c: int):
    """The chunkwise form over whole sequences (q / k / v ``[B, S, H, hd]``
    float32, gate pre-activations ``[B, S, 2H]``) from a zero state, ``c``
    tokens a chunk: ``(h [B, S, H, hd], S, n)``."""
    b, s, hn, hd = q.shape
    ig, lf = _gate_values(gates)
    s_state = torch.zeros((b, hn, hd, hd), dtype=torch.float32, device=q.device)
    n_state = torch.zeros((b, hn, hd), dtype=torch.float32, device=q.device)
    hs = []
    for t in range(0, s, c):
        h, s_state, n_state = _mlstm_chunk(
            q[:, t : t + c], k[:, t : t + c], v[:, t : t + c],
            ig[:, t : t + c], lf[:, t : t + c], s_state, n_state)
        hs.append(h)
    return torch.cat(hs, dim=1), s_state, n_state


def mlstm_apply(params: MLSTM, x: torch.Tensor, cfg, return_state: bool = False):
    """Chunkwise-parallel forward: x ``[B, S, d]`` (pre-normed) → ``[B, S,
    d]`` (and, with ``return_state``, the decode cache ``{"conv": [B, 3,
    di]`` in ``cfg.dtype``, ``"S"``, ``"n"`` float32``}``)."""
    b, s, _ = x.shape
    hn, hd = cfg.n_heads, cfg.xlstm_head_dim
    c = min(cfg.xlstm_chunk, s)
    if s % c:
        raise ValueError(
            f"mLSTM over {s} tokens: the length must be at most xlstm_chunk "
            f"({cfg.xlstm_chunk}) or a multiple of it, as in the reference")

    xu, z, q, k, v, gates = _mlstm_qkvg(params, x, cfg)
    # the gates and the chunk loop on each rank's batch rows
    h, s_state, n_state = on_rows(functools.partial(_mlstm_scan, c=c), q.float(), k.float(),
                                  v.float(), gates, outputs=3)
    h = rms_norm(h, params.h_scale).reshape(b, s, hn * hd)
    # whole along the heads under a policy, its gradient too: the flat
    # heads cannot be split over an axis that does not divide them
    h = constrain(h, ("batch", "seq", None))
    out = (h.to(x.dtype) * F.silu(z)) @ params.w_down
    if not return_state:
        return out
    return out, {"conv": xu[:, -3:].to(cfg.dtype), "S": s_state, "n": n_state}


def init_mlstm_cache(cfg, batch: int, device=None) -> dict:
    hn, hd = cfg.n_heads, cfg.xlstm_head_dim
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "conv": torch.zeros((batch, 3, cfg.xlstm_d_inner), dtype=cfg.dtype, device=device),
        "S": torch.zeros((batch, hn, hd, hd), **f32),
        "n": torch.zeros((batch, hn, hd), **f32),
    }


def mlstm_decode(params: MLSTM, x: torch.Tensor, cache: dict, cfg) -> Tuple[torch.Tensor, dict]:
    """One step: x ``[B, 1, d]`` → (``[B, 1, d]``, new cache)."""
    b = x.shape[0]
    hn, hd = cfg.n_heads, cfg.xlstm_head_dim
    xu = constrain(x @ params.w_up, ("batch", None, None))
    z = x @ params.w_z
    window = torch.cat([cache["conv"], xu.to(cfg.dtype)], dim=1)
    conv = torch.einsum("bki,ik->bi", window.float(), params.conv_w)
    xc = F.silu(conv + params.conv_b).to(x.dtype)[:, None, :]
    q = torch.einsum("bse,ehd->bshd", xc, _heads(params.wq))[:, 0].float()
    k = (torch.einsum("bse,ehd->bshd", xc, _heads(params.wk))[:, 0] * hd**-0.5).float()
    v = torch.einsum("bse,ehd->bshd", xu, _heads(params.wv))[:, 0].float()
    gates = xc[:, 0].float() @ params.w_gates + params.gate_bias
    i_g = torch.exp(torch.clamp(gates[:, :hn], max=0.0))[..., None]
    f_g = torch.sigmoid(gates[:, hn:])[..., None]
    s_new = f_g[..., None] * cache["S"] + i_g[..., None] * (k[..., :, None] * v[..., None, :])
    n_new = f_g * cache["n"] + i_g * k
    num = torch.einsum("bhd,bhde->bhe", q, s_new)
    den = torch.clamp(torch.einsum("bhd,bhd->bh", q, n_new).abs(), min=1.0)
    h = (num / den[..., None]).reshape(b, 1, hn, hd)
    h = rms_norm(h, params.h_scale).reshape(b, 1, hn * hd)
    out = (h.to(x.dtype) * F.silu(z)) @ params.w_down
    return out, {"conv": window[:, 1:], "S": s_new, "n": n_new}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

class SLSTM(nn.Module):
    """``w_in [d, 4d]`` (z, i, f, o), block-diagonal recurrent ``r [H, hd,
    4·hd]`` float32 (hd = d / H), ``bias [4d]``, ``w_out [d, d]``."""

    def __init__(self, cfg, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        d, hn, dt = cfg.d_model, cfg.n_heads, cfg.param_dtype
        hd = d // hn
        if generator is not None:
            device = generator.device
        f32 = dict(dtype=torch.float32, device=device)
        self.w_in = dense_init(d, 4 * d, dt, generator, device=device)
        r = dense_init(hd, (hn, 4 * hd), torch.float32, generator, device=device)
        self.r = _param(r.data.permute(1, 0, 2).contiguous())
        self.bias = _param(torch.cat([
            torch.zeros(2 * d, **f32), torch.full((d,), 3.0, **f32),  # forget bias
            torch.zeros(d, **f32)]))
        self.h_scale = _param(torch.ones((hn, hd), **f32))
        self.w_out = dense_init(d, d, dt, generator, device=device)


def slstm_init(cfg, generator: Optional[torch.Generator] = None, device=None) -> SLSTM:
    return SLSTM(cfg, generator, device)


def _recurrence(params: SLSTM) -> torch.Tensor:
    """The block-diagonal ``r [H, hd, 4·hd]`` as one ``[d, 4d]`` matrix, so
    that a step's recurrence lands in the reference's flat gate layout
    (head-major ``[B, H·4·hd]``) in one product with its input.  Each
    head's block is selected into its place on the diagonal, zeros
    elsewhere: ``torch.block_diag(*r)`` bitwise, from ops that DTensor has
    rules for (``block_diag`` has none); whole on every rank under a
    policy, as the recurrence runs (:func:`_scan`)."""
    r = constrain(params.r, (None, None, None))
    hn, hd, w = r.shape
    diag = torch.eye(hn, dtype=torch.bool, device=r.device)[:, None, :, None]
    return torch.where(diag, r[:, :, None, :], 0.0).reshape(hn * hd, hn * w)


def _slstm_cell(rmat: torch.Tensor, pre_t: torch.Tensor, state):
    """One recurrence step.  ``pre_t [B, 4d]`` float32 is the step's input
    projection plus the bias, ``rmat`` the :func:`_recurrence` matrix;
    ``state`` is (h, c, n), each ``[B, H, hd]``."""
    h_prev, c_prev, n_prev = state
    b, hn, hd = h_prev.shape
    g = torch.addmm(pre_t, h_prev.reshape(b, hn * hd), rmat).view(b, 4, hn, hd)
    z = torch.tanh(g[:, 0])
    i = torch.exp(torch.clamp(g[:, 1], max=0.0))
    fo = torch.sigmoid(g[:, 2:])
    c = torch.addcmul(fo[:, 0] * c_prev, i, z)
    n = torch.addcmul(i, fo[:, 0], n_prev)
    h = fo[:, 1] * c / torch.clamp(n, min=1.0)
    return h, c, n


def _scan(pre: torch.Tensor, rmat: torch.Tensor, *state, hn: int):
    """The recurrence over ``pre [B, S, 4d]`` (float32) from ``state`` (h,
    c, n, each ``[B, H, hd]``; zeros when not given): ``(hs [B, S, H, hd],
    h, c, n)``."""
    b, s, four_d = pre.shape
    hd = four_d // (4 * hn)
    if not state:
        state = tuple(torch.zeros((b, hn, hd), dtype=torch.float32, device=pre.device)
                      for _ in range(3))
    hs = []
    for t in range(s):
        state = _slstm_cell(rmat, pre[:, t], state)
        hs.append(state[0])
    return (torch.stack(hs, dim=1),) + tuple(state)


def slstm_apply(params: SLSTM, x: torch.Tensor, cfg, return_state: bool = False):
    """Sequential forward: x ``[B, S, d]`` (pre-normed) → ``[B, S, d]`` (and,
    with ``return_state``, the cache ``{"h", "c", "n"}``, float32 ``[B, H,
    hd]``).  One step a token, eleven ops a step."""
    b, s, d = x.shape
    hn = cfg.n_heads
    pre = (x @ constrain(params.w_in, (None, None))).float() + params.bias  # [B, S, 4d]
    # on each rank's batch rows, the matrix whole on every rank
    hs, h_f, c_f, n_f = on_rows(functools.partial(_scan, hn=hn), pre, _recurrence(params),
                                outputs=4, whole=(1,))
    h = rms_norm(hs, params.h_scale).reshape(b, s, d)
    out = h.to(x.dtype) @ constrain(params.w_out, (None, None))
    if not return_state:
        return out
    return out, {"h": h_f, "c": c_f, "n": n_f}


def init_slstm_cache(cfg, batch: int, device=None) -> dict:
    hn = cfg.n_heads
    hd = cfg.d_model // hn
    return {
        name: torch.zeros((batch, hn, hd), dtype=torch.float32, device=device)
        for name in ("h", "c", "n")
    }


def slstm_decode(params: SLSTM, x: torch.Tensor, cache: dict, cfg) -> Tuple[torch.Tensor, dict]:
    """One step: x ``[B, 1, d]`` → (``[B, 1, d]``, new cache)."""
    b, _, d = x.shape
    pre = (x @ constrain(params.w_in, (None, None))).float() + params.bias  # [B, 1, 4d]
    _, h, c, n = on_rows(functools.partial(_scan, hn=cfg.n_heads), pre, _recurrence(params),
                         cache["h"], cache["c"], cache["n"], outputs=4, whole=(1,))
    hh = rms_norm(h, params.h_scale).reshape(b, 1, d)
    return hh.to(x.dtype) @ constrain(params.w_out, (None, None)), {"h": h, "c": c, "n": n}
