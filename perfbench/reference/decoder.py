"""Plain float32 reference of the decoders the benchmark runs: Llama-style
blocks (RMSNorm, RoPE, grouped-query causal attention, SwiGLU) with a dense
feed-forward or a routed mixture of experts with shared experts.

It follows the published architecture in the semantics each configuration
file states under ``as_run`` (norm epsilon, RoPE base, gates renormalised,
shared experts ungated, capacity routing), reads the weights by the names
the file lists under ``weights`` (layer ``i`` is index ``i`` of each
``periods.b0`` leaf), and uses no kernel, cache or batching of the port:
every product is a float32 ``torch`` matmul with TF32 off (:func:`strict`).

``mode="fp8"`` is the control: each projection's operands rounded to
float8 e4m3 (weights per output column, activations per row, each scaled
by its largest magnitude) and, under autograd, the gradients the backward
multiplies rounded to float8 e5m2 in the same way; the products still sum
in float32.  Router, attention scores and softmax stay float32.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


@contextlib.contextmanager
def strict():
    """float32 products in float32: TF32 off for matmuls and cuDNN."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def _round8(x: torch.Tensor, dim: int, fmt) -> torch.Tensor:
    """``x`` rounded to the float8 format ``fmt`` with one scale per slice
    along ``dim`` (its largest magnitude at the format's largest value)."""
    top = E4M3_MAX if fmt == torch.float8_e4m3fn else E5M2_MAX
    scale = x.detach().abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / top
    return (x / scale).to(fmt).float() * scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        xq = _round8(x, 1, torch.float8_e4m3fn)
        wq = _round8(w, 0, torch.float8_e4m3fn)
        ctx.save_for_backward(xq, wq)
        return xq @ wq

    @staticmethod
    def backward(ctx, gy):
        xq, wq = ctx.saved_tensors
        gx = _round8(gy, 1, torch.float8_e5m2) @ wq.T
        gw = xq.T @ _round8(gy, 0, torch.float8_e5m2)
        return gx, gw


class Decoder:
    """The reference model of one configuration file over ``weights``
    (``{name: tensor}`` as listed there, any dtype; read as float32)."""

    def __init__(self, config: dict, weights: Dict[str, torch.Tensor], mode: str = "fp32"):
        if mode not in ("fp32", "fp8"):
            raise ValueError(f"unknown mode {mode!r}")
        self.c = config
        self.w = weights
        self.mode = mode
        run = config.get("as_run", {})
        self.eps = float(run.get("rms_norm_eps", config["rms_norm_eps"]))
        self.theta = float(run.get("rope_theta", config["rope_theta"]))
        self.d = config["hidden_size"]
        self.h = config["num_attention_heads"]
        self.kh = config["num_key_value_heads"]
        self.hd = config["head_dim"]
        self.layers = config["num_hidden_layers"]
        self.vocab = config["vocab_size"]
        self.experts = config.get("num_experts", 0)
        self.topk = config.get("num_experts_per_tok", 0)
        self.renorm = bool(run.get("norm_topk_prob", config.get("norm_topk_prob", True)))

    # -- pieces -------------------------------------------------------------
    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``x [..., k] @ w [k, n]`` in float32 (or the fp8 control)."""
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])
        y = _Fp8Matmul.apply(x2, w) if self.mode == "fp8" else x2 @ w
        return y.reshape(*lead, w.shape[-1])

    def leaf(self, name: str, layer: Optional[int] = None, params=None) -> torch.Tensor:
        t = (params or self.w)[name]
        t = t if layer is None else t[layer]
        return t.float()

    def norm(self, x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + self.eps) * scale

    def rope(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """x ``[..., S, heads, hd]``, pos ``[..., S]``: half-split rotation."""
        half = self.hd // 2
        freqs = self.theta ** (-torch.arange(half, dtype=torch.float64, device=x.device) / half)
        ang = (pos.double()[..., None] * freqs).float()
        cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def qkv(self, h: torch.Tensor, layer: int, pos: torch.Tensor, params=None):
        d = self.d
        q = self.mm(h, self.leaf("periods.b0.mixer.wq", layer, params).reshape(d, -1))
        k = self.mm(h, self.leaf("periods.b0.mixer.wk", layer, params).reshape(d, -1))
        v = self.mm(h, self.leaf("periods.b0.mixer.wv", layer, params).reshape(d, -1))
        q = q.reshape(*h.shape[:-1], self.h, self.hd)
        k = k.reshape(*h.shape[:-1], self.kh, self.hd)
        v = v.reshape(*h.shape[:-1], self.kh, self.hd)
        return self.rope(q, pos), self.rope(k, pos), v

    def attend(self, q, k, v, qpos, kpos, q_block: int = 1024) -> torch.Tensor:
        """One sequence: q ``[Sq, H, hd]``, k / v ``[Sk, KH, hd]`` with
        ascending ``kpos``; key j is visible to query i where ``kpos[j] <=
        qpos[i]``.  ``[Sq, H*hd]``."""
        g = self.h // self.kh
        kx = k.repeat_interleave(g, dim=1).transpose(0, 1)  # [H, Sk, hd]
        vx = v.repeat_interleave(g, dim=1).transpose(0, 1)
        outs = []
        for i in range(0, q.shape[0], q_block):
            qp = qpos[i:i + q_block]
            # keys come in ascending positions: those past the block's last
            # query are masked for all of it, and left out
            n = int(torch.searchsorted(kpos, qp.max(), right=True))
            qb = q[i:i + q_block].transpose(0, 1)  # [H, qb, hd]
            s = torch.matmul(qb, kx[:, :n].transpose(1, 2)) * self.hd ** -0.5
            mask = kpos[None, None, :n] <= qp[None, :, None]
            p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
            outs.append(torch.matmul(p, vx[:, :n]).transpose(0, 1).reshape(-1, self.h * self.hd))
        return torch.cat(outs, 0)

    def out_proj(self, o: torch.Tensor, layer: int, params=None) -> torch.Tensor:
        return self.mm(o, self.leaf("periods.b0.mixer.wo", layer, params).reshape(-1, self.d))

    def swiglu(self, x, w_gate, w_up, w_down) -> torch.Tensor:
        return self.mm(torch.nn.functional.silu(self.mm(x, w_gate)) * self.mm(x, w_up), w_down)

    def ffn(self, x: torch.Tensor, layer: int, capacity: Optional[int] = None,
            params=None, forced=None, info: Optional[list] = None) -> torch.Tensor:
        """The block's feed-forward over one routing group ``x [T, d]``:
        dense, or experts routed with ``capacity`` slots an expert (None:
        every pick kept) plus the shared experts.  ``forced = (sel, keep)``
        routes by those picks ``[T, k]`` (``keep`` None: all kept) instead
        of this model's own top-k; ``info`` (a list) gets a dict of the
        group's router probabilities, the picks used and this model's own
        top-k, and, where a ``keep`` was given, how many of its entries the
        capacity rule applied to ``sel`` contradicts."""
        if not self.experts:
            return self.swiglu(x, self.leaf("periods.b0.ffn.w_gate", layer, params),
                               self.leaf("periods.b0.ffn.w_up", layer, params),
                               self.leaf("periods.b0.ffn.w_down", layer, params))
        t = x.shape[0]
        probs = torch.softmax(x @ self.leaf("periods.b0.ffn.router", layer, params), dim=-1)
        own = torch.topk(probs, self.topk, dim=-1).indices
        sel = own if forced is None else forced[0].to(x.device).long()
        gate = probs.gather(-1, sel)
        if self.renorm:
            gate = gate / gate.sum(-1, keepdim=True)
        # slot-major: all first picks in token order, then all second picks
        flat = sel.T.reshape(-1)
        onehot = torch.nn.functional.one_hot(flat, self.experts)
        pos = ((torch.cumsum(onehot, 0) - onehot) * onehot).sum(-1)
        rule = torch.ones_like(flat, dtype=torch.bool) if capacity is None else pos < capacity
        keep = rule
        stats = {"probs": probs, "sel": sel, "own": own}
        if forced is not None and forced[1] is not None:
            keep = forced[1].to(x.device).T.reshape(-1).bool()
            stats["mismatch"] = int((keep != rule).sum())
        if info is not None:
            info.append(stats)
        tok = torch.arange(t, device=x.device).repeat(self.topk)
        wgt = gate.T.reshape(-1)
        out = torch.zeros_like(x)
        wg = params or self.w
        for e in range(self.experts):
            hit = keep & (flat == e)
            if not bool(hit.any()):
                continue
            idx = tok[hit]
            y = self.swiglu(x[idx], wg["periods.b0.ffn.we_gate"][layer, e].float(),
                            wg["periods.b0.ffn.we_up"][layer, e].float(),
                            wg["periods.b0.ffn.we_down"][layer, e].float())
            out = out.index_add(0, idx, y * wgt[hit][:, None])
        shared = self.swiglu(x, self.leaf("periods.b0.ffn.shared.w_gate", layer, params),
                             self.leaf("periods.b0.ffn.shared.w_up", layer, params),
                             self.leaf("periods.b0.ffn.shared.w_down", layer, params))
        return out + shared

    def head_weight(self, params=None) -> torch.Tensor:
        """``[d, vocab]``: the tied embedding's transpose, or the head."""
        if self.c.get("tie_word_embeddings"):
            return self.leaf("embed", None, params)[: self.vocab].T
        return self.leaf("lm_head", None, params)[:, : self.vocab]

    def embed(self, tokens: torch.Tensor, params=None) -> torch.Tensor:
        return self.leaf("embed", None, params)[tokens]

    # -- training -----------------------------------------------------------
    def nll_sum(self, tokens: torch.Tensor, labels: torch.Tensor, params) -> torch.Tensor:
        """Σ next-token cross entropy of one sequence (``tokens``, ``labels``
        ``[S]``), differentiable in ``params`` (float32 leaves by name);
        each layer recomputed in the backward (checkpointed) so that one
        layer's scores are held at a time."""
        s = tokens.shape[0]
        pos = torch.arange(s, device=tokens.device)
        x = self.embed(tokens, params)
        for i in range(self.layers):
            x = torch.utils.checkpoint.checkpoint(
                self._train_layer, x, i, pos, params, use_reentrant=False)
        x = self.norm(x, self.leaf("final_norm.scale", None, params))
        logits = self.mm(x, self.head_weight(params))
        lse = torch.logsumexp(logits, dim=-1)
        tgt = logits.gather(-1, labels[:, None])[:, 0]
        return (lse - tgt).sum()

    def _train_layer(self, x, i, pos, params):
        h = self.norm(x, self.leaf("periods.b0.mixer_norm.scale", i, params))
        q, k, v = self.qkv(h, i, pos, params)
        x = x + self.out_proj(self.attend(q, k, v, pos, pos), i, params)
        h = self.norm(x, self.leaf("periods.b0.ffn_norm.scale", i, params))
        return x + self.ffn(h, i, None, params)

    # -- serving ------------------------------------------------------------
    def served(self, prompt: Sequence[int], new: Sequence[int], prefill_len: int,
               capacity: int, routes: Optional[dict] = None) -> dict:
        """One request as the engine's semantics compute it: the prompt
        right-padded with token 0 to ``prefill_len`` and prefilled as one
        routing group of ``capacity`` slots an expert, then one position a
        step from the last prompt token on (recomputed at its position; its
        own and the later positions routed with every pick kept), each
        attending to the prefill's keys before it and to the steps' keys so
        far.  ``routes`` (``{"prefill": [(sel, keep)] a layer, "decode":
        [sel [n, k]] a layer}``) makes the experts follow those picks.
        Returns ``logits [n_new, vocab]`` and, for an MoE, each layer's
        routing ``info`` of the prefill and of the steps."""
        dev = self.w["embed"].device
        n_p = len(prompt)
        toks = torch.zeros(prefill_len, dtype=torch.long, device=dev)
        toks[:n_p] = torch.as_tensor(list(prompt), device=dev)
        steps = torch.as_tensor([prompt[-1], *new[:-1]], device=dev)
        ppos = torch.arange(prefill_len, device=dev)
        spos = torch.arange(n_p - 1, n_p - 1 + len(new), device=dev)
        info = {"prefill": [], "decode": []}
        with torch.no_grad():
            x, y = self.embed(toks), self.embed(steps)
            for i in range(self.layers):
                scale = self.leaf("periods.b0.mixer_norm.scale", i)
                q, k, v = self.qkv(self.norm(x, scale), i, ppos)
                qs, ks, vs = self.qkv(self.norm(y, scale), i, spos)
                x = x + self.out_proj(self.attend(q, k, v, ppos, ppos), i)
                kk = torch.cat([k[: n_p - 1], ks])
                vv = torch.cat([v[: n_p - 1], vs])
                kpos = torch.cat([ppos[: n_p - 1], spos])
                y = y + self.out_proj(self.attend(qs, kk, vv, spos, kpos), i)
                scale = self.leaf("periods.b0.ffn_norm.scale", i)
                fp = fd = None
                if routes is not None:
                    fp, fd = routes["prefill"][i], (routes["decode"][i], None)
                x = x + self.ffn(self.norm(x, scale), i, capacity, forced=fp,
                                 info=info["prefill"])
                y = y + self.ffn(self.norm(y, scale), i, None, forced=fd,
                                 info=info["decode"])
            y = self.norm(y, self.leaf("final_norm.scale"))
            return {"logits": self.mm(y, self.head_weight()), "info": info}


def route_margin(sel: torch.Tensor, probs: torch.Tensor) -> float:
    """How far the picks ``sel [T, k]`` are from a top-k of ``probs [T, E]``:
    the largest, over tokens, of the best unpicked probability less the
    worst picked one (at most 0 where they are a top-k)."""
    picked = probs.gather(-1, sel)
    rest = probs.scatter(-1, sel, float("-inf"))
    return float((rest.max(-1).values - picked.min(-1).values).max())


def moe_capacity(t: int, k: int, e: int, cf: float) -> int:
    """Slots an expert holds for ``t`` tokens routed as one group at
    capacity factor ``cf``: 128-aligned, at most ``round_up(t, 128)``."""
    up = lambda n: -(-n // 128) * 128  # noqa: E731
    return min(up(max(int(t * k / e * cf), 1)), up(t))
