"""The yardstick's frozen arithmetic: peaks, attention work, model FLOPs.

Frozen copies, so that what a kernel or a step is measured against stays the
same whatever later implements it:

* ``visible_pairs``, ``flash_work`` and the backward's byte count and its
  2.5x operations are copied from ``chip_smoke.py`` (``visible_pairs``,
  ``flash_work``, ``flash_bwd_case``'s timed row), where the repo's kernel
  timings have used them since flash was ported;
* ``model_flops`` extends ``repro_torch/launch/roofline.py``'s
  6 * N_active * tokens with attention over the visible (query, key) pairs,
  which that count leaves out.

Peaks are NVIDIA's data sheet for one H100 SXM (dense, no sparsity) at its
full 700 W limit; a result reports the card's power limit beside them.
"""

from __future__ import annotations

import numpy as np

BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
FP32_FLOPS = 67e12
HBM_BYTES_S = 3.35e12

#: the backward's operations against the forward's: dV, dP, dS and dQ, dK,
#: with the recomputed scores' QK^T taken at half
FLASH_BWD_FACTOR = 2.5

#: attention over more queries or keys than this runs the flash kernel on
#: the card (``models/attention.py``); at or below it the dense path
FLASH_THRESHOLD = 2048


def visible_pairs(sq: int, kv_len: int, causal: bool, window=None) -> int:
    """(query, key) pairs the masks leave visible: the work this input needs."""
    i = np.arange(sq)
    hi = np.minimum(i + 1, kv_len) if causal else np.full(sq, kv_len)
    lo = np.maximum(i - window + 1, 0) if window else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def flash_work(b, sq, kv_len, h, kh, d, causal, window, size: int) -> tuple:
    """(bytes, operations) of one forward: q, k and v read and the output
    written once (the keys up to ``kv_len``), 4 * D operations a visible pair."""
    nbytes = 2 * b * sq * h * d * size + 2 * b * kv_len * kh * d * size
    return nbytes, 4 * d * h * b * visible_pairs(sq, kv_len, causal, window)


def flash_bwd_work(b, sq, kv_len, h, kh, d, causal, window, size: int) -> tuple:
    """(bytes, operations) of one backward: q, o, do, dq and k, v, dk, dv
    once each, the float32 row statistics L and delta, and 2.5 times the
    forward's operations."""
    nbytes = 4 * b * sq * h * d * size + 4 * b * kv_len * kh * d * size + 2 * b * h * sq * 4
    ops = FLASH_BWD_FACTOR * 4 * d * h * b * visible_pairs(sq, kv_len, causal, window)
    return nbytes, ops


def bound_s(nbytes: float, flops: float, peak_flops: float = BF16_FLOPS) -> float:
    """The least time the card could take: operations at the peak rate or
    bytes at the memory's, whichever is longer."""
    return max(flops / peak_flops, nbytes / HBM_BYTES_S)


def uses_flash(sq: int, sk: int) -> bool:
    return max(sq, sk) > FLASH_THRESHOLD


def layer_weights(cfg: dict) -> int:
    """Weights a token multiplies by in one layer: q, k, v, o and the
    feed-forward (a dense SwiGLU, or the router, the top-k routed experts
    and the shared experts), from the published widths in ``cfg``."""
    d, hd = cfg["hidden_size"], cfg["head_dim"]
    h, kh = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    attn = d * h * hd * 2 + d * kh * hd * 2
    if cfg.get("num_experts"):
        ffn = (d * cfg["num_experts"]
               + cfg["num_experts_per_tok"] * 3 * d * cfg["moe_intermediate_size"]
               + 3 * d * cfg.get("shared_expert_intermediate_size", 0))
    else:
        ffn = 3 * d * cfg["intermediate_size"]
    return attn + ffn


def head_weights(cfg: dict) -> int:
    return cfg["hidden_size"] * cfg["vocab_size"]


def attn_pair_flops(cfg: dict) -> int:
    """Forward operations of one visible (query, key) pair in one layer:
    QK^T and PV, 2 * D each, over every query head."""
    return 4 * cfg["head_dim"] * cfg["num_attention_heads"]


def train_flops(cfg: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one training step over ``batch`` sequences of ``seq``
    tokens: 6 per weight a token multiplies by (every layer and the head,
    not the embedding lookup) and 3x the forward's attention pairs."""
    tokens = batch * seq
    dense = 6 * (cfg["num_hidden_layers"] * layer_weights(cfg) + head_weights(cfg)) * tokens
    pairs = batch * visible_pairs(seq, seq, True)
    return float(dense + 3 * attn_pair_flops(cfg) * cfg["num_hidden_layers"] * pairs)


def serve_flops(cfg: dict, prompt_len: int, new_tokens: int) -> float:
    """Model FLOPs one request needs: its prompt and all but its last new
    token through every layer, ``new_tokens`` head projections, and the
    causal pairs of those positions; real tokens only (no padding)."""
    n = prompt_len + new_tokens - 1
    dense = 2 * cfg["num_hidden_layers"] * layer_weights(cfg) * n
    head = 2 * head_weights(cfg) * new_tokens
    pairs = visible_pairs(n, n, True)
    return float(dense + head + attn_pair_flops(cfg) * cfg["num_hidden_layers"] * pairs)
