"""Model / shape configuration system.

``ModelConfig`` describes one architecture declaratively; the model assembly
(``repro_torch.models.model``) interprets it.  Heterogeneous stacks (jamba,
xlstm) are expressed as a **block pattern**: one period of (mixer, ffn)
pairs that tiles the depth ``n_periods`` times.

Every architecture provides a ``SMOKE`` reduction (same family, tiny dims)
used by CPU tests.  This is the PyTorch port's copy of the JAX package's
``configs/base.py``: the same fields and values (the compile-tuning knobs
included, which the port reads nowhere), with ``dtype`` / ``param_dtype``
as torch dtypes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "Block"]


@dataclasses.dataclass(frozen=True)
class Block:
    """One position of the depth pattern."""

    mixer: str  # "attn" | "mamba" | "mlstm" | "slstm"
    ffn: str  # "mlp" | "moe" | "none"


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


#: The assigned input-shape set (LM family).
SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    # block pattern: tiles depth; default = homogeneous attention+mlp
    pattern: Tuple[Block, ...] = (Block("attn", "mlp"),)
    # styles
    norm: str = "rms"  # rms | ln | np_ln
    mlp: str = "swiglu"  # swiglu | gelu
    pos: str = "rope"  # rope | learned | sinusoidal
    rope_theta: float = 10_000.0
    window: Optional[int] = None  # sliding-window attention (mixtral)
    tie_embeddings: bool = False
    max_pos: int = 32_768  # learned position table size
    # MoE
    moe_experts: int = 0
    moe_topk: int = 0
    moe_ff: int = 0
    moe_shared_ff: int = 0
    moe_capacity: float = 1.25
    # row-local dispatch groups: routing capacity per batch row, keeping
    # all gather/scatter indices shard-local (kills the global dispatch's
    # cross-shard all-gather/all-reduce; see models/moe.py + §Perf)
    moe_row_local: bool = False
    # serving capacity factor (prefill/decode): higher than training's so
    # generation rarely drops tokens; smoke configs use 4.0 = dropless at
    # test sizes, making decode-vs-forward equivalence exact.
    moe_capacity_serve: float = 2.0
    router_aux: float = 0.01
    # Mamba
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_chunk: int = 128  # sequence chunk of the selective-scan blocking
    # xLSTM
    xlstm_proj_factor: int = 2
    xlstm_chunk: int = 256
    # encoder-decoder (whisper): n_layers counts DECODER layers
    enc_layers: int = 0
    n_frames: int = 0  # stub audio frontend: precomputed frame embeddings
    # vlm (llava): stub vision frontend: precomputed patch embeddings
    n_patches: int = 0
    # dtypes (strings so configs stay hashable/serializable)
    dtype_name: str = "bfloat16"
    param_dtype_name: str = "bfloat16"
    # training
    remat: bool = True
    microbatches: int = 1  # gradient-accumulation splits of the global batch
    optimizer: str = "adamw"  # adamw | adafactor | sgd (adafactor: 398B-scale)
    # fully unroll depth/microbatch scans: used by the dry-run cost pass
    # (XLA cost analysis counts a while-loop body once; unrolled compiles
    # make HLO_FLOPs exact).  Production form keeps the scans.
    scan_unroll: bool = False
    # inner-scan unroll knobs (sLSTM steps, mLSTM chunks, mamba chunks,
    # chunked-attention q/kv sweeps).  1 = plain while loop (production).
    # The dry-run cost pass compiles each knob at 2 and uses the delta —
    # exactly one extra loop body — to extrapolate the true per-iteration
    # FLOPs/bytes (XLA cost analysis counts a while body once; see
    # launch/dryrun.py §inner-scan corrections).
    slstm_unroll: int = 1
    mlstm_unroll: int = 1
    mamba_unroll: int = 1
    attn_q_unroll: int = 1
    attn_kv_unroll: int = 1
    # force the O(S²)-memory dense attention path (debug/ablation only)
    dense_attention: bool = False
    # which shapes this arch skips (e.g. long_500k for pure full attention)
    skip_shapes: Tuple[str, ...] = ()

    # -- derived -------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        assert self.n_layers % len(self.pattern) == 0, (
            self.n_layers,
            len(self.pattern),
        )

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype_name)

    @property
    def param_dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype_name)

    @property
    def n_periods(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def mamba_d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def mamba_dt_rank(self) -> int:
        return max(1, -(-self.d_model // 16))  # ceil(d/16), mamba default

    @property
    def xlstm_d_inner(self) -> int:
        return self.xlstm_proj_factor * self.d_model

    @property
    def xlstm_head_dim(self) -> int:
        return self.xlstm_d_inner // self.n_heads

    @property
    def is_encoder_decoder(self) -> bool:
        return self.enc_layers > 0

    def runnable_shapes(self):
        return [s for s in SHAPES.values() if s.name not in self.skip_shapes]

    def text_len(self, seq_len: int) -> int:
        """Decoder-token count for a given total sequence budget (vlm archs
        spend ``n_patches`` of the budget on the image prefix)."""
        return seq_len - self.n_patches if self.n_patches else seq_len

    # -- parameter counting (roofline MODEL_FLOPS) ----------------------------
    def param_counts(self) -> Dict[str, float]:
        """Analytic total vs *active* (per-token) parameter counts."""
        d, ff, v = self.d_model, self.d_ff, self.vocab
        h, kh, hd = self.n_heads, self.n_kv_heads, self.head_dim
        di, n, r = self.mamba_d_inner, self.mamba_d_state, self.mamba_dt_rank
        xdi = self.xlstm_d_inner
        mixer_p = {
            "attn": d * hd * (h + kh) * 2,
            "mamba": d * 2 * di + di * (r + 2 * n) + r * di + di * d
            + 4 * di + 2 * di + di * n,
            "mlstm": 2 * d * xdi + 4 * xdi + 3 * xdi * self.xlstm_head_dim
            * self.n_heads // 1 + xdi * 2 * self.n_heads + xdi * d,
            "slstm": d * 4 * d + self.n_heads * (d // self.n_heads) * 4
            * (d // self.n_heads) + d * d,
        }
        ffn_total = {
            "mlp": (3 if self.mlp == "swiglu" else 2) * d * ff,
            "moe": self.moe_experts * 3 * d * self.moe_ff
            + d * self.moe_experts + 3 * d * self.moe_shared_ff,
            "none": 0,
        }
        ffn_active = {
            "mlp": ffn_total["mlp"],
            "moe": self.moe_topk * 3 * d * self.moe_ff
            + d * self.moe_experts + 3 * d * self.moe_shared_ff,
            "none": 0,
        }
        total = active = 0.0
        for blk in self.pattern:
            total += mixer_p[blk.mixer] + ffn_total[blk.ffn]
            active += mixer_p[blk.mixer] + ffn_active[blk.ffn]
        total *= self.n_periods
        active *= self.n_periods
        enc = self.enc_layers * (mixer_p["attn"] + ffn_total["mlp"])
        emb = v * d * (1 if self.tie_embeddings else 2)
        return {
            "total": total + enc + emb,
            "active": active + enc + emb,
        }
