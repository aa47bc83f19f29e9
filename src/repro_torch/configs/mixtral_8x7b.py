"""mixtral-8x7b [moe] — 8 experts top-2, sliding-window attention.

32 layers, d_model=4096, 32 heads (GQA kv=8), per-expert d_ff=14336,
vocab=32000 [arXiv:2401.04088; hf].  RMSNorm, SwiGLU experts, RoPE,
**sliding window 4096**: decode keeps a ring-buffer KV cache of 4096 slots
regardless of context length, so ``long_500k`` RUNS (sub-quadratic by
windowing).
"""

from .base import Block, ModelConfig

CONFIG = ModelConfig(
    microbatches=8,
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=32000,
    pattern=(Block("attn", "moe"),),
    window=4096,
    moe_experts=8,
    moe_topk=2,
    moe_ff=14336,
)

SMOKE = ModelConfig(
    moe_capacity=4.0,
    moe_capacity_serve=4.0,
    name="mixtral-8x7b-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=512,
    pattern=(Block("attn", "moe"),),
    window=16,
    moe_experts=4,
    moe_topk=2,
    moe_ff=128,
    dtype_name="float32",
    param_dtype_name="float32",
    remat=False,
)
