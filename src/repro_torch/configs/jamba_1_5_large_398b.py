"""jamba-1.5-large-398b [hybrid] — Mamba + attention 1:7, MoE 16e top-2.

72 layers, d_model=8192, 64 heads (GQA kv=8), d_ff=24576, vocab=65536
[arXiv:2403.19887; hf].  Each 8-layer Jamba block has ONE attention layer
(index 4) and seven Mamba layers; MoE (16 experts, top-2, expert
d_ff=24576) replaces the MLP on every second layer.  RMSNorm.  Mamba layers
carry position information -> no RoPE (pos="none"), matching the paper.

Decode state is O(1) for Mamba layers and 9 KV caches total ->
``long_500k`` RUNS.  Adafactor at 398B (AdamW fp32 state would need
4.8 TB; see DESIGN.md §Mesh).
"""

from .base import Block, ModelConfig

_PATTERN = (
    Block("mamba", "mlp"),
    Block("mamba", "moe"),
    Block("mamba", "mlp"),
    Block("mamba", "moe"),
    Block("attn", "mlp"),
    Block("mamba", "moe"),
    Block("mamba", "mlp"),
    Block("mamba", "moe"),
)

CONFIG = ModelConfig(
    microbatches=16,
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab=65536,
    pattern=_PATTERN,
    pos="none",
    moe_experts=16,
    moe_topk=2,
    moe_ff=24576,
    mamba_d_state=16,
    mamba_expand=2,
    optimizer="adafactor",
)

SMOKE = ModelConfig(
    moe_capacity=4.0,
    moe_capacity_serve=4.0,
    name="jamba-1.5-large-398b-smoke",
    family="hybrid",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=512,
    pattern=(
        Block("mamba", "mlp"),
        Block("mamba", "moe"),
        Block("attn", "mlp"),
        Block("mamba", "moe"),
    ),
    pos="none",
    moe_experts=4,
    moe_topk=2,
    moe_ff=96,
    mamba_d_state=8,
    mamba_expand=2,
    optimizer="adafactor",
    dtype_name="float32",
    param_dtype_name="float32",
    remat=False,
)
