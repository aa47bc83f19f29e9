"""qwen2-moe-a2.7b [moe] — 60 routed experts top-4 + 4 shared experts.

24 layers, d_model=2048, 16 heads (kv=16), per-expert d_ff=1408,
vocab=151936 [hf:Qwen/Qwen1.5-MoE-A2.7B; hf].  RMSNorm, RoPE.  The 4 shared
experts run densely (5632 = 4×1408 hidden) alongside the routed top-4.

60 experts do not divide the 16-way model axis — the sharding policy's
divisibility fallback shards the expert *hidden* dim instead (TP within
experts), documented in DESIGN.md §Mesh.

Pure full attention -> ``long_500k`` skipped.
"""

from .base import Block, ModelConfig

CONFIG = ModelConfig(
    microbatches=4,
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=151936,
    pattern=(Block("attn", "moe"),),
    moe_capacity_serve=1.25,
    moe_experts=60,
    moe_topk=4,
    moe_ff=1408,
    moe_shared_ff=5632,
    skip_shapes=("long_500k",),
)

SMOKE = ModelConfig(
    moe_capacity=4.0,
    moe_capacity_serve=4.0,
    name="qwen2-moe-a2.7b-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=96,
    vocab=512,
    pattern=(Block("attn", "moe"),),
    moe_experts=6,
    moe_topk=2,
    moe_ff=96,
    moe_shared_ff=128,
    dtype_name="float32",
    param_dtype_name="float32",
    remat=False,
    skip_shapes=("long_500k",),
)
