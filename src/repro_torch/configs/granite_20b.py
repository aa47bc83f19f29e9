"""granite-20b [dense] — gpt-bigcode-style code model with MQA.

52 layers, d_model=6144, 48 heads with **kv=1 (multi-query)**, d_ff=24576,
vocab=49152 [arXiv:2405.04324; hf].  LayerNorm, GELU MLP, learned absolute
positions.  MQA means the KV cache is 48x smaller than MHA — but kv_heads=1
cannot be tensor-sharded, so decode shards the cache sequence dim instead
(SP; see sharding rules).

Pure full attention -> ``long_500k`` skipped.
"""

from .base import Block, ModelConfig

CONFIG = ModelConfig(
    microbatches=8,
    name="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab=49152,
    pattern=(Block("attn", "mlp"),),
    norm="ln",
    mlp="gelu",
    pos="learned",
    max_pos=32_768,
    skip_shapes=("long_500k",),
)

SMOKE = ModelConfig(
    name="granite-20b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv_heads=1,
    d_ff=128,
    vocab=512,
    pattern=(Block("attn", "mlp"),),
    norm="ln",
    mlp="gelu",
    pos="learned",
    max_pos=128,
    dtype_name="float32",
    param_dtype_name="float32",
    remat=False,
    skip_shapes=("long_500k",),
)
