"""deepseek-67b [dense] — llama-arch.

95 layers, d_model=8192, 64 heads (GQA kv=8), d_ff=22016, vocab=102400
[arXiv:2401.02954; hf].  RMSNorm, SwiGLU, RoPE.

Adafactor by default at this scale (AdamW fp32 state = 804 GB; see
DESIGN.md §Mesh).  Pure full attention -> ``long_500k`` skipped.
"""

from .base import Block, ModelConfig

CONFIG = ModelConfig(
    microbatches=16,
    name="deepseek-67b",
    family="dense",
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab=102400,
    pattern=(Block("attn", "mlp"),),
    optimizer="adafactor",
    skip_shapes=("long_500k",),
)

SMOKE = ModelConfig(
    name="deepseek-67b-smoke",
    family="dense",
    n_layers=3,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    d_ff=160,
    vocab=512,
    pattern=(Block("attn", "mlp"),),
    optimizer="adafactor",
    dtype_name="float32",
    param_dtype_name="float32",
    remat=False,
    skip_shapes=("long_500k",),
)
