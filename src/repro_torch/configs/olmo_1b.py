"""olmo-1b [dense] — non-parametric LayerNorm.

16 layers, d_model=2048, 16 heads (kv=16), d_ff=8192, vocab=50304
[arXiv:2402.00838; hf].  OLMo's distinguishing choice is **non-parametric**
LayerNorm (no scale/bias) -> ``norm="np_ln"``; SwiGLU, RoPE, tied embeddings.

Pure full attention -> ``long_500k`` skipped.
"""

from .base import Block, ModelConfig

CONFIG = ModelConfig(
    microbatches=4,
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=50304,
    pattern=(Block("attn", "mlp"),),
    norm="np_ln",
    tie_embeddings=True,
    skip_shapes=("long_500k",),
)

SMOKE = ModelConfig(
    name="olmo-1b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=512,
    pattern=(Block("attn", "mlp"),),
    norm="np_ln",
    tie_embeddings=True,
    dtype_name="float32",
    param_dtype_name="float32",
    remat=False,
    skip_shapes=("long_500k",),
)
