"""smollm-135m [dense] — llama-arch small.

30 layers, d_model=576, 9 heads (GQA kv=3), d_ff=1536, vocab=49152
[hf:HuggingFaceTB/SmolLM-135M; hf].  RMSNorm, SwiGLU, RoPE, tied embeddings.

Pure full attention -> ``long_500k`` skipped.
"""

from .base import Block, ModelConfig

CONFIG = ModelConfig(
    microbatches=4,
    name="smollm-135m",
    family="dense",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    d_ff=1536,
    vocab=49152,
    pattern=(Block("attn", "mlp"),),
    tie_embeddings=True,
    skip_shapes=("long_500k",),
)

SMOKE = ModelConfig(
    name="smollm-135m-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=512,
    pattern=(Block("attn", "mlp"),),
    tie_embeddings=True,
    dtype_name="float32",
    param_dtype_name="float32",
    remat=False,
    skip_shapes=("long_500k",),
)
