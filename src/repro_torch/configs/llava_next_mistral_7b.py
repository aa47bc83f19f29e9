"""llava-next-mistral-7b [vlm] — mistral-7B backbone, anyres vision stub.

32 layers, d_model=4096, 32 heads (GQA kv=8), d_ff=14336, vocab=32000
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified].  RMSNorm, SwiGLU, RoPE.
The anyres tiling vision tower is a stub per the assignment:
``input_specs`` provides precomputed patch embeddings [B, 2880, 4096]
(2880 = anyres 4-tile + base-image token budget); a learned ``mm_proj``
projects them into the text stream.  Sequence budget = 2880 image +
(seq_len − 2880) text tokens; loss is computed on text positions only.

Pure full attention -> ``long_500k`` skipped.
"""

from .base import Block, ModelConfig

CONFIG = ModelConfig(
    microbatches=8,
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=32000,
    pattern=(Block("attn", "mlp"),),
    n_patches=2880,
    skip_shapes=("long_500k",),
)

SMOKE = ModelConfig(
    name="llava-next-mistral-7b-smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=512,
    pattern=(Block("attn", "mlp"),),
    n_patches=8,
    dtype_name="float32",
    param_dtype_name="float32",
    remat=False,
    skip_shapes=("long_500k",),
)
