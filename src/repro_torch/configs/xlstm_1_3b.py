"""xlstm-1.3b [ssm] — sLSTM + mLSTM block stack.

48 layers, d_model=2048, 4 heads, d_ff=0 (xLSTM blocks carry their own
up/down projection via ``xlstm_proj_factor``), vocab=50304
[arXiv:2405.04517; unverified].  The xLSTM[7:1] layout interleaves one sLSTM
block per seven mLSTM blocks -> an 8-block pattern tiled 6 times.

Recurrent state is O(1) per token -> ``long_500k`` RUNS.
"""

from .base import Block, ModelConfig

_PATTERN = (Block("slstm", "none"),) + (Block("mlstm", "none"),) * 7

CONFIG = ModelConfig(
    microbatches=4,
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    pattern=_PATTERN,
    norm="ln",
    pos="none",
    xlstm_proj_factor=2,
    xlstm_chunk=256,
)

SMOKE = ModelConfig(
    name="xlstm-1.3b-smoke",
    family="ssm",
    n_layers=2,
    d_model=64,
    n_heads=2,
    n_kv_heads=2,
    d_ff=0,
    vocab=512,
    pattern=(Block("slstm", "none"), Block("mlstm", "none")),
    norm="ln",
    pos="none",
    xlstm_proj_factor=2,
    xlstm_chunk=16,
    dtype_name="float32",
    param_dtype_name="float32",
    remat=False,
)
