"""Architecture registry: the 10 assigned architectures and the LM shapes.

``get_config("mixtral-8x7b")`` returns the full published config;
``get_config("mixtral-8x7b", smoke=True)`` the reduced same-family variant
used by CPU tests.  Shapes only, no weights: the configuration modules are
copies of the JAX package's, and ``ModelConfig.dtype`` is a torch dtype.
"""

from __future__ import annotations

from typing import Dict

from . import (
    deepseek_67b,
    granite_20b,
    jamba_1_5_large_398b,
    llava_next_mistral_7b,
    mixtral_8x7b,
    olmo_1b,
    qwen2_moe_a2_7b,
    smollm_135m,
    whisper_medium,
    xlstm_1_3b,
)
from .base import SHAPES, Block, ModelConfig, ShapeConfig

__all__ = [
    "ARCHS",
    "SHAPES",
    "SMOKE_ARCHS",
    "Block",
    "ModelConfig",
    "ShapeConfig",
    "get_config",
    "paper_arch",
]

_MODULES = {
    "whisper-medium": whisper_medium,
    "smollm-135m": smollm_135m,
    "deepseek-67b": deepseek_67b,
    "olmo-1b": olmo_1b,
    "granite-20b": granite_20b,
    "xlstm-1.3b": xlstm_1_3b,
    "qwen2-moe-a2.7b": qwen2_moe_a2_7b,
    "mixtral-8x7b": mixtral_8x7b,
    "llava-next-mistral-7b": llava_next_mistral_7b,
    "jamba-1.5-large-398b": jamba_1_5_large_398b,
}

ARCHS: Dict[str, ModelConfig] = {
    name: mod.CONFIG for name, mod in _MODULES.items()
}

SMOKE_ARCHS: Dict[str, ModelConfig] = {
    name: mod.SMOKE for name, mod in _MODULES.items()
}


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    table = SMOKE_ARCHS if smoke else ARCHS
    if name not in table:
        raise KeyError(
            f"unknown architecture {name!r}; available: {sorted(table)}"
        )
    return table[name]


def paper_arch() -> ModelConfig:
    """The ~100M decoder used by the end-to-end training example — llama
    family, sized so a few hundred steps run on CPU/laptop scale."""
    return ModelConfig(
        name="repro-100m",
        family="dense",
        n_layers=12,
        d_model=768,
        n_heads=12,
        n_kv_heads=4,
        d_ff=2048,
        vocab=32768,
        pattern=(Block("attn", "mlp"),),
        tie_embeddings=True,
        dtype_name="float32",
        param_dtype_name="float32",
        remat=False,
        skip_shapes=("long_500k",),
    )
