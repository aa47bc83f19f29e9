"""Architecture registry: the 10 assigned architectures and the LM shapes.

``get_config("mixtral-8x7b")`` returns the full published config;
``get_config("mixtral-8x7b", smoke=True)`` the reduced same-family variant
used by CPU tests.  Shapes only, no weights: the configuration modules are
copies of the JAX package's, and ``ModelConfig.dtype`` is a torch dtype.
``input_specs(cfg, shape)`` gives every model input of one (arch × shape)
cell as a tensor on the ``meta`` device (shape and dtype, no memory).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

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
    "input_specs",
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


def input_specs(
    cfg: ModelConfig, shape: ShapeConfig, batch_override: Optional[int] = None
) -> Dict[str, torch.Tensor]:
    """``meta`` tensors for every input of one (arch × shape) cell, with the
    reference's keys, shapes and dtypes.

    * train:    {tokens, labels} (+ frames / patches stubs)
    * prefill:  {tokens} (+ frames / patches)
    * decode:   {token, cur_pos}; the cache comes from ``models.model.init_cache``.
    """
    b = batch_override or shape.global_batch

    def spec(dims, dtype):
        return torch.empty(dims, dtype=dtype, device="meta")

    if shape.kind == "decode":
        return {"token": spec((b, 1), torch.int32), "cur_pos": spec((), torch.int32)}

    s_text = cfg.text_len(shape.seq_len)
    if s_text <= 0:
        raise ValueError(
            f"{cfg.name}: modality prefix {cfg.n_patches} exceeds "
            f"seq_len {shape.seq_len}"
        )
    specs = {"tokens": spec((b, s_text), torch.int32)}
    if cfg.is_encoder_decoder:
        specs["frames"] = spec((b, cfg.n_frames, cfg.d_model), cfg.dtype)
    if cfg.n_patches:
        specs["patches"] = spec((b, cfg.n_patches, cfg.d_model), cfg.dtype)
    if shape.kind == "train":
        specs["labels"] = spec((b, s_text), torch.int32)
    return specs
