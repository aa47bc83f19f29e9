"""LM substrate of the port (dense attention + MLP family).

``model`` assembles the blocks below according to a declarative
``ModelConfig`` (see ``repro_torch.configs``):

* ``attention`` — GQA / MQA / sliding-window attention + KV caches; long
  prefills run through the hand-written flash kernel on the card
* ``layers``    — norms, MLPs, positions, initializers
"""

from . import attention, layers, model
from .model import (
    Transformer,
    decode_step,
    forward,
    init_cache,
    init_params,
    padded_vocab,
    prefill,
)

__all__ = [
    "Transformer",
    "attention",
    "decode_step",
    "forward",
    "init_cache",
    "init_params",
    "layers",
    "model",
    "padded_vocab",
    "prefill",
]
