"""LM substrate of the port.

``model`` assembles the blocks below according to a declarative
``ModelConfig`` (see ``repro_torch.configs``):

* ``attention`` — GQA / MQA / sliding-window / cross attention + KV
  caches; long prefills run through the hand-written flash kernel on the
  card
* ``mamba``     — selective state space (jamba's mixer)
* ``xlstm``     — mLSTM / sLSTM blocks
* ``moe``       — top-k capacity-dispatch mixture of experts
* ``layers``    — norms, MLPs, positions, initializers
"""

from . import attention, layers, mamba, model, moe, xlstm
from .model import (
    Transformer,
    abstract_params,
    decode_step,
    encode,
    forward,
    init_cache,
    init_params,
    loss_fn,
    padded_vocab,
    prefill,
)

__all__ = [
    "Transformer",
    "abstract_params",
    "attention",
    "decode_step",
    "encode",
    "forward",
    "init_cache",
    "init_params",
    "layers",
    "loss_fn",
    "mamba",
    "model",
    "moe",
    "padded_vocab",
    "prefill",
    "xlstm",
]
