"""Version compatibility shims for the installed PyTorch.

DTensor's ``local_map`` (run a function on each rank's local shards and
wrap its outputs back as DTensors: the counterpart of ``shard_map``) and
``implicit_replication`` (plain tensors meeting DTensors in one op count as
replicated: the model's positions, masks and RoPE tables), from
``torch.distributed.tensor.experimental``.  Import them from here so every
caller tracks one location.
"""

from __future__ import annotations

__all__ = ["implicit_replication", "local_map"]

from torch.distributed.tensor.experimental import implicit_replication, local_map
