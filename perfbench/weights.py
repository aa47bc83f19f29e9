"""Seeded weights, drawn where they are used, from the names and shapes a
configuration file lists under ``weights``.

Every leaf of one dtype comes from one buffer filled by a few large calls of
``torch.randn`` on a ``torch.Generator`` of the device (chunks of at most
2**30 values), in the dtype the weights are served in, then scaled per leaf
by its ``std``; ``"init": "ones"`` leaves are ones.  The same seed gives
the same tensors, and the benchmark hands these same tensors to the port
and to the plain reference.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

CHUNK = 1 << 30


def draw(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """``{dotted name: tensor}`` for every entry of ``config["weights"]``."""
    specs = config["weights"]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    out: Dict[str, torch.Tensor] = {}
    for dtype_name in sorted({s["dtype"] for s in specs.values()}):
        dtype = getattr(torch, dtype_name)
        names = [n for n, s in specs.items() if s["dtype"] == dtype_name]
        drawn = [n for n in names if _init(specs[n]) == "normal"]
        total = sum(math.prod(specs[n]["shape"]) for n in drawn)
        buf = torch.empty(total, dtype=dtype, device=device)
        for lo in range(0, total, CHUNK):
            n = min(CHUNK, total - lo)
            buf[lo:lo + n] = torch.randn(n, dtype=dtype, device=device, generator=gen)
        off = 0
        for name in drawn:
            spec = specs[name]
            size = math.prod(spec["shape"])
            out[name] = buf[off:off + size].view(spec["shape"]).mul_(spec["std"])
            off += size
        for name in names:
            if _init(specs[name]) == "ones":
                out[name] = torch.ones(specs[name]["shape"], dtype=dtype, device=device)
    return {name: out[name] for name in specs}


def _init(spec: dict) -> str:
    init = spec.get("init", "normal")
    if init not in ("normal", "ones"):
        raise ValueError(f"unknown init {init!r}")
    return init


def nest(flat: Dict[str, torch.Tensor]) -> dict:
    """Dotted names -> nested dicts (the port's parameter tree)."""
    tree: dict = {}
    for name, t in flat.items():
        node = tree
        *path, last = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[last] = t
    return tree


def flatten(tree: dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Nested dicts -> dotted names (the inverse of :func:`nest`)."""
    out: Dict[str, torch.Tensor] = {}
    for key, sub in tree.items():
        name = f"{prefix}{key}"
        if isinstance(sub, dict):
            out.update(flatten(sub, name + "."))
        else:
            out[name] = sub
    return out
