"""Mesh construction and the card's constants.

Defined as FUNCTIONS (never module-level meshes) so importing this module
never touches ``torch.distributed`` state: a mesh needs a process group,
which the caller brings up (torchrun's environment, or a group of one as
``launch.train --mesh`` starts it).

Mesh shapes per the assignment (the reference's):

* single-pod:  (16, 16)      axes ("data", "model")   — 256 cards
* multi-pod:   (2, 16, 16)   axes ("pod", "data", "model") — 512 cards

The H100 SXM constants for rooflines and bounds live in ``HW`` here so
every consumer (``chip_smoke.py``, benchmarks, docs) quotes one source
(NVIDIA's data sheet: dense rates without sparsity, at the 700 W limit).
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["HW", "make_host_mesh", "make_production_mesh", "production_shape"]


@dataclasses.dataclass(frozen=True)
class _Hardware:
    name: str = "NVIDIA H100 SXM"
    peak_flops_bf16: float = 989e12  # dense tensor cores, per card
    peak_flops_tf32: float = 495e12  # dense tensor cores, per card
    peak_flops_fp32: float = 67e12  # off the tensor cores
    peak_flops_fp64: float = 34e12  # off the tensor cores
    hbm_bw: float = 3.35e12  # bytes/s per card
    nvlink_bw: float = 450e9  # bytes/s each way per card (900 GB/s both)
    hbm_bytes: float = 80e9  # per card


HW = _Hardware()


def production_shape(multi_pod: bool = False) -> tuple:
    """(shape, axis names) of the production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def _mesh(device: str, shape: tuple, names: tuple):
    from torch.distributed.device_mesh import init_device_mesh

    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("a mesh needs a process group: init_process_group first")
    world = dist.get_world_size()
    need = 1
    for n in shape:
        need *= n
    if need != world:
        raise ValueError(f"mesh {shape} {names} needs {need} ranks, the world has {world}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a cuda mesh needs a CUDA device; pass device='cpu'")
    return init_device_mesh(device, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """The production mesh over the current process group, which must have
    exactly 256 (512 with ``multi_pod``) ranks; raises otherwise."""
    shape, names = production_shape(multi_pod)
    return _mesh(device, shape, names)


def make_host_mesh(data: int = 1, model: int = 1, *, device: str = "cuda"):
    """A ``("data", "model")`` mesh of ``data × model`` ranks over the
    current process group, on the card unless the caller asks for the
    CPU."""
    return _mesh(device, (data, model), ("data", "model"))
