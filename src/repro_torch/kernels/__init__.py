"""Hand-written CUDA kernels (Hopper, ``sm_90a``) for the factorized
engine's hot spots, with their plain PyTorch versions.

``ops`` holds the public entry points (CUDA tensor → kernel, CPU tensor →
plain version), ``ref`` the plain versions, ``segment_view`` / ``moments``
the ctypes wrappers, and ``_build`` the ``nvcc`` build of
``repro_torch/csrc`` at first use."""

from . import ops, ref

__all__ = ["ops", "ref"]
