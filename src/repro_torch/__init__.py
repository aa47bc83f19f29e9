"""PyTorch/CUDA port of the factorized-learning system.

Mirrors the JAX package ``repro`` module for module (same file names, same
public names) and never imports it or JAX.  Value aggregation runs on an
NVIDIA GPU through hand-written CUDA kernels (``repro_torch.kernels``);
entry points take a ``device`` that is ``"cuda"`` unless the caller asks
for the CPU, where the kernels' plain PyTorch versions run instead.
"""
