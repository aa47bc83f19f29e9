"""Plain PyTorch references the benchmark judges the port's outputs by.

Nothing here imports the port, JAX or the JAX package, or takes anything
the port has made: the harness hands both sides the same seeded weights
and inputs, and the reference works out again what the port derives."""
