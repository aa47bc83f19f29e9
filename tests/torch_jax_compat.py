"""JAX version shims for the port's parity tests.

The tests turn on JAX's float64 mode to compute float64 references.  Newer
JAX releases spell that ``jax.enable_x64(True)``; older ones, such as the
0.4 series that ``requirements-ci.txt`` pins, only have
``jax.experimental.enable_x64()``.  ``enable_x64`` takes whichever exists.
"""

import jax


def enable_x64():
    """A context manager that runs its block with JAX's x64 mode on."""
    ctx = getattr(jax, "enable_x64", None)
    if ctx is not None:
        return ctx(True)
    from jax.experimental import enable_x64 as legacy

    return legacy()
