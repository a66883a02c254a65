"""Repository-wide pytest setup.

jax 0.9.0 removed ``jax.experimental.enable_x64``, which the JAX package
(``repro.core.acquisition_jax``) and its tests import. ``jax.enable_x64`` is
the same context manager, so alias it back when the old name is missing;
without the alias nothing under ``repro.core`` or ``repro.vdms`` imports.
Where JAX is not installed (the PyTorch port's GPU tests), there is nothing
to alias.
"""
try:
    import jax
    import jax.experimental
except ImportError:
    jax = None

if jax is not None and not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64
