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


def pytest_runtest_setup(item):
    """Re-register IVF_PQR before each test of a module that registered it at
    import (``from repro.vdms.ivf_pqr import register`` and a call at module
    level). A fixture elsewhere unregisters the family at teardown, and under
    one worker process that ran first the module's tests would find it gone.
    Modules that never imported ``register`` get nothing registered, so the
    default families everywhere else stay as they are."""
    if jax is None:
        return
    module = getattr(item, "module", None)
    if module is None:
        return
    try:
        from repro.vdms import ivf_pqr
    except ImportError:
        return
    if any(v is ivf_pqr.register for v in vars(module).values()):
        ivf_pqr.register()
