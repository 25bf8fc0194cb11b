"""Device (JAX/XLA/Pallas) codec kernels.

Modules register themselves into the engine registry under the ``device``
backend tag via :func:`register`.
"""


def register() -> None:
    """Register device backends (called by engine.registry on import)."""
    # Device kernels are registered lazily as they land:
    from raisin_jax.ops import dispatch

    dispatch.register_all()
