from raisin_jax.utils.misc import byte_count_si, wait_timeout  # noqa: F401
