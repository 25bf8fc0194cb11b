from raisin_jax.parallel.blocks import (  # noqa: F401
    compress_container,
    decompress_container,
    DEFAULT_BLOCK_SIZE,
)
from raisin_jax.parallel.mesh import data_mesh, best_mesh  # noqa: F401
