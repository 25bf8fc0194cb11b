from raisin_jax.engine.registry import ENGINES, SUITES, get_codec, register_backend  # noqa: F401
from raisin_jax.engine.core import (  # noqa: F401
    CompressedFile,
    compress_bytes,
    decompress_bytes,
)
