"""raisin-jax: a JAX lossless compression framework for the GPU.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
go-compression/raisin (reference layout: engine/engine.go, cmd/cli.go,
compressor/{lz,arithmetic,huffman,mcc,dmc}):

- ``raisin_jax.formats``   — exact `.rsn` wire-format codecs (host oracles,
  bit-compatible with the reference implementation).
- ``raisin_jax.ops``       — device codecs: vectorized/scan kernels for the
  hot paths (LZSS match search, adaptive arithmetic coding, Huffman).
- ``raisin_jax.engine``    — codec registry, algorithm layering, benchmark
  suite (parity with engine/engine.go).
- ``raisin_jax.parallel``  — block-sharded multi-chip encode/decode over a
  ``jax.sharding.Mesh`` (the scale path; RSNB block container).
- ``raisin_jax.cli``       — `raisin` / `grape` command-line tools
  (parity with cmd/cli.go).
"""

__version__ = "0.1.0"

from raisin_jax.engine.core import (  # noqa: F401
    CompressedFile,
    compress_bytes,
    decompress_bytes,
    compress_file,
    decompress_file,
    compress_files,
    decompress_files,
)
from raisin_jax.engine.registry import ENGINES, SUITES, get_codec  # noqa: F401
