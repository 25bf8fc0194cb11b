"""Registration of device-backed codecs into the engine registry."""

from __future__ import annotations


def register_all() -> None:
    from raisin_jax.engine.registry import register_backend
    from raisin_jax.ops import arithmetic_scan

    # Raw .rsn streams carry no output length, so device decode (which needs
    # static shapes) hands raw streams to the host oracle; container-mode
    # decode (known block lengths) runs fully on device via parallel/blocks.
    register_backend(
        "arithmetic",
        "device",
        arithmetic_scan.compress,
        arithmetic_scan.decompress,
    )

    from raisin_jax.ops import lzss_jax

    register_backend(
        "lzss",
        "device",
        lzss_jax.compress,
        lzss_jax.decompress,
    )

    from raisin_jax.ops import huffman_jax

    register_backend(
        "huffman",
        "device",
        huffman_jax.compress,
        huffman_jax.decompress,
    )
