from raisin_jax.bitkit.packing import (  # noqa: F401
    bits_to_bytes_msb,
    bytes_to_bits_msb,
    pack_prepad_sentinel,
    unpack_prepad_sentinel,
)
