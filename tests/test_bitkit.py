import numpy as np
import pytest

from raisin_jax.bitkit import (
    bits_to_bytes_msb,
    bytes_to_bits_msb,
    pack_prepad_sentinel,
    unpack_prepad_sentinel,
)


def test_msb_roundtrip():
    bits = np.array([1, 0, 1, 1, 0, 0, 1, 0], dtype=np.uint8)
    assert bits_to_bytes_msb(bits) == b"\xb2"
    assert (bytes_to_bits_msb(b"\xb2") == bits).all()


def test_prepad_sentinel_roundtrip():
    for n in range(0, 40):
        bits = np.array([(i * 7) % 3 == 0 for i in range(n)], dtype=np.uint8)
        packed = pack_prepad_sentinel(bits)
        assert len(packed) % 1 == 0 and len(packed) >= 1
        assert (unpack_prepad_sentinel(packed) == bits).all()


def test_prepad_aligned_adds_full_byte():
    bits = np.ones(8, dtype=np.uint8)
    # 8 pad bits when already aligned (bits.go:51)
    assert pack_prepad_sentinel(bits) == b"\x01\xff"


def test_unpack_no_sentinel_raises():
    with pytest.raises(ValueError):
        unpack_prepad_sentinel(b"\x00\x00")
