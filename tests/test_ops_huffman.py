"""Device Huffman (gather/pack encode + bit-walk decode) vs. host oracle."""

import pytest

from raisin_jax.formats import huffman_ref as ref
from raisin_jax.ops import huffman_jax as dev

from fixtures import HELLO, ABC, VERSE, UNICODE_TEXT, random_bytes, random_text


@pytest.mark.parametrize(
    "payload",
    [
        HELLO,
        ABC,
        VERSE,
        UNICODE_TEXT,
        b"newline\nhandling\n",
        random_bytes(500, seed=70),  # binary -> mangled identically to Go
        random_text(3000, seed=71),
    ],
)
def test_device_matches_oracle(payload):
    got = dev.compress(payload)
    assert got == ref.compress(payload)
    assert dev.decompress(got) == ref.decompress(got)


def test_single_symbol_raises_like_oracle():
    # Single-symbol input yields a zero-length code; the reference decoder
    # panics there (huffman.go:131-133). Both paths must raise, and the
    # compressed bytes must still match bit-for-bit.
    got = dev.compress(b"aaaa")
    assert got == ref.compress(b"aaaa")
    with pytest.raises(ValueError):
        ref.decompress(got)
    with pytest.raises(ValueError):
        dev.decompress(got)


def test_corrupt_stream_behavior_matches_oracle():
    # A corrupted tail either ends mid-code (both implementations raise) or
    # still decodes to complete codes (both produce identical output).
    compressed = dev.compress(VERSE)
    corrupted = compressed[:-1] + bytes([compressed[-1] ^ 0xFF])
    try:
        expected = ref.decompress(corrupted)
    except ValueError:
        with pytest.raises(ValueError):
            dev.decompress(corrupted)
    else:
        assert dev.decompress(corrupted) == expected


def test_empty_raises():
    with pytest.raises(ValueError):
        dev.compress(b"")


def test_registered_as_device_backend():
    from raisin_jax.engine.registry import available_backends, get_codec

    assert "device" in available_backends("huffman")
    codec = get_codec("huffman", backend="device")
    assert codec.compress(VERSE) == ref.compress(VERSE)
