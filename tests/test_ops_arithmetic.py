"""Device arithmetic coder vs. the host oracle — byte equality."""

import numpy as np
import pytest

from raisin_jax.formats import arithmetic_ref as ref
from raisin_jax.ops import arithmetic_scan as dev

from fixtures import HELLO, VERSE, random_bytes, random_text


@pytest.mark.parametrize(
    "payload",
    [
        b"",
        HELLO,
        b"a" * 200,
        bytes(range(256)),
        VERSE,
        random_bytes(2000, seed=30),
        random_text(4000, seed=31),
    ],
)
def test_device_encode_matches_oracle(payload):
    assert dev.compress(payload) == ref.compress(payload)


@pytest.mark.parametrize("payload", [HELLO, VERSE, random_bytes(1500, seed=32)])
def test_device_decode_roundtrip(payload):
    compressed = dev.compress(payload)
    assert dev.decompress(compressed, out_len=len(payload)) == payload
    # raw-mode decode (no length) falls back to host and still round-trips
    assert dev.decompress(compressed) == payload


def test_device_freeze_path_matches_oracle():
    # cum[257] reaches 16383 after ~16126 symbols -> model freezes, while
    # still fitting the 16384-step bucket
    payload = random_text(16_200, seed=33)
    assert dev.compress(payload) == ref.compress(payload)


def test_ragged_blocks_match_oracle():
    blocks = [random_text(300, seed=40), random_bytes(121, seed=41), b"x", b"", VERSE[:777]]
    steps = dev._bucket(max(len(b) for b in blocks) + 1)
    symbols = np.full((len(blocks), steps), dev.EOF, dtype=np.int32)
    lengths = np.zeros(len(blocks), dtype=np.int32)
    for i, b in enumerate(blocks):
        symbols[i, : len(b)] = np.frombuffer(b, dtype=np.uint8)
        lengths[i] = len(b)
    padded_bits, bit_lengths = dev.encode_blocks(symbols, lengths, steps)
    for i, b in enumerate(blocks):
        nbits = int(bit_lengths[i])
        got = np.packbits(np.asarray(padded_bits[i, :nbits], dtype=np.uint8)).tobytes()
        assert got == ref.compress(b), f"block {i} mismatch"


def test_batched_decode_roundtrip():
    blocks = [random_text(256, seed=50), random_bytes(100, seed=51), VERSE[:512]]
    payloads = [ref.compress(b) for b in blocks]
    from raisin_jax.bitkit.packing import unpack_prepad_sentinel

    tails = [
        np.concatenate([unpack_prepad_sentinel(p), np.array([1, 0], dtype=np.uint8)])
        for p in payloads
    ]
    nbits = dev._bucket(max(len(t) for t in tails))
    bits = np.zeros((len(blocks), nbits), dtype=np.uint8)
    for i, t in enumerate(tails):
        bits[i, : len(t)] = t
    lengths = np.array([len(b) for b in blocks], dtype=np.int32)
    steps = dev._bucket(int(max(lengths)) + 1)
    syms, eof_ok = dev.decode_blocks(bits, lengths, steps)
    assert bool(eof_ok.all())
    for i, b in enumerate(blocks):
        assert np.asarray(syms[i, : len(b)], dtype=np.uint8).tobytes() == b


def test_registered_as_device_backend():
    from raisin_jax.engine.registry import available_backends, get_codec

    assert "device" in available_backends("arithmetic")
    codec = get_codec("arithmetic", backend="device")
    assert codec.compress(HELLO) == ref.compress(HELLO)
