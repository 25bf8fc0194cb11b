"""Device LZSS (scan match-search + pointer-doubling commit) vs. host oracle."""

import numpy as np
import pytest

from raisin_jax.formats import lzss_ref as ref
from raisin_jax.ops import lzss_jax as dev

from fixtures import HELLO, ABC, VERSE, random_bytes, random_text


@pytest.mark.parametrize(
    "payload",
    [
        b"",
        b"a",
        HELLO,
        ABC,
        b"a" * 300,  # long periodic run: L capped by D (overlap forbidden)
        VERSE,
        b"<><>,<>",  # escape-heavy
        b"\x5c\xff<tag>\x5c\x5c",
        random_bytes(2000, seed=60),
        random_text(3000, seed=61),
    ],
)
def test_device_matches_oracle(payload):
    got = dev.compress(payload)
    assert got == ref.compress(payload)
    assert ref.decompress(got) == payload


def test_window_parameter():
    chunk = b"0123456789unique-pattern-here"
    data = chunk + random_bytes(5000, seed=62) + chunk
    for w in (4096, 8192):
        assert dev.compress(data, window_size=w) == ref.compress(data, window_size=w)


def test_window_8192_match_at_max_distance():
    # a real match at distance exactly 8192 exercises the 14-bit distance
    # field in the packed (cap, d) reduction key (ADVICE r3: 13 bits lost
    # bit 13 of d into L, emitting <0,..> and corrupting the stream)
    chunk = b"0123456789unique-pattern-here!!"
    # escape-safe filler (no 0x3C/0x5C/0xFF) so escaped length == raw length
    # and no lowercase, so the chunk's only window occurrence is at d=8192
    filler = bytes(0x20 + (i * 7 + 1) % 0x1A for i in range(8192 - len(chunk)))
    data = chunk + filler + chunk + filler[:512]
    got = dev.compress(data, window_size=8192)
    want = ref.compress(data, window_size=8192)
    assert got == want
    assert ref.decompress(got) == data


def test_find_matches_blocks_values():
    # "abcXabcYabc": pos 8 matches "abc" at leftmost occurrence (D=8, L=3)
    data = b"abcXabcYabc"
    enc = ref.encode_opening_symbols(data)
    n = len(enc)
    S = 1024
    x = np.full((1, S), -1, dtype=np.int32)
    x[0, :n] = np.frombuffer(enc, dtype=np.uint8)
    L, D = dev.find_matches_blocks(x, np.array([n], dtype=np.int32), 4096, S // dev.TILE)
    oracle = ref.find_matches(enc, 4096)
    got = [(int(D[0, i]), int(L[0, i])) for i in range(n)]
    assert got == oracle


def test_multiblock_vmap_matches_oracle():
    blocks = [random_text(500, seed=63), VERSE[:700], b"zzzz" * 50]
    S = 1024
    x = np.full((len(blocks), S), -1, dtype=np.int32)
    lengths = np.zeros(len(blocks), dtype=np.int32)
    encs = []
    for i, b in enumerate(blocks):
        enc = ref.encode_opening_symbols(b)
        encs.append(enc)
        x[i, : len(enc)] = np.frombuffer(enc, dtype=np.uint8)
        lengths[i] = len(enc)
    L, D = dev.find_matches_blocks(x, lengths, 4096, S // dev.TILE)
    out, out_len = dev.commit_blocks(x, L, D, lengths)
    for i, b in enumerate(blocks):
        got = np.asarray(out[i, : int(out_len[i])], dtype=np.uint8).tobytes()
        assert got == ref.compress(b), f"block {i}"


def test_registered_as_device_backend():
    from raisin_jax.engine.registry import available_backends, get_codec

    assert "device" in available_backends("lzss")
    codec = get_codec("lzss", backend="device")
    assert codec.compress(VERSE) == ref.compress(VERSE)
    assert codec.decompress(codec.compress(VERSE)) == VERSE
