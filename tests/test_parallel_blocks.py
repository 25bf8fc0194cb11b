"""RSNB container + mesh-sharded block encode/decode (8 virtual CPU devices)."""

import jax
import pytest

from raisin_jax.parallel import (
    compress_container,
    decompress_container,
    data_mesh,
)
from raisin_jax.parallel.blocks import parse_container

from fixtures import VERSE, random_bytes, random_text

PIPELINES = [("arithmetic",), ("lzss",), ("lzss", "arithmetic"), ("huffman",), ("gzip",)]


@pytest.mark.parametrize("algorithms", PIPELINES)
def test_container_roundtrip(algorithms):
    data = random_text(10_000, seed=80)
    c = compress_container(data, algorithms, block_size=2048)
    assert decompress_container(c) == data


def test_container_empty():
    c = compress_container(b"", ("arithmetic",), block_size=2048)
    assert decompress_container(c) == b""


def test_container_binary():
    data = random_bytes(9_999, seed=81)
    c = compress_container(data, ("lzss", "arithmetic"), block_size=4000)
    assert decompress_container(c) == data


def test_container_metadata():
    data = VERSE * 10
    c = compress_container(data, ("lzss", "arithmetic"), block_size=1024)
    algorithms, block_size, orig_size, payloads, aux, window = parse_container(c)
    assert algorithms == ("lzss", "arithmetic")
    assert block_size == 1024
    assert orig_size == len(data)
    assert len(payloads) == (len(data) + 1023) // 1024
    assert len(aux) == 1  # intermediate token-stream lengths


def test_container_blocks_are_reference_format():
    # every block payload must be an exact single-stream .rsn encoding
    from raisin_jax.formats import arithmetic_ref

    data = random_text(5_000, seed=82)
    c = compress_container(data, ("arithmetic",), block_size=2048)
    _, block_size, _, payloads, _, _ = parse_container(c)
    for i, p in enumerate(payloads):
        block = data[i * block_size : (i + 1) * block_size]
        assert p == arithmetic_ref.compress(block)


@pytest.mark.parametrize("algorithms", [("arithmetic",), ("lzss", "arithmetic")])
def test_sharded_encode_decode_on_mesh(algorithms):
    assert len(jax.devices()) == 8, "conftest should force 8 virtual CPU devices"
    mesh = data_mesh(8)
    data = random_text(40_000, seed=83)
    c = compress_container(data, algorithms, block_size=2048, mesh=mesh)
    # sharded output equals unsharded output byte-for-byte
    assert c == compress_container(data, algorithms, block_size=2048)
    assert decompress_container(c, mesh=mesh) == data


def test_mesh_padding_of_ragged_block_counts():
    # 3 blocks over an 8-device mesh: padded internally, dropped at assembly
    mesh = data_mesh(8)
    data = random_text(5_000, seed=84)
    c = compress_container(data, ("arithmetic",), block_size=2048, mesh=mesh)
    assert decompress_container(c) == data


def test_container_lzss_huffman_roundtrip():
    data = random_text(10_000, seed=85)
    c = compress_container(data, ("lzss", "huffman"), block_size=2048)
    algorithms, _, _, payloads, aux, _ = parse_container(c)
    assert algorithms == ("lzss", "huffman")
    assert len(aux) == 1  # lzss token-stream lengths
    assert decompress_container(c) == data


def test_container_huffman_blocks_are_reference_format():
    # device-batched huffman payloads must be byte-identical to the oracle
    from raisin_jax.formats import huffman_ref

    data = random_text(6_000, seed=86)
    c = compress_container(data, ("huffman",), block_size=2048)
    _, block_size, _, payloads, _, _ = parse_container(c)
    for i, p in enumerate(payloads):
        block = data[i * block_size : (i + 1) * block_size]
        assert p == huffman_ref.compress(block)
        assert huffman_ref.decompress(p) == block


def test_container_huffman_non_ascii_fallback():
    # bytes >= 0x80 route through the host oracle path (Go rune semantics
    # mangle non-UTF-8 either way; valid UTF-8 text must still round-trip)
    data = ("héllo wörld ünïcode " * 100).encode("utf-8")
    c = compress_container(data, ("huffman",), block_size=len(data))
    assert decompress_container(c) == data


def test_container_window_parameter():
    # smaller windows produce valid (reference-decodable) containers and
    # match the oracle at the same window
    from raisin_jax.formats import arithmetic_ref, lzss_ref

    data = random_text(9_000, seed=87)
    c = compress_container(data, ("lzss", "arithmetic"), block_size=4096, window=1024)
    _, block_size, _, payloads, _, _ = parse_container(c)
    for i, p in enumerate(payloads):
        block = data[i * block_size : (i + 1) * block_size]
        assert p == arithmetic_ref.compress(lzss_ref.compress(block, 1024))
    assert decompress_container(c) == data


def test_container_binary_data_paths():
    """Escape-heavy binary data rides the fallback paths losslessly; huffman
    on binary is reference-parity lossy (rune mangling, huffman.go:306-310)
    so the container refuses it rather than returning mangled bytes."""
    import numpy as np
    import pytest

    rng = np.random.default_rng(1)
    data = bytes(rng.integers(0, 256, size=1 << 17, dtype=np.uint8)) + b"\x5c\xff<>" * 700
    for algos in (("lzss", "arithmetic"), ("arithmetic",), ("lzss",)):
        c = compress_container(data, algos, block_size=16384, window=4096)
        assert decompress_container(c) == data, algos
    c = compress_container(data, ("huffman",), block_size=16384)
    with pytest.raises(ValueError):
        decompress_container(c)


def test_dispatch_loop_matches_one_dispatch(monkeypatch):
    """Inputs past DISPATCH_BYTES run as a loop of dispatches; blocks are
    independent, so the container is the same byte for byte."""
    from raisin_jax.parallel import blocks as blk

    data = random_text(9_000, seed=88)
    want = compress_container(data, ("lzss", "arithmetic"), block_size=1024)
    monkeypatch.setattr(blk, "DISPATCH_BYTES", 3 * 1024)
    assert blk._dispatches(9, 1024, None) == [(0, 3), (3, 6), (6, 9)]
    got = compress_container(data, ("lzss", "arithmetic"), block_size=1024)
    assert got == want
    assert decompress_container(got) == data
