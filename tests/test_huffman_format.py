import pytest

from raisin_jax.formats import huffman_ref as hf

from fixtures import HELLO, ABC, VERSE, UNICODE_TEXT, random_bytes, random_text


@pytest.mark.parametrize(
    "payload",
    [HELLO, ABC, VERSE, UNICODE_TEXT, b"newline\nhandling\nhere\n", random_text(3000, seed=4)],
)
def test_roundtrip_text(payload):
    assert hf.decompress(hf.compress(payload)) == payload


def test_hello_world_ratio_parity():
    # Reference README.md:157: huffman on 13-byte test.txt -> 307.69% = 40 B.
    assert len(hf.compress(b"Hello world!\n"[:13])) == 40


def test_binary_mangled_like_reference():
    # Rune-based codec: invalid UTF-8 bytes become U+FFFD (EF BF BD), same as Go.
    payload = random_bytes(64, seed=5)
    out = hf.decompress(hf.compress(payload))
    # Go round-trips the *rune* sequence, re-encoded as UTF-8 — invalid bytes
    # come back as U+FFFD (EF BF BD), valid multi-byte sequences survive.
    expected = b"".join(hf.rune_to_utf8(r) for r in hf.go_decode_runes(payload))
    assert out == expected
    assert out != payload  # this payload contains invalid UTF-8 -> mangled


def test_single_symbol_decode_raises():
    # Single-symbol streams carry a zero-length code; the reference panics
    # on them (huffman.go:131-133). We raise instead of truncating silently.
    with pytest.raises(ValueError, match="single-symbol"):
        hf.decompress(hf.compress(b"aaaa"))


def test_empty_raises():
    with pytest.raises(ValueError):
        hf.compress(b"")


def test_header_order_insensitive():
    # The decoder must accept reference headers in arbitrary map order.
    payload = b"some text\nwith newlines\nand repeats and repeats"
    compressed = hf.compress(payload)
    header, rest = compressed.split(hf.SEPARATOR, 1)
    freqs = hf.parse_header(header)
    # Rebuild the header in reverse order and decode again.
    parts = []
    for rune in sorted(freqs, reverse=True):
        if rune == 10:
            parts.append(b"%d|\\n" % freqs[rune])
        else:
            parts.append(b"%d|" % freqs[rune] + hf.rune_to_utf8(rune))
    shuffled = b"".join(parts) + hf.SEPARATOR + rest
    assert hf.decompress(shuffled) == payload


def test_go_rune_decoding_edge_cases():
    # each invalid byte is one U+FFFD of width 1, exactly like Go's range loop
    assert hf.go_decode_runes(b"\xc2") == [0xFFFD]
    assert hf.go_decode_runes(b"\xc2\xc2") == [0xFFFD, 0xFFFD]
    assert hf.go_decode_runes(b"\xe2\x82") == [0xFFFD, 0xFFFD]
    assert hf.go_decode_runes(b"\xe2\x82\xac") == [0x20AC]  # €
    assert hf.go_decode_runes(b"\xed\xa0\x80") == [0xFFFD] * 3  # surrogate rejected
    assert hf.go_decode_runes(b"\xf0\x9f\x98\x80") == [0x1F600]
    assert hf.go_decode_runes(b"abc") == [97, 98, 99]


def test_codes_complete_and_prefix_free():
    payload = VERSE
    runes = hf.go_decode_runes(payload)
    freqs = {}
    for r in runes:
        freqs[r] = freqs.get(r, 0) + 1
    tree = hf.build_tree(freqs)
    vals, bins = hf.print_codes(tree)
    assert len(vals) == len(freqs)
    assert sum(2 ** -len(b) for b in bins) == 1.0  # Kraft equality = complete code
    for i, a in enumerate(bins):
        for j, b in enumerate(bins):
            if i != j:
                assert not b.startswith(a)
