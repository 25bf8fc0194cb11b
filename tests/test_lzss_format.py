import pytest

from raisin_jax.formats import lzss_ref as lz

from fixtures import HELLO, ABC, VERSE, random_bytes, random_text


def test_escape_pass_golden():
    assert lz.encode_opening_symbols(b"<") == b"\xff"
    assert lz.encode_opening_symbols(b"\xff") == b"\x5c\xff"
    assert lz.encode_opening_symbols(b"\x5c") == b"\x5c\x5c"
    assert lz.encode_opening_symbols(b"a<b\xffc\x5cd") == b"a\xffb\x5c\xffc\x5c\x5cd"
    for raw in (b"<", b"\xff", b"\x5c", b"a<b\xffc\x5cd", b"<<\x5c\xff>>"):
        assert lz.decode_opening_symbols(lz.encode_opening_symbols(raw)) == raw


def test_hello_world_parity():
    # Reference README.md:153: lzss leaves 13-byte test.txt at 100.00% (no
    # reference shorter than its token), byte-identical passthrough.
    data = b"Hello world!\n"[:13]
    assert lz.compress(data) == data


def test_abc_compresses():
    # README.md:165 reports 84.00% for its (unpublished) abcabc… file; on our
    # 25-byte fixture the exact greedy semantics give "abcabc<6,6><12,12>a".
    assert lz.compress(ABC) == b"abcabc<6,6><12,12>a"
    assert lz.decompress(lz.compress(ABC)) == ABC


def test_token_format():
    # 30 'a's: position 1 matches 'a' at distance 1; greedy longest match
    # covers the rest of the input that fits in the prefix-window rule.
    data = b"a" * 30
    out = lz.compress(data)
    assert out.startswith(b"a")
    assert b"<" in out and b"," in out and b">" in out
    assert lz.decompress(out) == data


@pytest.mark.parametrize(
    "payload",
    [
        HELLO,
        ABC,
        VERSE,
        b"",
        b"<><>,<>",
        b"\x5c\xff<tag>\x5c\x5c",
        random_bytes(3000, seed=6),
        random_text(6000, seed=7),
    ],
)
def test_roundtrip(payload):
    assert lz.decompress(lz.compress(payload)) == payload


def test_window_limits_matches():
    # A repeat 5000 bytes apart is outside the 4096-byte window: no reference.
    chunk = b"0123456789unique-pattern-here"
    filler = random_bytes(5000, seed=8)
    data = chunk + filler + chunk
    refs = lz.find_matches(lz.encode_opening_symbols(data), 4096)
    # ...but with a bigger window it is found.
    refs_big = lz.find_matches(lz.encode_opening_symbols(data), 8192)
    pos = len(lz.encode_opening_symbols(chunk + filler))
    assert refs_big[pos][1] >= refs[pos][1]
    assert lz.decompress(lz.compress(data, 8192)) == data


def test_leftmost_occurrence_distance():
    # "abcXabcYabc": final "abc" occurs at offsets 0 and 4; leftmost wins.
    data = b"abcXabcYabc"
    enc = lz.encode_opening_symbols(data)
    refs = lz.find_matches(enc, 4096)
    dist, length = refs[8]
    assert length == 3
    assert dist == 8  # leftmost occurrence (position 0), not position 4


def test_commit_skips_positions():
    # After a committed match of length L, the next L-1 positions' refs are
    # consumed even when the token is not emitted (raw bytes path).
    data = b"abcdefabcdefabcdef"
    out = lz.compress(data)
    assert lz.decompress(out) == data
    assert out.count(b"<") >= 1
