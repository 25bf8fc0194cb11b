import pytest

from raisin_jax.formats import mcc_ref as mcc

from fixtures import HELLO, ABC, VERSE, random_bytes, random_text


@pytest.mark.parametrize(
    "payload",
    [
        HELLO,
        ABC,
        VERSE,
        b"a",
        b"aaaa",
        b"\x00\x01\x02\x00\x01\x02",
        random_bytes(500, seed=9),
        random_text(2000, seed=10),
    ],
)
def test_roundtrip(payload):
    assert mcc.decompress(mcc.compress(payload)) == payload


def test_wire_format_shape():
    out = mcc.compress(b"abcabc")
    sep = out.index(mcc.SEPARATOR)
    head = out[:sep]
    assert all(c in b"0123456789," for c in head)
    # literals come after the separator in first-occurrence order
    assert out[sep + 1 :] == b"abc"


def test_empty_input_parity():
    # reference: empty stream -> Atoi("") panics on decode (mcc.go:401)
    compressed = mcc.compress(b"")
    assert compressed == b"\\"
    with pytest.raises(ValueError):
        mcc.decompress(compressed)


def test_token_frequency_ramp():
    root = mcc._create_root()
    freqs = [s.freq for s in root.transitions]
    assert freqs == [900, 800, -100, -200, -300, -400, -500, -600, -700, -800]
    tokens = [s.token for s in root.transitions]
    assert tokens == [0, 1, 2, 4, 8, 16, 32, 64, 128, 256]


def test_frequency_tie_round_trips():
    """Adversarial frequency ties.

    Go's unstable sort.Slice (mcc.go:80) may order tied transitions
    differently from our stable sort, so reference-produced files with ties
    could use different indices — but our encoder/decoder pair performs the
    identical stable sorts, so every tie-heavy input must round-trip.
    """
    cases = [
        b"abababab" * 8,              # two symbols, permanently tied
        b"abcabcabc" * 8,             # three-way rotating ties
        bytes(range(16)) * 10,        # many symbols, all tied
        b"aabbaabbccddccdd" * 6,      # pairwise ties with promotions
        b"zyxzyx" + b"xyzxyz" * 10,   # tie then dominance flip
    ]
    for payload in cases:
        assert mcc.decompress(mcc.compress(payload)) == payload
