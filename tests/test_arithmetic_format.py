import pytest

from raisin_jax.formats import arithmetic_ref as ar

from fixtures import HELLO, ABC, VERSE, random_bytes, random_text


def test_empty_input_golden():
    # Empty input encodes only EOF: eight 1-bits, prepad 0000_0001 -> 0x01 0xFF.
    assert ar.compress(b"") == b"\x01\xff"
    assert ar.decompress(b"\x01\xff") == b""


def test_hello_world_ratio_parity():
    # Reference README.md:154: "Hello world!" (13 B incl. newline) -> 107.69% = 14 B.
    compressed = ar.compress(b"Hello world!\n"[:13])
    assert len(compressed) == 14


@pytest.mark.parametrize(
    "payload",
    [
        HELLO,
        ABC,
        VERSE,
        b"\x00",
        b"\xff" * 100,
        bytes(range(256)),
        random_bytes(2000, seed=1),
        random_text(5000, seed=2),
    ],
)
def test_roundtrip(payload):
    assert ar.decompress(ar.compress(payload)) == payload


def test_roundtrip_through_freeze():
    # >16383 total symbol count exercises the model freeze path.
    payload = random_text(40_000, seed=3)
    assert ar.decompress(ar.compress(payload)) == payload


def test_model_freeze_semantics():
    m = ar.Model()
    for _ in range(17_000):
        m.probability(65)
    assert m.frozen
    assert m.count() >= ar.MAX_FREQ
    frozen_count = m.count()
    m.probability(65)  # frozen: no further updates
    assert m.count() == frozen_count
