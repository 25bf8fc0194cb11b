import pytest

from raisin_jax.formats import stdlib_codecs as sc

from fixtures import HELLO, VERSE, random_bytes, random_text

PAYLOADS = [b"", HELLO, VERSE, random_bytes(10_000, seed=12), random_text(50_000, seed=13)]


@pytest.mark.parametrize("payload", PAYLOADS)
def test_flate_roundtrip(payload):
    assert sc.flate_decompress(sc.flate_compress(payload)) == payload


@pytest.mark.parametrize("payload", PAYLOADS)
def test_gzip_roundtrip(payload):
    assert sc.gzip_decompress(sc.gzip_compress(payload)) == payload


@pytest.mark.parametrize("payload", PAYLOADS)
def test_zlib_roundtrip(payload):
    assert sc.zlib_decompress(sc.zlib_compress(payload)) == payload


@pytest.mark.parametrize("payload", PAYLOADS)
def test_lzw_roundtrip(payload):
    assert sc.lzw_decompress(sc.lzw_compress(payload)) == payload


def test_lzw_table_reset_roundtrip():
    # enough distinct digrams to overflow the 12-bit code space several times
    payload = random_bytes(200_000, seed=14)
    assert sc.lzw_decompress(sc.lzw_compress(payload)) == payload


def test_lzw_kwkwk_case():
    # classic LZW corner: cScSc pattern forces code == hi at the decoder
    payload = b"ababababababab" * 10
    assert sc.lzw_decompress(sc.lzw_compress(payload)) == payload


def test_gzip_deterministic():
    assert sc.gzip_compress(VERSE) == sc.gzip_compress(VERSE)
