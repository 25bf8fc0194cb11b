"""Native C backends vs. host oracles — byte equality."""

import pytest

from raisin_jax import native
from raisin_jax.formats import arithmetic_ref, lzss_ref

from fixtures import HELLO, ABC, VERSE, random_bytes, random_text

CASES = [
    b"",
    b"a",
    HELLO,
    ABC,
    b"a" * 300,
    VERSE,
    b"<><>,<>",
    b"\x5c\xff<tag>\x5c\x5c",
    random_bytes(3000, seed=90),
    random_text(6000, seed=91),
]


@pytest.mark.parametrize("payload", CASES)
def test_native_lzss_matches_oracle(payload):
    got = native.lzss_compress(payload)
    assert got == lzss_ref.compress(payload)
    assert native.lzss_decompress(got) == payload


@pytest.mark.parametrize("payload", CASES)
def test_native_arithmetic_matches_oracle(payload):
    got = native.arith_compress(payload)
    assert got == arithmetic_ref.compress(payload)
    assert native.arith_decompress(got) == payload


def test_native_lzss_window_sizes():
    chunk = b"0123456789unique-pattern-here"
    data = chunk + random_bytes(5000, seed=92) + chunk
    for w in (1024, 4096, 8192):
        assert native.lzss_compress(data, window_size=w) == lzss_ref.compress(data, window_size=w)


def test_native_arithmetic_freeze_path():
    payload = random_text(20_000, seed=93)
    assert native.arith_compress(payload) == arithmetic_ref.compress(payload)
    assert native.arith_decompress(native.arith_compress(payload)) == payload


def test_native_decompress_rejects_garbage():
    with pytest.raises(ValueError):
        native.arith_decompress(b"\x00\x00\x00")  # no sentinel bit
    with pytest.raises(ValueError):
        native.lzss_decompress(b"<999,999>")  # reference outside window


def test_registered_as_native_backend():
    from raisin_jax.engine.registry import available_backends, get_codec

    assert "native" in available_backends("lzss")
    assert "native" in available_backends("arithmetic")
    codec = get_codec("arithmetic", backend="native")
    assert codec.compress(VERSE) == arithmetic_ref.compress(VERSE)


@pytest.mark.parametrize("payload", CASES)
def test_native_mcc_matches_oracle(payload):
    from raisin_jax.formats import mcc_ref

    got = native.mcc_compress(payload)
    assert got == mcc_ref.compress(payload)
    if not payload:
        # empty input encodes to just the separator, which neither the
        # reference nor the oracle can decode (Atoi("") panics, mcc.go:401)
        with pytest.raises(ValueError):
            native.mcc_decompress(got)
        return
    assert native.mcc_decompress(got) == payload
    assert mcc_ref.decompress(got) == payload


def test_native_mcc_rejects_garbage():
    with pytest.raises(ValueError):
        native.mcc_decompress(b"12,abc\\xyz")
    with pytest.raises(ValueError):
        native.mcc_decompress(b"no separator at all")


@pytest.mark.parametrize("payload", CASES)
def test_native_dmc_matches_oracle(payload):
    """Native DMC must be byte-exact vs the host oracle, including the
    DmcError cases (NUL whose only stack match is the root; dmc.go:43-51)."""
    from raisin_jax.formats import dmc_ref

    try:
        want = dmc_ref.compress(payload)
    except dmc_ref.DmcError:
        with pytest.raises(dmc_ref.DmcError):
            native.dmc_compress(payload)
        return
    assert native.dmc_compress(payload) == want


def test_native_dmc_decompress_is_reference_stub():
    # dmc.go:274-276: the reference file decoder ignores its input
    assert native.dmc_decompress(b"anything") == b"Hello!"
    assert native.dmc_decompress(b"") == b"Hello!"


def test_native_dmc_nul_root_raises():
    from raisin_jax.formats import dmc_ref

    with pytest.raises(dmc_ref.DmcError):
        native.dmc_compress(b"\x00")


def test_native_dmc_registered():
    from raisin_jax.engine.registry import get_codec

    codec = get_codec("dmc", backend="native")
    from raisin_jax.formats import dmc_ref

    assert codec.compress(VERSE) == dmc_ref.compress(VERSE)


def test_native_lzss_long_runs_fast_and_exact():
    """Uniform runs used to be O(n * window^2) in the C search (every
    position walked a full same-hash chain); the fused search+commit skips
    consumed positions. Exactness vs the oracle must hold either way."""
    from raisin_jax.formats import lzss_ref
    from raisin_jax.native import lzss_compress, lzss_decompress

    # oracle comparison at a size the (quadratic-on-runs) python oracle
    # can handle; the big case asserts round-trip + that C finishes at all
    zs = b"\x00" * 3000
    assert lzss_compress(zs, 4096) == lzss_ref.compress(zs, 4096)
    z = b"\x00" * 200000
    c = lzss_compress(z, 4096)
    assert lzss_decompress(c) == z
    rs = (b"ab" * 2000)[:3001]
    assert lzss_compress(rs, 4096) == lzss_ref.compress(rs, 4096)
    r = (b"ab" * 100000)[:200001]
    assert lzss_decompress(lzss_compress(r, 4096)) == r
