import pytest

from raisin_jax.formats import dmc_ref as dmc

from fixtures import VERSE, random_text


def test_stub_decompress_parity():
    # reference dmc.Decompress is a stub returning "Hello!" (dmc.go:274)
    assert dmc.decompress(b"anything") == b"Hello!"


def test_compress_emits_int8_stream():
    out = dmc.compress(b"abcabcabc")
    assert isinstance(out, bytes)
    assert len(out) >= 2  # at least the end marker


def test_nul_byte_raises_like_reference():
    # root.Value == 0, so a NUL whose only match is the root empties the
    # stack and the reference panics (dmc.go:43-51)
    with pytest.raises(dmc.DmcError):
        dmc.compress(b"\x00")


@pytest.mark.parametrize("payload", [b"abcabcabc", b"mississippi river", VERSE[:400], random_text(300, seed=11)])
def test_in_memory_decode_roundtrip(payload):
    # the honest in-memory decoder (GetOutputFromBits port) round-trips
    chain = dmc.build_chain(payload)
    dmc._sort_nodes(chain)
    transitions = dmc.chain_to_transitions(chain, payload)
    assert dmc.decode_with_chain(transitions, chain) == payload
