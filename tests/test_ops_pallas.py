"""Device kernels of the container path against the XLA references and the
host oracles.

The arithmetic kernels (ops/arithmetic_gpu, Pallas through Triton) run here
in interpret mode; on the GPU they are what `arithmetic_scan` lowers to, so
an exact match with the XLA scans keeps one wrong edit from reaching the
card. The XLA LZSS stages (match, commit, token decode) are compared with
the oracles directly. Tests marked ``gpu`` compile the kernels for the card.
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax import export  # noqa: E402

from raisin_jax.formats import arithmetic_ref, lzss_ref  # noqa: E402
from raisin_jax.ops import arithmetic_gpu as ag  # noqa: E402
from raisin_jax.ops import arithmetic_scan, lzss_jax, pipeline_jax  # noqa: E402
from fixtures import VERSE, random_text  # noqa: E402

S = 512  # steps for the shared-shape cases


def _cases() -> dict[str, bytes]:
    rng = np.random.default_rng(7)
    return {
        "empty": b"",
        "one_byte": b"a",
        "hello": b"hello world, hello world, hello",
        "ff_run": b"\xff" * (S - 20),
        "ab_run": (b"ab" * S)[: S - 13],
        "binary": bytes(rng.integers(0, 256, size=S - 40, dtype=np.uint8)),
        "verse": (VERSE * 6)[: S - 9],
        "escape_heavy": b"<<<<,,,>>>>" * 8,
        # > MAX_FREQ - 257 symbols: the model freezes mid-block
        "freeze": (VERSE * 60)[:17000],
    }


CASES = _cases()


def _batch(payloads: list[bytes], steps: int):
    pay = np.zeros((len(payloads), steps), dtype=np.uint8)
    lens = np.zeros(len(payloads), dtype=np.int32)
    for i, p in enumerate(payloads):
        pay[i, : len(p)] = np.frombuffer(p, dtype=np.uint8)
        lens[i] = len(p)
    return pay, lens


def _steps(p: bytes) -> int:
    return S if len(p) < S else (len(p) + 1 + 511) // 512 * 512


def _max_bits(steps: int) -> int:
    # the container's practical first try: 9 bits per symbol
    return (9 * steps + 32 + 7) // 8 * 8


@pytest.mark.parametrize("name", list(CASES))
def test_arith_encode_kernel_matches_scan_and_oracle(name):
    p = CASES[name]
    steps = _steps(p)
    pay, lens = _batch([p], steps)
    cap = len(p) * 2 + 64
    got = ag.encode_packed(jnp.asarray(pay), jnp.asarray(lens), cap, _max_bits(steps), interpret=True)
    want = arithmetic_scan._encode_packed_xla(
        jnp.asarray(pay), jnp.asarray(lens), steps, cap, _max_bits(steps)
    )
    flat, blen, oflow = (np.asarray(a) for a in got)
    assert not oflow.any()
    assert np.array_equal(blen, np.asarray(want[1]))
    assert np.array_equal(flat, np.asarray(want[0]))
    assert flat[: blen[0]].tobytes() == arithmetic_ref.compress(p)


@pytest.mark.parametrize("name", list(CASES))
def test_arith_decode_kernel_matches_scan_and_oracle(name):
    p = CASES[name]
    steps = _steps(p)
    enc = arithmetic_ref.compress(p)
    flat = np.zeros(len(enc) + 64, dtype=np.uint8)
    flat[: len(enc)] = np.frombuffer(enc, dtype=np.uint8)
    args = (
        jnp.asarray(flat),
        jnp.asarray([0], dtype=jnp.int32),
        jnp.asarray([len(enc)], dtype=jnp.int32),
        jnp.asarray([len(p)], dtype=jnp.int32),
    )
    blocks, eof = ag.decode_packed(*args, num_steps=steps, interpret=True)
    ref_blocks, ref_eof = arithmetic_scan._decode_packed_xla(
        *args, num_steps=steps, max_bytes=len(flat)
    )
    assert bool(eof[0]) and bool(ref_eof[0])
    assert np.array_equal(np.asarray(blocks), np.asarray(ref_blocks))
    assert np.asarray(blocks)[0, : len(p)].tobytes() == p


@pytest.mark.parametrize("B", [3, 5])
def test_arith_kernels_ragged_batch_roundtrip(B):
    """Several blocks of ragged lengths in one batch: per-block lengths,
    concatenation offsets and the decode of the concatenated buffer."""
    payloads = [random_text(37 * (i + 1) + 11 * B, seed=i) for i in range(B)]
    pay, lens = _batch(payloads, S)
    cap = 4096
    flat, blen, oflow = ag.encode_packed(
        jnp.asarray(pay), jnp.asarray(lens), cap, _max_bits(S), interpret=True
    )
    flat, blen = np.asarray(flat), np.asarray(blen)
    assert not np.asarray(oflow).any()
    offs = np.concatenate([[0], np.cumsum(blen)[:-1]]).astype(np.int32)
    for i, p in enumerate(payloads):
        assert flat[offs[i] : offs[i] + blen[i]].tobytes() == arithmetic_ref.compress(p)
    blocks, eof = ag.decode_packed(
        jnp.asarray(flat), jnp.asarray(offs), jnp.asarray(blen), jnp.asarray(lens),
        num_steps=S, interpret=True,
    )
    blocks = np.asarray(blocks)
    assert np.asarray(eof).all()
    for i, p in enumerate(payloads):
        assert blocks[i, : len(p)].tobytes() == p
        assert not blocks[i, len(p) :].any()  # zero past the block


def test_arith_encode_kernel_reports_true_length_past_capacity():
    """A block larger than the per-block capacity still reports its true
    byte length, which is what makes the caller retry at the proven bound."""
    p = CASES["binary"]
    pay, lens = _batch([p], S)
    want = len(arithmetic_ref.compress(p))
    _, blen, _ = ag.encode_packed(jnp.asarray(pay), jnp.asarray(lens), 4096, 64 * 8, interpret=True)
    assert int(blen[0]) == want > 64


_DC = [export.DisabledSafetyCheck.custom_call("__gpu$xla.gpu.triton")]


def _lowered(fn, platform, *avals) -> str:
    checks = _DC if platform == "cuda" else []
    return export.export(jax.jit(fn), platforms=[platform], disabled_checks=checks)(*avals).mlir_module()


@pytest.mark.parametrize("which", ["encode", "decode"])
def test_kernel_choice_by_platform(which):
    """The kernel is chosen in one place, by the platform lowered for: CUDA
    gets the Triton kernel (this also checks that it lowers), the CPU the
    XLA scan."""
    i32 = jax.ShapeDtypeStruct((4,), jnp.int32)
    if which == "encode":
        fn = lambda p, n: arithmetic_scan.encode_blocks_packed(p, n, 1024, 8192)  # noqa: E731
        avals = (jax.ShapeDtypeStruct((4, 1024), jnp.uint8), i32)
    else:
        fn = lambda f, o, b, n: arithmetic_scan.decode_blocks_packed(  # noqa: E731
            f, o, b, n, num_steps=1024, max_bytes=512
        )
        avals = (jax.ShapeDtypeStruct((4096,), jnp.uint8), i32, i32, i32)
    cuda = _lowered(fn, "cuda", *avals)
    cpu = _lowered(fn, "cpu", *avals)
    assert cuda.count("xla.gpu.triton") == 1
    assert "xla.gpu.triton" not in cpu and "stablehlo.while" in cpu


def _token_cases() -> dict[str, bytes]:
    rng = np.random.default_rng(3)
    return {
        "repeats": b"hello world, hello world, hello world!",
        "run": b"a" * 900,
        "ab": (b"ab" * 300)[:577],
        "small_alphabet": bytes(rng.integers(0, 8, 800, dtype=np.uint8) + 97),
        "verse": VERSE[:900],
        "one_byte": b"x",
        "empty": b"",
        "escape_heavy": b"<<<<,,,>>>>" * 10,
        "escape_bytes": b"\x5c\xff<" * 50,
        "binary": bytes(rng.integers(0, 256, 700, dtype=np.uint8)),
    }


TOKEN_CASES = _token_cases()


@pytest.mark.parametrize("name", list(TOKEN_CASES))
def test_lzss_decode_blocks_matches_oracle(name):
    """XLA token decode vs the escaped plaintext the oracle encoded."""
    enc = lzss_ref.encode_opening_symbols(TOKEN_CASES[name])
    toks = lzss_ref.commit_tokens(enc, lzss_ref.find_matches(enc, 4096))
    tok = np.zeros((1, 1024), dtype=np.uint8)
    tok[0, : len(toks)] = np.frombuffer(toks, dtype=np.uint8)
    out, olen = lzss_jax.decode_blocks(
        jnp.asarray(tok), jnp.asarray([len(toks)], dtype=jnp.int32), cap_out=2048
    )
    assert int(olen[0]) == len(enc)
    assert np.asarray(out)[0, : len(enc)].tobytes() == enc


@pytest.mark.parametrize("with_arith", [False, True])
def test_commit_and_fused_encode_match_compress_bytes(with_arith):
    """XLA commit (pointer doubling) and the fused lzss_encode_packed vs the
    host pipeline, block by block."""
    from raisin_jax.engine.core import compress_bytes

    payloads = [random_text(900), b"compression " * 60, b"", b"<x>\xff\\" * 30]
    encs = [lzss_ref.encode_opening_symbols(p) for p in payloads]
    Sx = 1024
    x = np.zeros((len(encs), Sx), dtype=np.uint8)
    lengths = np.zeros(len(encs), dtype=np.int32)
    for i, e in enumerate(encs):
        x[i, : len(e)] = np.frombuffer(e, dtype=np.uint8)
        lengths[i] = len(e)
    flat, out_lens, tok_lens, oflow = pipeline_jax.lzss_encode_packed(
        jnp.asarray(x), jnp.asarray(lengths), window=4096, cap_bytes=8192,
        with_arith=with_arith,
    )
    flat, out_lens = np.asarray(flat), np.asarray(out_lens)
    assert not np.asarray(oflow).any()
    algos = ["lzss", "arithmetic"] if with_arith else ["lzss"]
    off = 0
    for i, p in enumerate(payloads):
        assert flat[off : off + out_lens[i]].tobytes() == compress_bytes(p, algos), i
        assert int(tok_lens[i]) == len(compress_bytes(p, ["lzss"]))
        off += int(out_lens[i])


def test_lzss_arith_decode_pipeline_maps_escapes():
    """Fused device decode: rows come back unescaped for blocks with no
    escape pair, escaped (and flagged) for the others."""
    payloads = [b"a<b<c plain text < " * 20, b"esc\\ape \xff here " * 10, b"z" * 300]
    toks = [lzss_ref.compress(p) for p in payloads]
    encs = [arithmetic_ref.compress(t) for t in toks]
    flat = np.frombuffer(b"".join(encs) + bytes(64), dtype=np.uint8)
    lens = np.array([len(e) for e in encs], dtype=np.int32)
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int32)
    tl = np.array([len(t) for t in toks], dtype=np.int32)
    rows, out_len, eof, esc = pipeline_jax.lzss_arith_decode(
        jnp.asarray(flat), jnp.asarray(offs), jnp.asarray(lens), jnp.asarray(tl),
        num_steps=1024, max_bytes=1024, cap_out=4096,
    )
    rows, out_len, esc = np.asarray(rows), np.asarray(out_len), np.asarray(esc)
    assert np.asarray(eof).all()
    assert esc.tolist() == [False, True, False]
    for i, p in enumerate(payloads):
        got = rows[i, : out_len[i]].tobytes()
        want = p if not esc[i] else lzss_ref.encode_opening_symbols(p)
        assert got == want, i


@pytest.mark.parametrize("window", [4096, 2048, 1000])
def test_match_scan_oracle_exact_windows(window):
    """The XLA tiled match scan vs the oracle."""
    Sx = 1024
    payloads = [CASES[k][: Sx - 8] for k in CASES if k != "freeze"]
    # window-edge content: long runs that match across the whole window
    payloads.append(b"z" * (Sx - 5))
    payloads.append((b"xy" * Sx)[: Sx - 1])
    encs = [lzss_ref.encode_opening_symbols(p) for p in payloads]
    B = len(encs)
    x = np.full((B, Sx), -1, dtype=np.int32)
    lengths = np.zeros(B, dtype=np.int32)
    for i, e in enumerate(encs):
        x[i, : len(e)] = np.frombuffer(e, dtype=np.uint8)[:Sx]
        lengths[i] = min(len(e), Sx)
    Ls, Ds = lzss_jax.find_matches_blocks(x, lengths, window, Sx // lzss_jax.TILE)
    Ls, Ds = np.asarray(Ls), np.asarray(Ds)
    for i, e in enumerate(encs):
        want = lzss_ref.find_matches(e[:Sx], window)
        for p, (wd, wl) in enumerate(want):
            assert (Ls[i, p], Ds[i, p]) == (wl, wd), (i, p)


def test_huffman_blocks_roundtrip_oracle_exact():
    """Device-batched Huffman encode/decode (XLA) vs the host oracle."""
    from raisin_jax.ops import huffman_blocks as hb

    rng = np.random.default_rng(3)
    blocks = [
        b"hello world, hello world, hello huffman",
        bytes(rng.integers(32, 127, size=900, dtype=np.uint8)),
        b"aaaaabbbbccd" * 40,
        bytes(rng.integers(0, 128, size=333, dtype=np.uint8)),
        b"ab",
        b"\x00\x01\x02\x03" * 64,  # low ASCII incl. NUL
    ]
    enc = hb.encode_blocks(blocks)
    for i, b in enumerate(blocks):
        assert enc[i] == hb.hf.compress(b), f"block {i}: encode != oracle"
    dec = hb.decode_blocks(enc)
    for i, b in enumerate(blocks):
        assert dec[i] == b, f"block {i}: decode round-trip failed"


@pytest.mark.gpu
def test_kernels_on_card_match_scan(gpu):
    """Compiled for the card: both kernels at a real block width, against
    the XLA scans on the same device."""
    from bench import make_corpus

    data = make_corpus(64 * 65536, seed=1)
    blocks = [data[i : i + 65536] for i in range(0, len(data), 65536)]
    steps = 65536 + 128
    pay, lens = _batch(blocks, steps)
    cap = 1 << 24
    mbits = (9 * steps + 32 + 7) // 8 * 8
    got = ag.encode_packed(jnp.asarray(pay), jnp.asarray(lens), cap, mbits)
    want = arithmetic_scan._encode_packed_xla(jnp.asarray(pay), jnp.asarray(lens), steps, cap, mbits)
    assert np.array_equal(np.asarray(got[1]), np.asarray(want[1]))
    assert np.array_equal(np.asarray(got[0]), np.asarray(want[0]))
    blen = np.asarray(got[1])
    offs = np.concatenate([[0], np.cumsum(blen)[:-1]]).astype(np.int32)
    args = (got[0], jnp.asarray(offs), jnp.asarray(blen), jnp.asarray(lens))
    d1 = ag.decode_packed(*args, num_steps=steps)
    d2 = arithmetic_scan._decode_packed_xla(*args, num_steps=steps, max_bytes=1 << 17)
    assert np.array_equal(np.asarray(d1[0]), np.asarray(d2[0]))
    assert np.asarray(d1[1]).all()
