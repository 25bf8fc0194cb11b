"""Adaptive arithmetic coder as Pallas kernels for the GPU (Triton route).

Same coder as ops/arithmetic_scan (reference compressor/arithmetic), laid out
for a GPU: one program per coder block, the whole symbol loop inside the
program (``lax.fori_loop``), so a block costs one launch instead of one scan
iteration per symbol.

- The 258-entry cumulative model is one 512-lane vector held by one warp.
  A lookup is a masked reduction, an update a masked add; the total count is
  a scalar (it grows by one per unfrozen update).
- The 16 renormalization iterations are unrolled on scalars.
- Encode packs bits in the kernel. Each step appends, MSB first: the step's
  first emission with its carried pending bits, then the rest of the step
  (at most 15 bits). A 32-bit accumulator holds fewer than 8 bits between
  appends; whole bytes go out as one masked 4-byte store. The sentinel
  prepad (bits.go:48) depends on the final bit count, so the kernel writes
  the unshifted stream and ``encode_packed`` shifts it while concatenating.
- Decode reads the packed payload bytes directly: before each step's
  renormalization it loads a 24-bit window at the current bit position (a
  step consumes at most 16 bits). Byte ``len`` reads as 0x80 and later bytes
  as 0, which is the decoder's [1, 0] tail and zero fill (arithmetic.go:48).

Both kernels are exact: tests compare them with the XLA scans in interpret
mode, and ``arithmetic_scan`` picks them only when lowering for CUDA.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from raisin_jax.ops.arithmetic_scan import (
    EOF,
    MAX_CODE,
    MAX_FREQ,
    ONE_FOURTH,
    ONE_HALF,
    RENORM_ITERS,
    THREE_FOURTHS,
)

LANES = 512  # model vector width: 258 entries, padded to a power of two
# Pending bits a first emission can carry: two 24-bit appends minus the bit.
# More than that in a row never happens on real data; such a block is
# flagged and re-encoded on the host.
MAX_CARRIED = 47

_PARAMS = plgpu.CompilerParams(num_warps=1, num_stages=1)


def _div(a, b):
    # operands are non-negative, so truncation is floor division
    return jax.lax.div(a, b)


def _not(x):
    # the Triton lowering of `~` rejects constant operands
    return x == False  # noqa: E712


def _i32(x):
    return x.astype(jnp.int32)


def _ones(k):
    return (jnp.int32(1) << k) - 1


# ---------------------------------------------------------------------------
# Encode


def _encode_kernel(sym_ref, len_ref, out_ref, bits_ref, oflow_ref):
    b = pl.program_id(0)
    n = len_ref[b]
    S = sym_ref.shape[1]
    cap = out_ref.shape[1] - 4  # 4 bytes of slack keep masked stores in bounds
    iota = jnp.arange(LANES, dtype=jnp.int32)
    j4 = jnp.arange(4, dtype=jnp.int32)

    def put(st, v, k):
        """Append the k (0..24) low bits of v, MSB first."""
        acc, nacc, opos = st
        acc = (acc << k) | v
        nacc = nacc + k
        nb = nacc >> 3
        vals = (acc >> jnp.maximum(nacc - 8 * (j4 + 1), 0)) & 0xFF
        at = jnp.minimum(opos, cap)
        plgpu.store(
            out_ref.at[b, pl.ds(at, 4)],
            vals.astype(jnp.uint8),
            mask=(j4 < nb) & (opos + j4 < cap),
        )
        nacc = nacc & 7
        return acc & _ones(nacc), nacc, opos + nb

    def load_sym(i):
        s = sym_ref[b, jnp.minimum(i, S - 1)].astype(jnp.int32)
        return jnp.where(i < n, s, EOF)

    def step(i, c):
        low, high, pending, cum, count, frozen, sym, st, total, oflow = c
        nxt = load_sym(i + 1)  # issued early: the next step's symbol

        difference = high - low + 1
        pair = jnp.sum(
            jnp.where(iota == sym, cum, 0) + jnp.where(iota == sym + 1, cum << 16, 0)
        )
        lower = pair & 0xFFFF
        upper = pair >> 16
        high = low + _div(difference * upper, count) - 1
        low = low + _div(difference * lower, count)

        # model update; the reference freezes after the triggering update
        upd = _not(frozen)
        cum = jnp.where(upd & (iota > sym), cum + 1, cum)
        count = count + _i32(upd)
        frozen = frozen | (count >= MAX_FREQ)

        has_emitted = jnp.bool_(False)
        done = jnp.bool_(False)
        b0 = jnp.int32(0)
        p0 = jnp.int32(0)
        rest = jnp.int32(0)
        rest_len = jnp.int32(0)
        for _ in range(RENORM_ITERS):
            e1 = high < ONE_HALF
            e2 = low >= ONE_HALF
            e3 = (low >= ONE_FOURTH) & (high < THREE_FOURTHS)
            cont = (e1 | e2 | e3) & _not(done)
            emit = (e1 | e2) & cont
            straddle = e3 & _not(e1) & _not(e2) & cont
            bit = _i32(e2)

            first = emit & _not(has_emitted)
            later = emit & has_emitted
            b0 = jnp.where(first, bit, b0)
            p0 = jnp.where(first, pending, p0)
            # a later emission flushes at most 15 in-step pending bits
            run = jnp.where(bit == 0, _ones(pending), 0)
            rest = jnp.where(later, (rest << (pending + 1)) | (bit << pending) | run, rest)
            rest_len = jnp.where(later, rest_len + pending + 1, rest_len)
            has_emitted = has_emitted | emit

            pending = jnp.where(emit, 0, jnp.where(straddle, pending + 1, pending))
            sub = _i32(straddle) * ONE_FOURTH + _i32(e2) * ONE_HALF  # exclusive
            low = jnp.where(cont, (low - sub) << 1, low)
            high = jnp.where(cont, ((high - sub) << 1) + 1, high)
            done = done | _not(cont)

        # first emission: its bit, then p0 copies of the other bit
        p1 = jnp.where(has_emitted, jnp.minimum(p0, 23), 0)
        p2 = jnp.where(has_emitted, jnp.clip(p0 - 23, 0, 24), 0)
        inv = 1 - b0
        st = put(st, (b0 << p1) | (inv * _ones(p1)), jnp.where(has_emitted, p1 + 1, 0))
        st = put(st, inv * _ones(p2), p2)
        st = put(st, rest, rest_len)
        total = total + jnp.where(has_emitted, p0 + 1, 0) + rest_len
        oflow = oflow | (has_emitted & (p0 > MAX_CARRIED))
        return low, high, pending, cum, count, frozen, nxt, st, total, oflow

    init = (
        jnp.int32(0),
        jnp.int32(MAX_CODE),
        jnp.int32(0),
        iota,
        jnp.int32(257),
        jnp.bool_(False),
        load_sym(jnp.int32(0)),
        (jnp.int32(0), jnp.int32(0), jnp.int32(0)),
        jnp.int32(0),
        jnp.bool_(False),
    )
    out = jax.lax.fori_loop(0, n + 1, step, init)
    st, total, oflow = out[7], out[8], out[9]
    st = put(st, jnp.int32(0), (8 - st[1]) & 7)  # flush the last partial byte
    bits_ref[b] = total
    oflow_ref[b] = oflow.astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("cap", "interpret"))
def encode_stream(payload: jax.Array, lengths: jax.Array, cap: int, interpret: bool = False):
    """Run the encoder over B blocks.

    Args:
      payload: (B, S) uint8 block bytes (values at and past ``lengths`` are
        ignored; the EOF symbol is coded after ``lengths[b]`` symbols).
      lengths: (B,) int32.
      cap: static per-block output capacity in bytes.

    Returns (stream (B, cap + 4) uint8: the unpadded bitstream, MSB first,
    bytes past ``cap`` dropped; total_bits (B,) int32, the true bit count even
    when it overflows ``cap``; oflow (B,) bool, a carried pending run longer
    than MAX_CARRIED bits).
    """
    B = payload.shape[0]
    stream, total, oflow = pl.pallas_call(
        _encode_kernel,
        out_shape=(
            jax.ShapeDtypeStruct((B, cap + 4), jnp.uint8),
            jax.ShapeDtypeStruct((B,), jnp.int32),
            jax.ShapeDtypeStruct((B,), jnp.int32),
        ),
        grid=(B,),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)] * 2,
        out_specs=[pl.BlockSpec(memory_space=pl.ANY)] * 3,
        backend="triton",
        compiler_params=_PARAMS,
        interpret=interpret,
        name="arith_encode",
    )(payload, lengths.astype(jnp.int32))
    return stream, total, oflow != 0


def encode_packed(payload, lengths, cap_bytes: int, max_bits: int, interpret: bool = False):
    """Kernel encode, sentinel prepad and concatenation: the contract of
    ``arithmetic_scan.encode_blocks_packed`` (flat, byte_lens, oflow)."""
    cap = max_bits // 8
    stream, total, oflow = encode_stream(payload, lengths, cap, interpret=interpret)
    pad = 8 - total % 8  # 1..8 prepad bits, 0...01
    byte_lens = (total + pad) // 8
    B = stream.shape[0]
    ends = jnp.cumsum(byte_lens)
    o = jnp.arange(cap_bytes, dtype=jnp.int32)
    blk = jnp.clip(jnp.searchsorted(ends, o, side="right"), 0, B - 1)
    k = o - (ends[blk] - byte_lens[blk])
    cur = stream[blk, jnp.clip(k, 0, cap - 1)].astype(jnp.int32)
    prev = jnp.where(k > 0, stream[blk, jnp.clip(k - 1, 0, cap - 1)].astype(jnp.int32), 1)
    flat = ((prev << 8 | cur) >> pad[blk]) & 0xFF
    flat = jnp.where(o < ends[-1], flat, 0).astype(jnp.uint8)
    return flat, byte_lens, oflow


# ---------------------------------------------------------------------------
# Decode


def _decode_kernel(flat_ref, off_ref, blen_ref, olen_ref, out_ref, eof_ref):
    b = pl.program_id(0)
    off = off_ref[b]
    nbytes = blen_ref[b]
    n = olen_ref[b]
    F = flat_ref.shape[0]
    S = out_ref.shape[1]
    iota = jnp.arange(LANES, dtype=jnp.int32)

    def byte(i):
        v = flat_ref[jnp.clip(off + i, 0, F - 1)].astype(jnp.int32)
        return jnp.where(i < nbytes, v, _i32(i == nbytes) * 0x80)

    def window(rp):
        """24 stream bits from raw bit position rp, next bit at bit 23."""
        k = rp >> 3
        w = (byte(k) << 16) | (byte(k + 1) << 8) | byte(k + 2)
        return (w << (rp & 7)) & 0xFFFFFF

    b0 = byte(jnp.int32(0))
    # payload starts after the sentinel: the first 1 bit of byte 0
    bitlen = sum(_i32(b0 >= (1 << s)) for s in range(8))
    rp0 = 9 - bitlen

    def step(i, c):
        value, low, high, rp, cum, count, frozen, eof_ok = c
        w = window(rp)
        difference = high - low + 1
        scaled = _div((value - low + 1) * count - 1, difference)
        # cum is strictly increasing: sym is the last index <= 256 with
        # cum <= scaled, upper the next entry (cum[257] when clamped)
        key = jnp.where((cum <= scaled) & (iota <= EOF), (cum << 9) | iota, -1)
        best = jnp.max(key)
        sym = best & 511
        lower = best >> 9
        upper = jnp.min(
            jnp.where(
                ((cum > scaled) | (iota == 257)) & (iota >= 1) & (iota <= 257),
                cum,
                jnp.int32(1 << 30),
            )
        )
        upd = _not(frozen)
        cum = jnp.where(upd & (iota > sym), cum + 1, cum)
        count_new = count + _i32(upd)
        frozen = frozen | (count_new >= MAX_FREQ)

        act = sym != EOF
        high = jnp.where(act, low + _div(difference * upper, count) - 1, high)
        low = jnp.where(act, low + _div(difference * lower, count), low)
        done = _not(act)
        used = jnp.int32(0)
        for _ in range(RENORM_ITERS):
            e1 = high < ONE_HALF
            e2 = low >= ONE_HALF
            e3 = (low >= ONE_FOURTH) & (high < THREE_FOURTHS)
            cont = (e1 | e2 | e3) & _not(done)
            sub = jnp.where(e2, ONE_HALF, _i32(e3 & _not(e1)) * ONE_FOURTH)
            nxt = (w >> (23 - used)) & 1
            value = jnp.where(cont, ((value - sub) << 1) + nxt, value)
            low = jnp.where(cont, (low - sub) << 1, low)
            high = jnp.where(cont, ((high - sub) << 1) + 1, high)
            used = used + _i32(cont)
            done = done | _not(cont)

        out_ref[b, i] = (sym & 0xFF).astype(jnp.uint8)  # step n is zeroed below
        eof_ok = jnp.where(i == n, sym == EOF, eof_ok)
        return value, low, high, rp + used, cum, count_new, frozen, eof_ok

    init = (
        window(rp0) >> 8,
        jnp.int32(0),
        jnp.int32(MAX_CODE),
        rp0 + 16,
        iota,
        jnp.int32(257),
        jnp.bool_(False),
        jnp.bool_(False),
    )
    out = jax.lax.fori_loop(0, jnp.minimum(n + 1, S), step, init)
    eof_ref[b] = out[7].astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("num_steps", "interpret"))
def decode_packed(
    flat: jax.Array,
    byte_offsets: jax.Array,
    byte_lens: jax.Array,
    out_lens: jax.Array,
    num_steps: int,
    interpret: bool = False,
):
    """Kernel decode with the contract of ``arithmetic_scan.decode_blocks_packed``.

    Returns (blocks (B, num_steps) uint8, zero past ``out_lens``; eof_ok (B,)).
    """
    B = byte_offsets.shape[0]
    i32 = jnp.int32
    blocks, eof = pl.pallas_call(
        _decode_kernel,
        out_shape=(
            jax.ShapeDtypeStruct((B, num_steps), jnp.uint8),
            jax.ShapeDtypeStruct((B,), jnp.int32),
        ),
        grid=(B,),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)] * 4,
        out_specs=[pl.BlockSpec(memory_space=pl.ANY)] * 2,
        backend="triton",
        compiler_params=_PARAMS,
        interpret=interpret,
        name="arith_decode",
    )(flat, byte_offsets.astype(i32), byte_lens.astype(i32), out_lens.astype(i32))
    # the kernel writes only positions <= out_lens; zero the rest
    pos = jnp.arange(num_steps, dtype=i32)[None, :]
    return jnp.where(pos < out_lens[:, None], blocks, 0).astype(jnp.uint8), eof != 0
