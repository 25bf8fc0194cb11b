"""Adaptive arithmetic coder as a JAX scan state machine (device kernel).

Data-parallel redesign of the reference coder (compressor/arithmetic/arithmetic.go):
the per-symbol O(257) model-update loop (arithmetic.go:184) becomes one
258-wide vector add, the E1/E2/E3 renormalization loop (arithmetic.go:140)
becomes 16 unrolled masked iterations (the interval difference starts at >= 3
and at least doubles per iteration, so 15 iterations provably suffice), and
bit emission becomes a compact per-iteration event record expanded afterwards
via prefix sums + searchsorted — no data-dependent shapes anywhere, so the
whole encoder jits and vmaps over many independent blocks (the throughput
path: one adaptive stream per block, thousands of blocks in flight, ragged
lengths handled by per-step active masks).

Byte-exactness: for a single block this produces exactly the reference
`.rsn` arithmetic stream (tests assert equality against formats.arithmetic_ref).

Event record layout (uint8 per renorm iteration):
  bit 7: valid (this iteration emitted a bit)
  bit 6: emitted bit value
  bit 5: first emission of its step — flushes the carried pending count,
         stored separately as int32 per step; later emissions in the same
         step flush at most 15 in-step pending bits, stored in bits 0-4
  bits 0-4: in-step pending flush count
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from raisin_jax.ops import jax_setup  # noqa: F401  (persistent compile cache)
from raisin_jax.utils.misc import bucket as _bucket

MAX_CODE = 0xFFFF
ONE_FOURTH = 0x4000
ONE_HALF = 0x8000
THREE_FOURTHS = 0xC000
MAX_FREQ = 16383
EOF = 256
RENORM_ITERS = 16

# Upper bound on emitted bits per coded symbol: <= RENORM_ITERS emissions plus
# pending flushes; globally total bits <= 17 * steps + slack.
BITS_PER_STEP_BOUND = 17


def _idx258():
    return jnp.arange(258, dtype=jnp.int32)


def _fresh_model():
    return jnp.arange(258, dtype=jnp.int32)


# ---------------------------------------------------------------------------
# Encode


def _encode_step(carry, inp):
    low, high, pending, cum, frozen = carry
    sym, active = inp

    difference = high - low + 1
    lower = cum[sym]
    upper = cum[sym + 1]
    count = cum[257]

    # model update (the reference freezes AFTER the triggering update,
    # arithmetic.go:184-192)
    upd = (~frozen) & active
    cum = jnp.where(upd, cum + (_idx258() > sym).astype(jnp.int32), cum)
    frozen = frozen | (cum[257] >= MAX_FREQ)

    high = jnp.where(active, low + (difference * upper) // count - 1, high)
    low = jnp.where(active, low + (difference * lower) // count, low)

    slots = []
    slot0_pending = jnp.int32(0)
    has_emitted = jnp.bool_(False)
    done = ~active

    for _ in range(RENORM_ITERS):
        e1 = high < ONE_HALF
        e2 = low >= ONE_HALF
        e3 = (low >= ONE_FOURTH) & (high < THREE_FOURTHS)
        cont = (e1 | e2 | e3) & ~done
        emit = (e1 | e2) & cont
        straddle = e3 & ~e1 & ~e2 & cont
        bit = jnp.where(e2, jnp.uint8(1), jnp.uint8(0))

        is_first = emit & ~has_emitted
        slot0_pending = jnp.where(is_first, pending, slot0_pending)
        in_step_pend = jnp.where(is_first, 0, pending).astype(jnp.uint8)
        slot_val = (
            jnp.uint8(0x80)
            | (bit << 6)
            | jnp.where(is_first, jnp.uint8(0x20), jnp.uint8(0))
            | in_step_pend
        )
        slots.append(jnp.where(emit, slot_val, jnp.uint8(0)))
        has_emitted = has_emitted | emit

        pending = jnp.where(emit, 0, jnp.where(straddle, pending + 1, pending))
        sub = jnp.where(straddle, ONE_FOURTH, jnp.where(e2, ONE_HALF, 0))
        low = jnp.where(cont, (low - sub) << 1, low)
        high = jnp.where(cont, ((high - sub) << 1) + 1, high)
        done = done | ~cont

    return (low, high, pending, cum, frozen), (jnp.stack(slots), slot0_pending)


def _events_xla(symbols: jax.Array, lengths: jax.Array, num_steps: int):
    """XLA-scan event producer: (slots (B, S, 16) uint8, slot0 (B, S) int32)."""

    def one_block(syms, n):
        steps = jnp.arange(num_steps, dtype=jnp.int32)
        active = steps <= n  # payload symbols plus the EOF at position n
        init = (
            jnp.int32(0),
            jnp.int32(MAX_CODE),
            jnp.int32(0),
            _fresh_model(),
            jnp.bool_(False),
        )
        _, (slots, slot0) = jax.lax.scan(_encode_step, init, (syms, active))
        return slots, slot0

    return jax.vmap(one_block)(symbols, lengths)


@functools.partial(jax.jit, static_argnames=("num_steps", "max_bits"))
def encode_blocks(
    symbols: jax.Array,
    lengths: jax.Array,
    num_steps: int,
    max_bits: int | None = None,
):
    """Device encode of B independent blocks (XLA scan).

    Args:
      symbols: (B, num_steps) int32 — block bytes with EOF (256) at position
        ``lengths[b]``; entries past that are ignored.
      lengths: (B,) int32 payload length per block.
      num_steps: static scan length (>= max(lengths) + 1).
      max_bits: static per-block output-bit capacity. Defaults to the proven
        worst-case bound; callers may pass a tight practical capacity and
        retry when ``max(bit_lengths) > max_bits`` (bit_lengths stays correct
        even when the expanded bits overflow the capacity).

    Returns:
      padded_bits: (B, max_bits) uint8 — the `.rsn` bitstream per block,
        sentinel prepad applied, zero-filled past ``bit_lengths``.
      bit_lengths: (B,) int32 — multiple of 8; compressed bytes = bits/8.
    """
    if max_bits is None:
        max_bits = BITS_PER_STEP_BOUND * num_steps + 16
    max_bits = (max_bits + 7) // 8 * 8
    slots, slot0 = _events_xla(symbols, lengths, num_steps)
    return jax.vmap(lambda s, s0: _expand_block_bits(s, s0, max_bits))(slots, slot0)


def _expand_block_bits(slots, slot0, max_bits: int):
    """Events -> sentinel-prepadded MSB bitstream for one block.

    slots: (S, 16) uint8, slot0: (S,) int32.
    """
    flat = slots.reshape(-1)
    valid = (flat & 0x80) != 0
    bit = ((flat >> 6) & 1).astype(jnp.uint8)
    is_first = (flat & 0x20) != 0
    pend = (flat & 0x1F).astype(jnp.int32) + jnp.where(
        is_first, jnp.repeat(slot0, RENORM_ITERS), 0
    )
    ev_len = jnp.where(valid, 1 + pend, 0)
    ends = jnp.cumsum(ev_len)  # inclusive ends; zero-length events repeat
    total = ends[-1]
    pad = 8 - total % 8  # 1..8 prepad bits, 0…01 (bits.go:48)

    j = jnp.arange(max_bits, dtype=jnp.int32)
    jj = j - pad
    # owning event: first one whose end > jj (zero-length events never own)
    k = jnp.searchsorted(ends, jj, side="right")
    k = jnp.clip(k, 0, ev_len.shape[0] - 1)
    offset_k = ends[k] - ev_len[k]
    within = jj - offset_k
    raw = jnp.where(within == 0, bit[k], 1 - bit[k]).astype(jnp.uint8)
    sentinel = (j == pad - 1).astype(jnp.uint8)
    out = jnp.where(jj < 0, sentinel, jnp.where(jj < total, raw, jnp.uint8(0)))
    return out, total + pad


def _encode_packed_xla(payload, lengths, num_steps: int, cap_bytes: int, max_bits: int):
    """XLA reference of ``encode_blocks_packed``: scan, bit expansion, pack."""
    B = payload.shape[0]
    steps = jnp.arange(num_steps, dtype=jnp.int32)
    symbols = jnp.where(steps[None, :] < lengths[:, None], payload.astype(jnp.int32), EOF)
    padded_bits, bit_lengths = encode_blocks(symbols, lengths, num_steps, max_bits=max_bits)
    byte_lens = bit_lengths // 8

    # pack bits -> bytes on device (MSB first)
    mbytes = padded_bits.shape[1] // 8
    packed = jnp.zeros((B, mbytes), dtype=jnp.uint8)
    for k in range(8):
        packed = packed | (padded_bits[:, k::8] << (7 - k))

    # concatenate blocks: flat[o] = packed[b, o - start_b]
    ends = jnp.cumsum(byte_lens)
    o = jnp.arange(cap_bytes, dtype=jnp.int32)
    b = jnp.searchsorted(ends, o, side="right")
    b = jnp.clip(b, 0, B - 1)
    within = o - (ends[b] - byte_lens[b])
    flat = packed[b, jnp.clip(within, 0, mbytes - 1)]
    flat = jnp.where(o < ends[-1], flat, 0).astype(jnp.uint8)
    return flat, byte_lens, jnp.zeros((B,), dtype=jnp.bool_)


@functools.partial(jax.jit, static_argnames=("num_steps", "cap_bytes", "max_bits"))
def encode_blocks_packed(
    payload: jax.Array,
    lengths: jax.Array,
    num_steps: int,
    cap_bytes: int,
    max_bits: int | None = None,
):
    """Fully-device encode: blocks in, ONE compact byte buffer out.

    The `.rsn` bitstreams are packed to bytes and concatenated on device, so
    the only transfers are ``flat[:sum(byte_lens)]`` plus length vectors.
    Lowered for CUDA this runs the Pallas kernel (ops/arithmetic_gpu);
    elsewhere the XLA scan, which is the reference the kernel is tested
    against.

    Args:
      payload: (B, num_steps) uint8 block bytes (values past lengths ignored).
      lengths: (B,) int32.
      cap_bytes: static output capacity; caller checks sum(byte_lens) <=
        cap_bytes and retries with the proven bound if exceeded.
      max_bits: static per-block capacity in bits; the caller retries when
        ``max(byte_lens) * 8`` exceeds it.

    Returns (flat (cap_bytes,) uint8, byte_lens (B,) int32, oflow (B,) bool:
    blocks the kernel could not code, which the caller re-encodes on host).
    """
    from raisin_jax.ops import arithmetic_gpu

    if max_bits is None:
        max_bits = BITS_PER_STEP_BOUND * num_steps + 16
    max_bits = (max_bits + 7) // 8 * 8
    return jax.lax.platform_dependent(
        payload,
        lengths,
        cuda=lambda p, n: arithmetic_gpu.encode_packed(p, n, cap_bytes, max_bits),
        default=lambda p, n: _encode_packed_xla(p, n, num_steps, cap_bytes, max_bits),
    )


@functools.partial(jax.jit, static_argnames=("num_steps", "max_bytes"))
def decode_blocks_packed(
    flat: jax.Array,
    byte_offsets: jax.Array,
    byte_lens: jax.Array,
    out_lens: jax.Array,
    num_steps: int,
    max_bytes: int,
):
    """Fully-device decode of concatenated `.rsn` arithmetic streams.

    Lowered for CUDA this runs the Pallas kernel (ops/arithmetic_gpu), which
    reads ``flat`` directly; elsewhere the XLA scan reference.

    Args:
      flat: (cap,) uint8 concatenated per-block payloads.
      byte_offsets/byte_lens: (B,) int32 per-block extents in ``flat``.
      out_lens: (B,) int32 known decoded byte count per block.
      num_steps: static scan length (>= max(out_lens) + 1).
      max_bytes: static per-block payload bound (>= max(byte_lens)).

    Returns (blocks (B, num_steps) uint8, eof_ok (B,) bool).
    """
    from raisin_jax.ops import arithmetic_gpu

    return jax.lax.platform_dependent(
        flat,
        byte_offsets,
        byte_lens,
        out_lens,
        cuda=functools.partial(arithmetic_gpu.decode_packed, num_steps=num_steps),
        default=functools.partial(_decode_packed_xla, num_steps=num_steps, max_bytes=max_bytes),
    )


def _decode_packed_xla(flat, byte_offsets, byte_lens, out_lens, num_steps: int, max_bytes: int):
    """XLA reference of ``decode_blocks_packed``."""
    # slice each block's bytes and unpack to bits (vectorized shifts)
    idx = byte_offsets[:, None] + jnp.arange(max_bytes, dtype=jnp.int32)[None, :]
    valid = jnp.arange(max_bytes, dtype=jnp.int32)[None, :] < byte_lens[:, None]
    bb = jnp.where(valid, flat[jnp.clip(idx, 0, flat.shape[0] - 1)], 0).astype(jnp.int32)
    shifts = jnp.array([7, 6, 5, 4, 3, 2, 1, 0], dtype=jnp.int32)
    bits = ((bb[:, :, None] >> shifts[None, None, :]) & 1).reshape(bb.shape[0], -1)
    bits = bits.astype(jnp.uint8)

    # strip the prepad sentinel: payload begins after the first 1 bit
    start = jnp.argmax(bits, axis=1) + 1
    nbits_payload = byte_lens * 8 - start

    def one_block(bits_b, start_b, np_b, n):
        def read_bit(pos):
            # payload bits, then the appended [1, 0] tail, then zero-fill
            # (reference arithmetic.go:48, bits.go:12)
            j = jnp.clip(start_b + pos, 0, bits_b.shape[0] - 1)
            raw = bits_b[j].astype(jnp.int32)
            return jnp.where(pos < np_b, raw, jnp.where(pos == np_b, 1, 0))

        value0 = jnp.int32(0)
        for i in range(16):
            value0 = (value0 << 1) | read_bit(jnp.int32(i))

        def step(carry, active):
            value, low, high, pos, cum, frozen = carry
            difference = high - low + 1
            count = cum[257]
            scaled = ((value - low + 1) * count - 1) // difference
            sym = jnp.minimum(jnp.sum((cum[1:258] <= scaled).astype(jnp.int32)), 256)
            lower = cum[sym]
            upper = cum[sym + 1]
            upd = (~frozen) & active
            cum = jnp.where(upd, cum + (_idx258() > sym).astype(jnp.int32), cum)
            frozen = frozen | (cum[257] >= MAX_FREQ)
            is_eof = sym == EOF
            act = active & ~is_eof
            high = jnp.where(act, low + (difference * upper) // count - 1, high)
            low = jnp.where(act, low + (difference * lower) // count, low)
            done = ~act
            for _ in range(RENORM_ITERS):
                e1 = high < ONE_HALF
                e2 = low >= ONE_HALF
                e3 = (low >= ONE_FOURTH) & (high < THREE_FOURTHS)
                cont = (e1 | e2 | e3) & ~done
                sub = jnp.where(e2, ONE_HALF, jnp.where(e3 & ~e1, ONE_FOURTH, 0))
                value = jnp.where(cont, ((value - sub) << 1) + read_bit(pos), value)
                low = jnp.where(cont, (low - sub) << 1, low)
                high = jnp.where(cont, ((high - sub) << 1) + 1, high)
                pos = jnp.where(cont, pos + 1, pos)
                done = done | ~cont
            return (value, low, high, pos, cum, frozen), jnp.where(active, sym, EOF)

        steps = jnp.arange(num_steps, dtype=jnp.int32)
        active = steps <= n
        init = (value0, jnp.int32(0), jnp.int32(MAX_CODE), jnp.int32(16), _fresh_model(), jnp.bool_(False))
        _, syms = jax.lax.scan(step, init, active)
        eof_ok = syms[n] == EOF
        return jnp.where(steps < n, syms, 0).astype(jnp.uint8), eof_ok

    return jax.vmap(one_block)(bits, start, nbits_payload, out_lens)


# ---------------------------------------------------------------------------
# Decode


def _decode_step(carry, inp):
    value, low, high, pos, cum, frozen, bits = carry
    active = inp

    difference = high - low + 1
    count = cum[257]
    scaled = ((value - low + 1) * count - 1) // difference
    # first symbol s with scaled < cum[s+1]  (arithmetic.go:206)
    sym = jnp.sum((cum[1:258] <= scaled).astype(jnp.int32))
    sym = jnp.minimum(sym, 256)
    lower = cum[sym]
    upper = cum[sym + 1]

    upd = (~frozen) & active
    cum = jnp.where(upd, cum + (_idx258() > sym).astype(jnp.int32), cum)
    frozen = frozen | (cum[257] >= MAX_FREQ)

    is_eof = sym == EOF
    act = active & ~is_eof

    high = jnp.where(act, low + (difference * upper) // count - 1, high)
    low = jnp.where(act, low + (difference * lower) // count, low)

    done = ~act
    nbits = bits.shape[0]
    for _ in range(RENORM_ITERS):
        e1 = high < ONE_HALF
        e2 = low >= ONE_HALF
        e3 = (low >= ONE_FOURTH) & (high < THREE_FOURTHS)
        cont = (e1 | e2 | e3) & ~done
        sub = jnp.where(e2, ONE_HALF, jnp.where(e3 & ~e1, ONE_FOURTH, 0))
        nxt = jnp.where(pos < nbits, bits[jnp.clip(pos, 0, nbits - 1)], 0).astype(jnp.int32)
        value = jnp.where(cont, ((value - sub) << 1) + nxt, value)
        low = jnp.where(cont, (low - sub) << 1, low)
        high = jnp.where(cont, ((high - sub) << 1) + 1, high)
        pos = jnp.where(cont, pos + 1, pos)
        done = done | ~cont

    return (value, low, high, pos, cum, frozen, bits), jnp.where(
        active, sym, jnp.int32(EOF)
    )


@functools.partial(jax.jit, static_argnames=("num_steps",))
def decode_blocks(bits: jax.Array, lengths: jax.Array, num_steps: int):
    """Device decode of B independent blocks with known output lengths.

    Args:
      bits: (B, nbits) uint8 — unpadded bitstreams (sentinel already
        stripped), zero-filled to a common static length, with the decoder's
        [1, 0] tail (arithmetic.go:48) already appended per block.
      lengths: (B,) int32 — known decoded byte count per block.
      num_steps: static scan length (>= max(lengths) + 1, covering EOF).

    Returns (symbols (B, num_steps) int32, eof_ok (B,) bool).
    """

    def one_block(bb, n):
        value0 = jnp.int32(0)
        for i in range(16):
            value0 = (value0 << 1) | bb[i].astype(jnp.int32)
        steps = jnp.arange(num_steps, dtype=jnp.int32)
        active = steps <= n  # n payload symbols + the EOF check step
        init = (value0, jnp.int32(0), jnp.int32(MAX_CODE), jnp.int32(16), _fresh_model(), jnp.bool_(False), bb)
        _, syms = jax.lax.scan(_decode_step, init, active)
        eof_ok = syms[n] == EOF
        return syms, eof_ok

    return jax.vmap(one_block)(bits, lengths)


# ---------------------------------------------------------------------------
# Host wrappers (exact `.rsn` bytes, single stream)


def compress(data: bytes) -> bytes:
    """Single-stream `.rsn` arithmetic encode on device (bit-exact)."""
    n = len(data)
    steps = _bucket(n + 1)
    symbols = np.full((1, steps), EOF, dtype=np.int32)
    symbols[0, :n] = np.frombuffer(data, dtype=np.uint8)
    # EOF already present at position n via the fill value
    lengths = np.array([n], dtype=np.int32)
    padded_bits, bit_lengths = encode_blocks(symbols, lengths, steps)
    nbits = int(bit_lengths[0])
    bits = np.asarray(padded_bits[0, :nbits], dtype=np.uint8)
    return np.packbits(bits).tobytes()


def decompress(data: bytes, out_len: int | None = None) -> bytes:
    """Single-stream `.rsn` arithmetic decode on device.

    The output length must be known (container mode) or is discovered by a
    fast host scan fallback when ``out_len`` is None.
    """
    from raisin_jax.formats import arithmetic_ref

    if out_len is None:
        # Raw .rsn streams carry no length; decode on host instead.
        return arithmetic_ref.decompress(data)

    from raisin_jax.bitkit.packing import unpack_prepad_sentinel

    payload = unpack_prepad_sentinel(data)
    tail = np.concatenate([payload, np.array([1, 0], dtype=np.uint8)])
    steps = _bucket(out_len + 1)
    nbits = _bucket(max(len(tail), 16))
    bits = np.zeros((1, nbits), dtype=np.uint8)
    bits[0, : len(tail)] = tail
    syms, eof_ok = decode_blocks(bits, np.array([out_len], dtype=np.int32), steps)
    if not bool(eof_ok[0]):
        raise ValueError("arithmetic(device): EOF symbol not found where expected")
    return np.asarray(syms[0, :out_len], dtype=np.uint8).tobytes()
