"""Fused device pipelines: everything on device, compact bytes out.

The container paths fuse all stages of a pipeline into one jitted call whose
only outputs are the concatenated compressed bytes (or decoded rows) plus
per-block length vectors, so the host transfers only what it keeps.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from raisin_jax.ops import arithmetic_scan, lzss_jax
from raisin_jax.ops import jax_setup  # noqa: F401


def concat_blocks(packed: jax.Array, lens: jax.Array, cap: int) -> jax.Array:
    """flat[o] = packed[b, o - start_b] for the block b owning offset o."""
    B, M = packed.shape
    ends = jnp.cumsum(lens)
    o = jnp.arange(cap, dtype=jnp.int32)
    b = jnp.clip(jnp.searchsorted(ends, o, side="right"), 0, B - 1)
    within = o - (ends[b] - lens[b])
    flat = packed[b, jnp.clip(within, 0, M - 1)]
    return jnp.where(o < ends[-1], flat, 0).astype(jnp.uint8)


@functools.partial(
    jax.jit, static_argnames=("window", "cap_bytes", "with_arith", "max_bits")
)
def lzss_encode_packed(
    x: jax.Array,
    lengths: jax.Array,
    window: int,
    cap_bytes: int,
    with_arith: bool,
    max_bits: int | None = None,
):
    """LZSS match+commit (optionally + arithmetic layer), compact bytes out.

    x: (B, S) uint8 pre-escaped block bytes (values past ``lengths`` are
    ignored — they are replaced with the -1 sentinel on device, so the host
    ships 1 byte per input byte); lengths: (B,).
    Returns (flat (cap_bytes,) uint8, out_lens (B,), tok_lens (B,),
    oflow (B,) bool — blocks the arithmetic kernel could not code).
    """
    B, S = x.shape
    pos = jnp.arange(S, dtype=jnp.int32)[None, :]
    xi = jnp.where(pos < lengths[:, None], x.astype(jnp.int32), -1)
    L, D = lzss_jax.find_matches_blocks(xi, lengths, window, S // lzss_jax.TILE)
    tok, tok_len = lzss_jax.commit_blocks(xi, L, D, lengths)
    if not with_arith:
        return concat_blocks(tok, tok_len, cap_bytes), tok_len, tok_len, jnp.zeros(B, bool)
    # room for the EOF step after the longest possible token stream
    steps = (S + 8 + 127) // 128 * 128
    payload = jnp.pad(tok, ((0, 0), (0, steps - S)))
    flat, byte_lens, oflow = arithmetic_scan.encode_blocks_packed(
        payload, tok_len, steps, cap_bytes, max_bits=max_bits
    )
    return flat, byte_lens, tok_len, oflow


@functools.partial(jax.jit, static_argnames=("num_steps", "max_bytes", "cap_out"))
def lzss_arith_decode(
    flat: jax.Array,
    byte_offsets: jax.Array,
    byte_lens: jax.Array,
    tok_lens: jax.Array,
    num_steps: int,
    max_bytes: int,
    cap_out: int,
):
    """Arithmetic decode, LZSS token decode and escape decode, all on device.

    Token streams never leave the device. The escape decode (lzss.go:391) is
    a byte map (0xFF -> '<') for every block whose escaped text holds no 0x5C;
    the other blocks come back escaped, flagged in ``esc``, for the host's
    exact pass.

    Returns (rows (B, cap_out) uint8, out_len (B,) escaped length,
    eof_ok (B,), esc (B,) bool).
    """
    tok, eof_ok = arithmetic_scan.decode_blocks_packed(
        flat, byte_offsets, byte_lens, tok_lens, num_steps=num_steps, max_bytes=max_bytes
    )
    rows, out_len = lzss_jax.decode_blocks(tok, tok_lens, cap_out)
    pos = jnp.arange(cap_out, dtype=jnp.int32)[None, :]
    esc = jnp.any((rows == 0x5C) & (pos < out_len[:, None]), axis=1)
    mapped = jnp.where(rows == 0xFF, jnp.uint8(0x3C), rows)
    return jnp.where(esc[:, None], rows, mapped), out_len, eof_ok, esc
