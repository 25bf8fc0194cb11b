"""Tensor-parallel LZSS match search + full sharded pipeline step.

Two mesh axes:

- 'data'  — blocks are sharded data-parallel (each device owns B/дp blocks);
- 'model' — the 4096-entry distance window of the match search is sharded
  tensor-parallel: each device scans its distance sub-range and the exact
  greedy result is recovered with two pmax collectives —

      L = pmax(L_local)                       # longest match anywhere
      D = pmax(where(L_local == L, D_local, 0))  # largest distance at L
        (largest d == leftmost occurrence == bytes.Index semantics)

This is the device analogue of the reference's goroutine-per-byte match
search (lzss.go:119); collectives are placed by XLA, nothing hand-written.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from raisin_jax.ops import arithmetic_scan, lzss_jax

WINDOW = 4096


def sharded_pipeline_step(mesh, S: int, window: int = WINDOW):
    """Build the jitted full encode step (lzss match+commit, arithmetic coder)
    sharded over mesh axes ('data', 'model').

    Returns fn(x (B, S) int32, lengths (B,)) ->
      (tok (B, S) uint8, tok_len (B,), bits (B, MB) uint8, bit_len (B,)).
    """
    model_size = mesh.shape["model"]
    wl = window // model_size
    steps = S + 8  # arithmetic scan steps bound (token stream <= S, plus EOF)

    def local_step(x, lengths):
        # x: (B_local, S), lengths: (B_local,) — local shard on this device
        m = jax.lax.axis_index("model")
        d0 = (m * wl).astype(jnp.int32)

        def one_block(xb, n):
            L, D, _rl = lzss_jax._match_scan(xb, n, window, wl, d0)
            return L, D

        L_loc, D_loc = jax.vmap(one_block)(x, lengths)
        L = jax.lax.pmax(L_loc, "model")
        D = jax.lax.pmax(jnp.where(L_loc == L, D_loc, 0), "model")

        tok, tok_len = lzss_jax.commit_blocks(x, L, D, lengths)

        # arithmetic layer over the token stream (EOF appended at tok_len)
        j = jnp.arange(S + 8, dtype=jnp.int32)
        syms = jnp.where(
            j[None, :] < tok_len[:, None],
            jnp.pad(tok, ((0, 0), (0, 8))).astype(jnp.int32)[:, : S + 8],
            arithmetic_scan.EOF,
        )
        bits, bit_len = arithmetic_scan.encode_blocks(syms, tok_len, steps)
        return tok, tok_len, bits, bit_len

    fn = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P("data"), P("data")),
        out_specs=(P("data"), P("data"), P("data"), P("data")),
        check_vma=False,
    )
    return jax.jit(fn)
