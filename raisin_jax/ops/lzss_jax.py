"""LZSS match search + commit as JAX device kernels.

Data-parallel redesign of the reference encoder (compressor/lz/lzss.go):

- The reference spawns one goroutine per input byte, each running
  bytes.Index over the trailing 4096-byte window (lzss.go:119-130). Here the
  per-position longest match is computed EXACTLY by a reverse ``lax.scan``
  carrying the vector of run lengths rl[d] = LCP(x[i:], x[i-d:]) for every
  distance d in [1, W]: one vectorized compare-and-increment per position
  (tiled T positions per scan step to amortize step overhead). The match
  length is L[i] = max_d min(rl[d], d) (the min enforces "match entirely in
  the prefix", lzss.go:349-353 requires L <= D) and the distance is the
  LARGEST d achieving it — i.e. the leftmost occurrence, matching
  bytes.Index semantics (lzss.go:418).
- The sequential token-commit pass (lzss.go:134-151) is replaced by pointer
  doubling: the jump function f(i) = i + max(L[i], 1) is lifted to jump
  tables f^(2^k) with log2(S) gathers, and the committed-position orbit of 0
  is evaluated for ALL output ranks in parallel by composing lifts along the
  binary representation of the rank.
- Token emission (ASCII ``<D,L>``, emitted only when shorter than the match,
  lzss.go:143) becomes arithmetic digit extraction + prefix-sum offsets +
  a gather per output byte.

Byte-exactness vs. formats.lzss_ref (and hence the reference wire format) is
asserted in tests.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from raisin_jax.formats.lzss_ref import (
    DEFAULT_WINDOW_SIZE,
    decode_opening_symbols,
    encode_opening_symbols,
)
from raisin_jax.ops import jax_setup  # noqa: F401
from raisin_jax.utils.misc import bucket as _bucket

TILE = 8  # positions folded into one scan step
MAX_TOKEN_LEN = 11  # "<dddd,dddd>"


# ---------------------------------------------------------------------------
# Match search


def _match_scan(xb, n, window: int, wl: int, d0, p0: int = 0, p1: int | None = None,
                rl_init=None):
    """Per-position best match over the distance sub-range (d0, d0+wl],
    restricted to the position range [p0, p1).

    xb: (S,) int32 escaped bytes (-1 past n); window: full window size
    (pads the left sentinel region); wl: local distance count (static);
    d0: first distance minus one (0 for the full window; the tensor-parallel
    shard offset otherwise — may be a traced value). rl_init: forward-run
    carry entering at position p1 (zeros when p1 is the block end).

    Returns (L, D, rl_out): the longest match using only distances in the
    sub-range, its largest achieving distance, and the run-length carry at
    position p0 (for a continuation phase over lower positions). Combining
    distance shards is max over L then max over D among shards achieving
    the global L (parallel.lzss_sharded).

    Performance notes: run lengths are kept in a REVERSED-distance layout so
    every inner slice is static (no per-iteration reversals or dynamic
    slices), and the hot state is int16 (distances <= 4096) to halve the
    bytes each step moves. The scan runs positions DESCENDING because the state
    is the FORWARD run length fl[i, d] = eq(i, d) ? fl[i+1, d] + 1 : 0.
    """
    S = xb.shape[0]
    if p1 is None:
        p1 = S
    num_steps = (p1 - p0) // TILE
    # past-length sentinel: 0x3C ('<') never occurs in ESCAPED bytes (the
    # escape pre-pass rewrites it to 0xFF, lzss.go:369), so it can never
    # equal a real window byte — which deletes the per-position validity
    # mask from the sequential update chain. Runs of sentinel-vs-sentinel
    # in the invalid tail cannot reach a valid position: that would need
    # eq at some invalid i+1 against a VALID window byte (i+1-d < n holds
    # whenever i < n and d >= 1), and real bytes never equal the sentinel.
    x16 = jnp.where(xb >= 0, xb, 0x3C).astype(jnp.int16)
    static_d0 = isinstance(d0, int) and d0 == 0
    if static_d0:
        # left-pad with sentinel so x[i-d] reads never match; keep only the
        # [p0 - wl, p1) byte range this phase can touch
        xp = jnp.concatenate([jnp.full((wl,), -2, dtype=jnp.int16), x16])
        xp = jax.lax.slice_in_dim(xp, p0, p1 + wl)  # xp[k] = x[p0 - wl + k]
        span = wl
    else:
        # traced distance offset (tensor-parallel shard): keep the full
        # window span so the d0 shift can be applied with a dynamic slice
        xp = jnp.concatenate([jnp.full((window,), -2, dtype=jnp.int16), x16])
        xp = jax.lax.slice_in_dim(xp, p0, p1 + window)  # xp[k] = x[p0 - window + k]
        span = window
    # reversed layout: lane j holds distance d = d0 + wl - j (descending)
    dvec = (jnp.int32(d0) + wl - jnp.arange(wl, dtype=jnp.int32)).astype(jnp.int16)

    dvec32 = (jnp.int32(d0) + wl - jnp.arange(wl, dtype=jnp.int32))

    def step(rl, t):
        # t counts down: process positions p0 + [t*TILE, t*TILE+TILE) desc.
        base = t * TILE
        win = jax.lax.dynamic_slice(xp, (base,), (span + TILE,))
        if static_d0:
            win2 = win
        else:
            win2 = jax.lax.dynamic_slice(win, (span - d0 - wl,), (wl + TILE,))
        # run updates are the only sequential dependency, so they carry the
        # CAPPED run c[d] = min(run, d) directly: min(c + 1, d) equals
        # min(run + 1, d) whether or not the raw run already exceeded d,
        # which folds the per-position cap into the update (3 ops + the
        # compare instead of 5) and bounds the state by the window (no
        # int16-wrap clamp needed). The per-position (L, D) reductions are
        # deferred and batched into one (TILE, wl) pass per scan step.
        caps = []
        for u in range(TILE - 1, -1, -1):
            cur = win[span + u]
            prev = jax.lax.slice_in_dim(win2, u, u + wl)  # static slice
            rl = jnp.where(
                prev == cur, jnp.minimum(rl + jnp.int16(1), dvec), jnp.int16(0)
            )
            caps.append(rl)
        # key packs (cap, d) in 14-bit fields (d <= 8192 needs 14 bits):
        # max gives the longest match, ties broken by the LARGEST distance
        # = leftmost occurrence (bytes.Index semantics), in one reduce.
        key = jnp.stack(caps[::-1]).astype(jnp.int32) << 14 | dvec32[None, :]
        best = jnp.max(key, axis=1)  # (TILE,)
        L = best >> 14
        D = best & 0x3FFF
        posv = p0 + base + jnp.arange(TILE, dtype=jnp.int32)
        valid = (L > 0) & (posv < n)
        return rl, (
            jnp.where(valid, L, 0).astype(jnp.int16),
            jnp.where(valid, D, 0).astype(jnp.int16),
        )

    rl0 = jnp.zeros((wl,), dtype=jnp.int16) if rl_init is None else rl_init
    rl_out, (Ls, Ds) = jax.lax.scan(
        step, rl0, jnp.arange(num_steps - 1, -1, -1, dtype=jnp.int32)
    )
    # scan emitted tiles in descending t order; restore ascending
    return (
        Ls[::-1].reshape(p1 - p0).astype(jnp.int32),
        Ds[::-1].reshape(p1 - p0).astype(jnp.int32),
        rl_out,
    )


MIN_PHASE = 512  # smallest phase window (diminishing returns below this)


@functools.partial(jax.jit, static_argnames=("window", "num_steps"))
def find_matches_blocks(x: jax.Array, lengths: jax.Array, window: int, num_steps: int):
    """Exact per-position (L, D) for B blocks.

    Args:
      x: (B, S) int32 — escaped block bytes, -1 padded past ``lengths``.
      lengths: (B,) int32.
      window: search window (4096 in the reference, lzss.go:35).
      num_steps: S // TILE (S must be a TILE multiple).

    Returns L, D: (B, S) int32 ((0, 0) where no match).
    """
    B, S = x.shape

    # descending phases with geometrically shrinking windows: positions in
    # [p0, p1) can only match distances <= p1 - 1, so smaller windows
    # suffice for the block prefix. The run carry crossing a phase boundary
    # is the last wl_next lanes (distances 1..wl_next) of the reversed-
    # layout state (wl is non-increasing down the schedule). A 3/4 descent
    # (p0 = 3*p1/4) costs sum p1*wl/4 ~ 0.57*S*min(S,W) vs 0.67 for
    # halving; wl snaps up to a multiple of 128.
    phases: list[tuple[int, int, int]] = []
    p1 = S
    while p1 > 0:
        wl = min(window, max(MIN_PHASE, -(-p1 // 128) * 128))
        p0 = (3 * p1 // 4) // TILE * TILE
        wl_next = min(window, max(MIN_PHASE, -(-p0 // 128) * 128))
        if wl_next >= wl:
            p0 = 0
        phases.append((p0, p1, wl))
        p1 = p0

    def one_block(xb, n):
        Ls: list[jax.Array] = []
        Ds: list[jax.Array] = []
        rl = None
        for p0, p1_, wl in phases:
            if rl is not None and rl.shape[0] != wl:
                rl = rl[rl.shape[0] - wl :]  # distances 1..wl carry over
            L, D, rl = _match_scan(xb, n, window, wl, jnp.int32(0), p0, p1_, rl)
            Ls.append(L)
            Ds.append(D)
        return jnp.concatenate(Ls[::-1]), jnp.concatenate(Ds[::-1])

    return jax.vmap(one_block)(x, lengths)


# ---------------------------------------------------------------------------
# Commit + emission


def _ndigits(v):
    return (
        1
        + (v >= 10).astype(jnp.int32)
        + (v >= 100).astype(jnp.int32)
        + (v >= 1000).astype(jnp.int32)
        + (v >= 10000).astype(jnp.int32)
    )


def _digit_at(v, pos, nd):
    """ASCII digit of decimal v at position pos (0 = most significant)."""
    p = nd - 1 - pos
    pow10 = jnp.asarray([1, 10, 100, 1000, 10000], dtype=jnp.int32)[jnp.clip(p, 0, 4)]
    return (v // pow10) % 10 + ord("0")


@functools.partial(jax.jit, static_argnames=())
def commit_blocks(x: jax.Array, L: jax.Array, D: jax.Array, lengths: jax.Array):
    """Parallel commit + token emission for B blocks.

    Args:
      x: (B, S) int32 escaped bytes; L, D: (B, S) int32; lengths: (B,).

    Returns out (B, S) uint8 (token stream, zero-filled tail), out_len (B,).
    """
    B, S = x.shape
    log2S = max(1, (S - 1).bit_length())

    def one_block(xb, Lb, Db, n):
        # token length if emitted as a reference; emission rule lzss.go:143
        tok_len = 3 + _ndigits(Db) + _ndigits(Lb)
        has_ref = Lb > 0
        use_tok = has_ref & (tok_len < Lb)
        consumed = jnp.maximum(Lb, 1)  # positions consumed at a commit
        out_len_at = jnp.where(use_tok, tok_len, consumed)  # bytes produced

        # jump function on [0, S] (clip to S as the terminal state)
        f = jnp.minimum(jnp.arange(S, dtype=jnp.int32) + consumed, S)

        # binary lifting tables f^(2^k)
        lifts = [f]
        for _ in range(log2S - 1):
            prev = lifts[-1]
            lifts.append(jnp.minimum(prev[jnp.clip(prev, 0, S - 1)], S))

        # orbit of 0: committed position of rank j, for all j in [0, S)
        ranks = jnp.arange(S, dtype=jnp.int32)
        cur = jnp.zeros((S,), dtype=jnp.int32)
        rem = ranks
        for k in range(log2S - 1, -1, -1):
            take = rem >= (1 << k)
            stepped = lifts[k][jnp.clip(cur, 0, S - 1)]
            cur = jnp.where(take & (cur < S), stepped, cur)
            rem = rem - jnp.where(take, 1 << k, 0)

        committed_pos = cur  # ascending; == S once past the end
        valid_commit = committed_pos < jnp.minimum(n, S)

        # per-rank output length and offsets
        lens = jnp.where(valid_commit, out_len_at[jnp.clip(committed_pos, 0, S - 1)], 0)
        ends = jnp.cumsum(lens)
        total = ends[-1]
        starts = ends - lens

        # each output byte o belongs to the first rank whose end > o
        o = jnp.arange(S, dtype=jnp.int32)
        r = jnp.searchsorted(ends, o, side="right")
        r = jnp.clip(r, 0, S - 1)
        src = jnp.clip(committed_pos[r], 0, S - 1)
        within = o - starts[r]

        is_tok = use_tok[src]
        d_src = Db[src]
        l_src = Lb[src]
        nd_d = _ndigits(d_src)
        nd_l = _ndigits(l_src)
        # token layout: '<' D-digits ',' L-digits '>'
        tok_byte = jnp.where(
            within == 0,
            ord("<"),
            jnp.where(
                within <= nd_d,
                _digit_at(d_src, within - 1, nd_d),
                jnp.where(
                    within == nd_d + 1,
                    ord(","),
                    jnp.where(
                        within <= nd_d + 1 + nd_l,
                        _digit_at(l_src, within - nd_d - 2, nd_l),
                        ord(">"),
                    ),
                ),
            ),
        )
        raw_byte = xb[jnp.clip(src + within, 0, S - 1)]
        out = jnp.where(o < total, jnp.where(is_tok, tok_byte, raw_byte), 0)
        return out.astype(jnp.uint8), total

    return jax.vmap(one_block)(x, L, D, lengths)


# ---------------------------------------------------------------------------
# Token decode


def _parse_tokens(t):
    """Per-position token fields of one stream: (is_open, D, L, token length).

    Digit runs are composed with static shifts, so the parse has no gathers.
    Only positions holding '<' are meaningful (the escape pre-pass removes
    every literal '<', so each '<' opens a well-formed ``<D,L>`` token).
    """
    S = t.shape[0]

    def sh(a, k):
        # a shifted left by k positions along the stream (reads a[i + k])
        return jnp.pad(a, (0, k))[k : k + S]

    isd = ((t >= 48) & (t <= 57)).astype(jnp.int32)
    i2 = isd * sh(isd, 1)
    i3 = i2 * sh(isd, 2)
    i4 = i3 * sh(isd, 3)
    rl = isd + i2 + i3 + i4  # digit-run length (capped at 4) at each position
    v1 = t - 48
    v2 = v1 * 10 + sh(v1, 1)
    v3 = v2 * 10 + sh(v1, 2)
    v4 = v3 * 10 + sh(v1, 3)

    def val(r, off):
        # value of the r-digit run starting at position + off
        return jnp.where(
            r == 1, sh(v1, off),
            jnp.where(r == 2, sh(v2, off), jnp.where(r == 3, sh(v3, off), sh(v4, off))),
        )

    rd = sh(rl, 1)  # D digit count
    D = val(rd, 1)
    # L digits start at offset rd + 2; resolve the dynamic offset by cases
    L = jnp.zeros_like(t)
    tl = jnp.zeros_like(t)
    for k in (1, 2, 3, 4):
        rlk = sh(rl, k + 2)
        L = jnp.where(rd == k, val(rlk, k + 2), L)
        tl = jnp.where(rd == k, 3 + k + rlk, tl)
    return t == ord("<"), D, L, tl


@functools.partial(jax.jit, static_argnames=("cap_out",))
def decode_blocks(tok: jax.Array, tok_len: jax.Array, cap_out: int):
    """Decode B LZSS token streams to their escaped plaintexts, in parallel.

    The stream splits into units: a token ``<D,L>`` yields L bytes copied from
    D back, any other byte outside a token yields itself (lzss.go:323). Unit
    output offsets are a prefix sum; each output byte then points either at
    itself (a literal) or D bytes back, and log2(cap_out) rounds of pointer
    jumping resolve every copy chain to the literal it started from.

    Args:
      tok: (B, S) token-stream bytes (any integer dtype).
      tok_len: (B,) int32.
      cap_out: static per-block output capacity in bytes.

    Returns (out (B, cap_out) uint8, zero past ``out_len``; out_len (B,)
    int32, the true decoded length even when it exceeds ``cap_out``).
    """
    S = tok.shape[1]
    rounds = max(1, (cap_out - 1).bit_length())

    def one(tb, n):
        pos = jnp.arange(S, dtype=jnp.int32)
        valid = pos < n
        t = jnp.where(valid, tb.astype(jnp.int32), 0)
        is_open, D, L, tl = _parse_tokens(t)
        is_open = is_open & valid
        # positions inside a token belong to the last '<' at or before them
        last = jax.lax.cummax(jnp.where(is_open, pos, -1))
        covered = (last >= 0) & (pos < last + tl[jnp.maximum(last, 0)])
        unit_len = jnp.where(is_open, L, jnp.where(valid & ~covered, 1, 0))
        ends = jnp.cumsum(unit_len)
        total = ends[-1]
        starts = ends - unit_len

        # owning unit of each output byte: scatter unit ids at their starts,
        # then a running max fills the span
        o = jnp.arange(cap_out, dtype=jnp.int32)
        mark = jnp.zeros(cap_out, dtype=jnp.int32).at[
            jnp.where(unit_len > 0, starts, cap_out)
        ].max(pos + 1, mode="drop")
        u = jnp.maximum(jax.lax.cummax(mark) - 1, 0)
        src = jnp.where(is_open[u], jnp.clip(o - D[u], 0, cap_out - 1), o)
        src = jax.lax.fori_loop(0, rounds, lambda _, s: s[s], src)
        lit = t[u]  # the byte of a literal unit
        out = jnp.where(o < total, lit[src], 0)
        return out.astype(jnp.uint8), total

    return jax.vmap(one)(tok, tok_len.astype(jnp.int32))


# ---------------------------------------------------------------------------
# Host wrappers


def compress(data: bytes, window_size: int = DEFAULT_WINDOW_SIZE) -> bytes:
    """Exact `.rsn` LZSS encode with device match-search + commit."""
    enc = encode_opening_symbols(data)
    n = len(enc)
    if n == 0:
        return b""
    S = _bucket(n)
    x = np.full((1, S), -1, dtype=np.int32)
    x[0, :n] = np.frombuffer(enc, dtype=np.uint8)
    lengths = np.array([n], dtype=np.int32)
    L, D = find_matches_blocks(x, lengths, window_size, S // TILE)
    out, out_len = commit_blocks(x, L, D, lengths)
    return np.asarray(out[0, : int(out_len[0])], dtype=np.uint8).tobytes()


def decompress(data: bytes) -> bytes:
    """LZSS decode (host path; see formats.lzss_ref)."""
    from raisin_jax.formats import lzss_ref

    return lzss_ref.decompress(data)
