"""Block-parallel Huffman for the RSNB container (device batch kernels).

Split of labor (same shape as the single-stream ops/huffman_jax):

- Per-block tree build replicates Go's container/heap mechanics exactly
  (formats.huffman_ref, reference huffman.go:58) and touches only
  distinct-symbol-sized data — host, one cheap pass per block.
- The O(total bytes) work runs batched on device in XLA: encode = code
  lookup, prefix-sum bit offsets and an MSB-first pack; decode = a lockstep
  1-bit tree walk (one scan step per payload bit) and a compaction.
- Wire format per block is byte-identical to formats.huffman_ref
  (reference huffman.go:229,255-279): ASCII freq|char header + "\\\n" +
  pad byte + MSB-first payload bits with the pad as leading zeros.

The device path is gated to ASCII blocks (all bytes < 0x80), where Go's
rune iteration (huffman.go:306-310) degenerates to byte iteration; other
blocks fall back to the host oracle per block (the reference itself mangles
non-UTF-8 input through replacement runes, so binary data is out of scope
for this codec either way).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from raisin_jax.formats import huffman_ref as hf
from raisin_jax.ops import jax_setup  # noqa: F401
from raisin_jax.utils.misc import bucket as _bucket

MAXLEN = 32  # bucketed max code length in bits (depth ~log_phi(block size))
KSYMS = 129  # ASCII symbol ids 0..127 + sentinel row 128 (code length 0)


# ---------------------------------------------------------------------------
# Encode


@functools.partial(jax.jit, static_argnames=("cap_bytes",))
def pack_codes_blocks(ids, code_bits, code_lens, cap_bytes: int):
    """Batched variable-length code concat + MSB-first byte pack.

    Args:
      ids: (B, N) int32 symbol ids, sentinel (KSYMS-1) past each block's end.
      code_bits: (B, KSYMS, MAXLEN) uint8 — '0'/'1' as 0/1, row per symbol.
      code_lens: (B, KSYMS) int32 (0 for the sentinel row).
      cap_bytes: static payload byte capacity (callers size it exactly from
        the host-side sum of freq*len, so there is no retry path).

    Returns (payload (B, cap_bytes) uint8, byte_lens (B,), pads (B,)):
    per-block payload bytes after the reference's prepad rule — pad =
    (8 - bits%8) % 8 zero bits BEFORE the stream (huffman.go:245-249,
    174-191) — and the pad-byte value.
    """

    def one(idv, cb, cl):
        lens = cl[idv]
        ends = jnp.cumsum(lens)
        total = ends[-1]
        pad = (8 - total % 8) % 8
        j = jnp.arange(cap_bytes * 8, dtype=jnp.int32)
        jj = j - pad
        k = jnp.clip(jnp.searchsorted(ends, jj, side="right"), 0, idv.shape[0] - 1)
        start = ends[k] - lens[k]
        within = jnp.clip(jj - start, 0, MAXLEN - 1)
        bits = cb[idv[k], within]
        bits = jnp.where((jj >= 0) & (jj < total), bits, 0)
        bits = bits.reshape(cap_bytes, 8).astype(jnp.uint8)
        byte = bits[:, 0] << 7
        for k in range(1, 8):
            byte = byte | (bits[:, k] << (7 - k))
        return byte, (pad + total) // 8, pad

    return jax.vmap(one)(ids, code_bits, code_lens)


def encode_blocks(blocks: list[bytes]) -> list[bytes]:
    """Exact per-block `.rsn` Huffman encode, device-batched.

    Non-ASCII blocks (and degenerate single-symbol blocks) take the host
    oracle; everything else shares one device dispatch.
    """
    out: list[bytes | None] = [None] * len(blocks)
    dev: list[int] = []
    heads: dict[int, bytes] = {}
    tabs: dict[int, tuple] = {}
    exact_bits: dict[int, int] = {}
    for i, b in enumerate(blocks):
        arr = np.frombuffer(b, dtype=np.uint8)
        if arr.size == 0 or (arr & 0x80).any():
            out[i] = hf.compress(b)
            continue
        uniq, first_idx, counts = np.unique(arr, return_index=True, return_counts=True)
        order = np.argsort(first_idx)  # first-occurrence order (dict parity)
        sym_freqs = {int(u): int(c) for u, c in zip(uniq[order], counts[order])}
        if len(sym_freqs) == 1:
            out[i] = hf.compress(b)  # empty-payload degenerate case
            continue
        tree = hf.build_tree(sym_freqs)
        vals, bins = hf.print_codes(tree)
        heads[i] = hf.build_header(sym_freqs) + hf.SEPARATOR
        tabs[i] = (vals, bins)
        exact_bits[i] = sum(sym_freqs[v] * len(c) for v, c in zip(vals, bins))
        dev.append(i)

    if not dev:
        return out  # type: ignore[return-value]

    Bp = _bucket(len(dev), base=128)
    N = _bucket(max(len(blocks[i]) for i in dev), base=1024)
    cap_bytes = _bucket(max(exact_bits[i] for i in dev) // 8 + 2, base=128)
    ids = np.full((Bp, N), KSYMS - 1, dtype=np.int32)
    code_bits = np.zeros((Bp, KSYMS, MAXLEN), dtype=np.uint8)
    code_lens = np.zeros((Bp, KSYMS), dtype=np.int32)
    for row, i in enumerate(dev):
        arr = np.frombuffer(blocks[i], dtype=np.uint8)
        vals, bins = tabs[i]
        if max(len(c) for c in bins) > MAXLEN:
            raise ValueError("huffman: code length beyond 32 bits")
        for v, c in zip(vals, bins):
            code_lens[row, v] = len(c)
            code_bits[row, v, : len(c)] = np.frombuffer(c.encode(), np.uint8) - ord("0")
        ids[row, : arr.size] = arr
    payload, byte_lens, pads = pack_codes_blocks(ids, code_bits, code_lens, cap_bytes)
    payload = np.asarray(payload)
    byte_lens = np.asarray(byte_lens)
    pads = np.asarray(pads)
    for row, i in enumerate(dev):
        out[i] = (
            heads[i]
            + bytes([int(pads[row])])
            + payload[row, : int(byte_lens[row])].tobytes()
        )
    return out  # type: ignore[return-value]


# ---------------------------------------------------------------------------
# Decode


@functools.partial(jax.jit, static_argnames=("num_steps", "cap_out"))
def bitwalk_blocks(payload, bit_lens, table, leaf_sym, num_steps: int, cap_out: int):
    """Lockstep per-block tree walk over the payload bitstreams.

    Args:
      payload: (B, capB) uint8 payload bytes (after the pad byte).
      bit_lens: (B,) int32 — 8*payload_len - pad (bits to consume; the pad's
        leading zeros are SKIPPED by offsetting the bit index).
      table: (B, 512) int32 — next node for (node, bit): idx = 2*node + bit;
        node 0 is the root.
      leaf_sym: (B, 256) int32 — symbol byte for leaf nodes, -1 otherwise.
      num_steps: static max bit count.
      cap_out: static output byte capacity (multiple of 4).

    Returns (words (B, cap_out//4) int32 — decoded bytes packed 4/word
    little-endian, counts (B,), ok (B,) — stream ends at the root).
    """
    def one(pb, nbits, tb, ls):
        bits = ((pb[:, None] >> jnp.arange(7, -1, -1, dtype=jnp.uint8)) & 1).reshape(-1)
        start = (8 - nbits % 8) % 8  # leading pad bits to skip

        def step(carry, t):
            node = carry
            i = start + t
            b = bits[jnp.clip(i, 0, bits.shape[0] - 1)].astype(jnp.int32)
            active = t < nbits
            nxt = tb[2 * node + b]
            node = jnp.where(active, nxt, node)
            sym = ls[jnp.clip(node, 0, 255)]
            emit = active & (sym >= 0)
            node = jnp.where(emit, 0, node)
            return node, jnp.where(emit, sym, -1)

        node_end, syms = jax.lax.scan(
            step, jnp.int32(0), jnp.arange(num_steps, dtype=jnp.int32)
        )
        # compact the -1 gaps: output position of each emit = rank among emits
        is_sym = syms >= 0
        count = jnp.sum(is_sym)
        ranks = jnp.cumsum(is_sym)  # 1-based at emit positions
        # out[r] = syms at the bit index where rank first reaches r+1
        o = jnp.arange(cap_out, dtype=jnp.int32)
        src = jnp.searchsorted(ranks, o + 1, side="left")
        v = syms[jnp.clip(src, 0, num_steps - 1)]
        v = jnp.where(o < count, v, 0).astype(jnp.int32)
        w = v.reshape(cap_out // 4, 4)
        words = w[:, 0] | (w[:, 1] << 8) | (w[:, 2] << 16) | (w[:, 3] << 24)
        return words, count, node_end == 0

    return jax.vmap(one)(payload, bit_lens, table, leaf_sym)


def _node_table(tree):
    """Host flatten: (table (512,) int32 with idx = 2*node+bit, leaf_sym
    (256,) int32) for an ASCII tree; returns None when it doesn't fit."""
    table = np.zeros(512, dtype=np.int32)
    leaf_sym = np.full(256, -1, dtype=np.int32)
    next_id = [1]

    def walk(t, v):
        if isinstance(t, hf.Leaf):
            if not (0 <= t.value < 128):
                raise _NonAscii
            leaf_sym[v] = t.value
            return
        for bit, child in ((0, t.left), (1, t.right)):
            c = next_id[0]
            next_id[0] += 1
            if c >= 256:
                raise _NonAscii  # deeper than any ASCII tree can be
            table[2 * v + bit] = c
            walk(child, c)

    walk(tree, 0)
    return table, leaf_sym


class _NonAscii(Exception):
    pass


def decode_blocks(payloads: list[bytes], out_bound: int | None = None) -> list[bytes]:
    """Exact per-block Huffman decode, device-batched (ASCII trees).

    ``out_bound``: optional known upper bound on any block's decoded size
    (the container's block size or recorded token length) — tightens the
    device decoder's output capacity."""
    out: list[bytes | None] = [None] * len(payloads)
    dev: list[int] = []
    metas: dict[int, tuple] = {}
    for i, p in enumerate(payloads):
        try:
            header, rest = p.split(hf.SEPARATOR, 1)
            sym_freqs = hf.parse_header(header)
            tree = hf.build_tree(sym_freqs)
            if isinstance(tree, hf.Leaf) or not rest:
                raise _NonAscii
            table, leaf_sym = _node_table(tree)
        except _NonAscii:
            out[i] = hf.decompress(p)
            continue
        except ValueError:
            out[i] = hf.decompress(p)  # raises the oracle's error message
            continue
        pad = rest[0]
        body = rest[1:]
        metas[i] = (table, leaf_sym, body, 8 * len(body) - pad)
        dev.append(i)

    if dev:
        Bp = _bucket(len(dev), base=128)
        capB = _bucket(max(len(metas[i][2]) for i in dev), base=128)
        steps = _bucket(max(metas[i][3] for i in dev), base=1024)
        # decoded bytes <= payload bits, and <= the container's bound
        cap_out = _bucket(min(steps, out_bound or steps) // 4 * 4 + 4, base=1024)
        payload = np.zeros((Bp, capB), dtype=np.uint8)
        bit_lens = np.zeros(Bp, dtype=np.int32)
        tables = np.zeros((Bp, 512), dtype=np.int32)
        leafs = np.full((Bp, 256), -1, dtype=np.int32)
        for row, i in enumerate(dev):
            table, leaf_sym, body, nbits = metas[i]
            payload[row, : len(body)] = np.frombuffer(body, dtype=np.uint8)
            bit_lens[row] = nbits
            tables[row] = table
            leafs[row] = leaf_sym
        words, counts, ok = bitwalk_blocks(
            payload, bit_lens, tables, leafs, num_steps=steps, cap_out=cap_out
        )
        words = np.asarray(words)
        counts = np.asarray(counts)
        ok = np.asarray(ok)
        for row, i in enumerate(dev):
            if not bool(ok[row]):
                raise ValueError("huffman: bitstream ends inside a code")
            out[i] = words[row].tobytes()[: int(counts[row])]
    return out  # type: ignore[return-value]
