"""Huffman codec with device-side encode packing and bit-walk decode.

Split of labor:

- The tree build must replicate Go's container/heap mechanics bit-for-bit
  (see formats.huffman_ref) and touches only `distinct-runes` elements — it
  stays on host.
- The O(N) work — mapping every symbol to its code and packing the variable
  length codes into a bitstream — runs on device: per-symbol gather of code
  rows from a (num_syms, MAXLEN) bit matrix, exclusive-cumsum offsets, and
  one searchsorted gather per output bit (same expansion pattern as the
  arithmetic kernel).
- Decode walks the tree as (left, right, leaf) arrays, TILE bits per scan
  step; emitted symbols are compacted on device with a cumsum scatter.

Wire format identical to formats.huffman_ref (reference huffman.go:255):
header + "\\\n" + pad byte + payload bits.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from raisin_jax.formats import huffman_ref as hf
from raisin_jax.ops import jax_setup  # noqa: F401

TILE = 8


def _maxlen_bucket(n: int) -> int:
    for b in (16, 32, 64, 128, 256):
        if n <= b:
            return b
    raise ValueError("huffman: code length beyond 256 bits")


@functools.partial(jax.jit, static_argnames=("max_bits",))
def _pack_codes(sym_ids, code_bits, code_lens, max_bits: int):
    """Concatenate per-symbol codes into one bit array.

    sym_ids: (N,) int32; code_bits: (K, MAXLEN) uint8; code_lens: (K,) int32.
    Returns bits (max_bits,) uint8 and total bit count.
    """
    lens = code_lens[sym_ids]
    ends = jnp.cumsum(lens)
    total = ends[-1]
    j = jnp.arange(max_bits, dtype=jnp.int32)
    k = jnp.searchsorted(ends, j, side="right")
    k = jnp.clip(k, 0, sym_ids.shape[0] - 1)
    start = ends[k] - lens[k]
    within = j - start
    bits = code_bits[sym_ids[k], jnp.clip(within, 0, code_bits.shape[1] - 1)]
    return jnp.where(j < total, bits, 0).astype(jnp.uint8), total


@functools.partial(jax.jit, static_argnames=("num_steps",))
def _bitwalk_decode(bits, nbits, left, right, leaf, num_steps: int):
    """Walk the tree over the bitstream, TILE bits per scan step.

    bits: (S,) uint8; nbits: scalar int32; left/right/leaf: (nodes,) int32
    (leaf[v] = symbol id or -1). Returns (syms (S,) int32 with -1 gaps,
    count, ok) — symbol emitted at the bit index that completes its code.
    """

    def step(carry, t):
        node, ok = carry
        base = t * TILE
        window = jax.lax.dynamic_slice(bits, (base,), (TILE,))
        outs = []
        for u in range(TILE):
            i = base + u
            active = i < nbits
            b = window[u]
            nxt = jnp.where(b == 0, left[node], right[node])
            # walking from an internal node consumes the bit
            node = jnp.where(active, nxt, node)
            is_leaf = leaf[node] >= 0
            emit = active & is_leaf
            outs.append(jnp.where(emit, leaf[node], -1))
            node = jnp.where(emit, 0, node)  # reset to root after a leaf
        return (node, ok), jnp.stack(outs)

    node0 = jnp.int32(0)
    (node_end, _), syms = jax.lax.scan(
        step, (node0, jnp.bool_(True)), jnp.arange(num_steps, dtype=jnp.int32)
    )
    syms = syms.reshape(-1)
    count = jnp.sum(syms >= 0)
    # stream must end exactly at the root (i.e. not inside a code)
    ok = node_end == 0
    return syms, count, ok


def _tree_arrays(tree):
    """Flatten the host tree into (left, right, leaf_sym_index) arrays.

    Node 0 is the root. Leaf symbol ids index print_codes' DFS order.
    """
    left, right, leaf = [], [], []
    vals: list[int] = []

    def add_node():
        left.append(0)
        right.append(0)
        leaf.append(-1)
        return len(leaf) - 1

    root = add_node()

    def walk(t, v):
        if isinstance(t, hf.Leaf):
            leaf[v] = len(vals)
            vals.append(t.value)
            return
        l_id = add_node()
        left[v] = l_id
        walk(t.left, l_id)
        r_id = add_node()
        right[v] = r_id
        walk(t.right, r_id)

    walk(tree, root)
    return (
        np.array(left, dtype=np.int32),
        np.array(right, dtype=np.int32),
        np.array(leaf, dtype=np.int32),
        vals,
    )


def _bucket(n: int) -> int:
    size = 1024
    while size < n:
        size *= 4
    return size


def compress(data: bytes) -> bytes:
    """Exact `.rsn` Huffman encode; code packing on device.

    Host-side rune handling is fully vectorized (numpy UTF-8 state checks
    and searchsorted symbol->id mapping) — no per-rune Python loops on the
    hot path.
    """
    runes_arr = hf.decode_runes_array(data)
    if runes_arr.size == 0:
        raise ValueError("huffman: cannot compress empty input (reference panics)")
    uniq, first_idx, counts = np.unique(runes_arr, return_index=True, return_counts=True)
    order = np.argsort(first_idx)  # preserve first-occurrence dict order
    sym_freqs = {int(u): int(c) for u, c in zip(uniq[order], counts[order])}
    tree = hf.build_tree(sym_freqs)
    vals, bins = hf.print_codes(tree)

    if len(vals) == 1:
        # single-symbol degenerate case: empty payload (reference parity)
        return hf.build_header(sym_freqs) + hf.SEPARATOR + bytes([0])

    maxlen = _maxlen_bucket(max(len(b) for b in bins))
    # pad the symbol table to a bucketed size so jit specializations are
    # shared across trees; the last row is a zero-length sentinel used by
    # the padded tail of `ids`
    K = _bucket(len(vals) + 1)
    code_bits_p = np.zeros((K, maxlen), dtype=np.uint8)
    code_lens_p = np.zeros(K, dtype=np.int32)
    for i, b in enumerate(bins):
        code_lens_p[i] = len(b)
        code_bits_p[i, : len(b)] = np.frombuffer(b.encode(), dtype=np.uint8) - ord("0")
    vals_np = np.asarray(vals, dtype=np.int64)
    sort_idx = np.argsort(vals_np, kind="stable")

    n = int(runes_arr.size)
    N = _bucket(n)
    ids = np.full(N, len(vals), dtype=np.int32)  # sentinel: code length 0
    ids[:n] = sort_idx[np.searchsorted(vals_np[sort_idx], runes_arr)]

    max_bits = _bucket(int(code_lens_p.max()) * n + 8)
    bits, total = _pack_codes(ids, code_bits_p, code_lens_p, max_bits)
    total = int(total)
    bits = np.asarray(bits[:total], dtype=np.uint8)

    rem = total % 8
    pad = 0 if rem == 0 else 8 - rem
    padded = np.concatenate([np.zeros(pad, dtype=np.uint8), bits])
    payload = np.packbits(padded).tobytes() if padded.size else b""
    return hf.build_header(sym_freqs) + hf.SEPARATOR + bytes([pad]) + payload


def decompress(data: bytes) -> bytes:
    """Exact `.rsn` Huffman decode; bit walk on device."""
    try:
        header, rest = data.split(hf.SEPARATOR, 1)
    except ValueError:
        raise ValueError("huffman: missing header separator") from None
    sym_freqs = hf.parse_header(header)
    tree = hf.build_tree(sym_freqs)

    if not rest:
        raise ValueError("huffman: missing pad byte")
    pad = rest[0]
    payload = rest[1:]
    bits_np = np.unpackbits(np.frombuffer(payload, dtype=np.uint8))[pad:]

    if isinstance(tree, hf.Leaf):
        # Zero-length code: undecodable; the reference panics (huffman.go:131-133).
        # Match the oracle and raise instead of returning truncated data.
        raise ValueError(
            "huffman: single-symbol stream is not decodable "
            "(zero-length code; reference panics here)"
        )

    left, right, leaf, vals = _tree_arrays(tree)
    # bucket the node arrays so jit specializations are shared across trees
    nodes = _bucket(left.size)
    left = np.concatenate([left, np.zeros(nodes - left.size, dtype=np.int32)])
    right = np.concatenate([right, np.zeros(nodes - right.size, dtype=np.int32)])
    leaf = np.concatenate([leaf, np.full(nodes - leaf.size, -1, dtype=np.int32)])
    n = int(bits_np.size)
    S = _bucket(max(n, 1))
    bits = np.zeros(S, dtype=np.uint8)
    bits[:n] = bits_np
    syms, count, ok = _bitwalk_decode(
        bits, np.int32(n), left, right, leaf, S // TILE
    )
    if not bool(ok):
        raise ValueError("huffman: bitstream ends inside a code")
    syms = np.asarray(syms)
    ids = syms[syms >= 0]
    return hf.runes_to_utf8_np(np.asarray(vals)[ids])
