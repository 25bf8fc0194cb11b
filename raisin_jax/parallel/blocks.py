"""RSNB block container: the block-parallel scale path.

The reference's `.rsn` format is a single whole-file stream with no
container (SURVEY §2.3) — inherently sequential for the adaptive codecs.
RSNB splits the input into independent fixed-size blocks, each encoded as an
exact single-stream `.rsn` payload of the layered pipeline, so:

- every block's bytes are individually reference-compatible;
- blocks encode/decode data-parallel: the (B, S) symbol batch is sharded
  along a mesh 'data' axis and each device runs the block kernels on its
  local shard (no hand-written collectives);
- ragged tails are handled by per-block length masks, not padding bytes.

Layout (little-endian):
  magic "RSNB" | version u8 | algo_len u8 | algo CSV | block_size u32 |
  window u32 (v2+) | orig_size u64 | num_blocks u32 | num_aux u8 |
  num_blocks × u32 payload sizes |
  num_aux × (num_blocks × u32) auxiliary per-block lengths |
  concatenated payloads

The auxiliary tables record intermediate layer lengths (e.g. the LZSS
token-stream size per block in the lzss,arithmetic pipeline) so that every
layer of the decode runs on device with static shapes — the decoders need
the symbol count up front.
"""

from __future__ import annotations

import concurrent.futures
import functools
import struct

import jax
import numpy as np
from jax.sharding import PartitionSpec as P

from raisin_jax.formats.lzss_ref import decode_opening_symbols_np, encode_opening_symbols
from raisin_jax.ops import arithmetic_scan
from raisin_jax.utils.misc import bucket as _bucket

MAGIC = b"RSNB"
VERSION = 2  # v2 adds the LZSS window u32 (v1 files parse as window=4096)
DEFAULT_BLOCK_SIZE = 1 << 16

# Input bytes per device per dispatch. The device pipelines hold a few dozen
# (B, S) int32 intermediates, so larger inputs run as a loop of dispatches of
# this size (64 KiB blocks: 1024 blocks per device).
DISPATCH_BYTES = 64 << 20

# The device LZSS kernels pack distances in 13-14 bit fields and parse at
# most 4-digit token fields; larger windows take the host path.
MAX_DEVICE_WINDOW = 8191

_POOL = None


def _progress(done: int, total: int, label: str = "blocks") -> None:
    """Reference-parity progress reporting (the Go LZSS writer shows a bar,
    lzss.go:113-115): a single self-overwriting stderr line, only when
    stderr is a tty and the job is big enough to care."""
    import sys

    if total < 8 or not sys.stderr.isatty():
        return
    pct = 100 * done // total
    end = "\n" if done >= total else ""
    print(f"\r  {label}: {done}/{total} ({pct}%)", file=sys.stderr, end=end, flush=True)


def _pool() -> concurrent.futures.ThreadPoolExecutor:
    global _POOL
    if _POOL is None:
        _POOL = concurrent.futures.ThreadPoolExecutor(max_workers=8)
    return _POOL


def _native(name: str):
    from raisin_jax.engine.registry import get_codec

    return get_codec(name, backend="native")  # falls back to the host oracle


def _gbucket(n: int, base: int = 1024) -> int:
    """Geometric bucket at ~1.33x granularity: powers of two plus their
    1.5x midpoints, so data-dependent capacities compile O(1) shapes."""
    size = base
    while size < n:
        if size + size // 2 >= n:
            return size + size // 2
        size *= 2
    return size


def _shard_blocks(arr: np.ndarray, mesh) -> jax.Array:
    if mesh is None:
        return arr
    from raisin_jax.parallel.mesh import block_sharding

    return jax.device_put(arr, block_sharding(mesh))


@functools.lru_cache(maxsize=None)
def _spmd_cached(fn, mesh, n_in: int, n_out: int, statics):
    wrapped = functools.partial(fn, **dict(statics)) if statics else fn
    if mesh is None:
        return wrapped
    spec_in = tuple(P("data") for _ in range(n_in))
    spec_out = tuple(P("data") for _ in range(n_out))
    # the outer jit is load-bearing: an un-jitted shard_map call runs in the
    # eager SPMD interpreter, several times slower than the compiled
    # partitioned module — and the whole wrapper must be CACHED, because a
    # fresh jit object per call would retrace every time
    return jax.jit(
        jax.shard_map(wrapped, mesh=mesh, in_specs=spec_in, out_specs=spec_out, check_vma=False)
    )


def _spmd(fn, mesh, n_in: int, n_out: int, **statics):
    """Run a vmapped block kernel SPMD over the mesh 'data' axis.

    Blocks are embarrassingly parallel, so each device simply runs the plain
    kernel on its local shard (explicit shard_map rather than relying on
    sharding inference through the scan). ``statics`` are keyword args bound
    into the kernel (they form part of the cache key).
    """
    return _spmd_cached(fn, mesh, n_in, n_out, tuple(sorted(statics.items())))


def _mesh_size(mesh) -> int:
    return 1 if mesh is None else mesh.devices.size


def _pad_block_count(b: int, mesh) -> int:
    """Round the block count up to a multiple of the mesh size."""
    n = _mesh_size(mesh)
    return ((b + n - 1) // n) * n


def _dispatches(count: int, block_size: int, mesh):
    """Block ranges of at most DISPATCH_BYTES per device each."""
    step = max(1, DISPATCH_BYTES // max(block_size, 1)) * _mesh_size(mesh)
    return [(i, min(i + step, count)) for i in range(0, count, step)]


# ---------------------------------------------------------------------------
# Device batch encoders (per pipeline)
#
# Every path transfers exactly: the concatenated compressed bytes (or
# decoded rows) plus per-block length vectors.


def _split_flat(flat: np.ndarray, lens: np.ndarray, count: int, mesh=None) -> list[bytes]:
    """Recover per-block payloads from the compacted buffer.

    Under shard_map each device compacts its local blocks into its own
    cap/n-sized segment, so offsets restart at every segment boundary.
    """
    n = _mesh_size(mesh)
    cap_local = flat.size // n
    per_seg = len(lens) // n
    out = []
    for i in range(count):
        seg, k = divmod(i, per_seg)
        off = seg * cap_local + int(lens[seg * per_seg : seg * per_seg + k].sum())
        out.append(flat[off : off + lens[i]].tobytes())
    return out


def _fits(lens: np.ndarray, cap: int, mesh) -> bool:
    n = _mesh_size(mesh)
    per_seg = len(lens) // n
    seg_sums = lens.reshape(n, per_seg).sum(axis=1)
    return int(seg_sums.max()) <= cap // n


def _cap_bytes(total_in: int, nblocks: int) -> int:
    """Practical compressed-size capacity: 1.3x input plus per-block slack."""
    return ((int(total_in * 1.3) + 8 * nblocks + 4096) + 127) // 128 * 128


def _encode_arithmetic_batch(blocks: list[bytes], mesh) -> list[bytes]:
    B = _pad_block_count(len(blocks), mesh)
    steps = _bucket(max(len(b) for b in blocks) + 1)
    payload = np.zeros((B, steps), dtype=np.uint8)
    lengths = np.zeros(B, dtype=np.int32)
    for i, b in enumerate(blocks):
        payload[i, : len(b)] = np.frombuffer(b, dtype=np.uint8)
        lengths[i] = len(b)
    total_in = int(lengths.sum())
    n = _mesh_size(mesh)
    bound_bits = arithmetic_scan.BITS_PER_STEP_BOUND * steps + 16
    bound = bound_bits * (B // n) // 8 + B * 4
    # practical first try: per-block output <= 9 bits/symbol (ratio 1.125);
    # retry at the proven bound if any block or the flat capacity overflows
    for cap, mbits in (
        (_cap_bytes(total_in, B) // n * n, 9 * steps + 32),
        (bound * n, bound_bits),
    ):
        enc = _spmd(
            arithmetic_scan.encode_blocks_packed, mesh, 2, 3,
            num_steps=steps, cap_bytes=cap // n, max_bits=mbits,
        )
        flat, byte_lens, oflow = enc(_shard_blocks(payload, mesh), _shard_blocks(lengths, mesh))
        byte_lens = np.asarray(byte_lens)
        if _fits(byte_lens, cap, mesh) and int(byte_lens.max()) * 8 <= (mbits + 7) // 8 * 8:
            break
    payloads = _split_flat(np.asarray(flat), byte_lens, len(blocks), mesh)
    # a carried pending run past the kernel's bound: exact host re-encode
    a = _native("arithmetic")
    for i in np.nonzero(np.asarray(oflow)[: len(blocks)])[0]:
        payloads[i] = a.compress(blocks[i])
    return payloads


def _escaped_blocks(blocks: list[bytes], mesh):
    nb = len(blocks)
    B = _pad_block_count(nb, mesh)
    # fast path: the escape pre-pass is per-byte, so when no byte EXPANDS
    # (no 0x5C / 0xFF in the input) the whole-buffer escape equals the
    # per-block escape and the (B, S) matrix is a single reshape — no
    # per-block Python loop, no per-block bytes objects
    bs = len(blocks[0]) if nb else 0
    if bs > 0 and all(len(b) == bs for b in blocks[:-1]) and len(blocks[-1]) <= bs:
        arr = np.frombuffer(b"".join(blocks), dtype=np.uint8)
        if not ((arr == 0x5C) | (arr == 0xFF)).any():
            S = _bucket(bs, base=1024)
            esc = np.where(arr == 0x3C, np.uint8(0xFF), arr)
            x = np.zeros((B, S), dtype=np.uint8)
            full = arr.size // bs
            x[:full, :bs] = esc[: full * bs].reshape(full, bs)
            if arr.size % bs:
                x[full, : arr.size % bs] = esc[full * bs :]
            lengths = np.zeros(B, dtype=np.int32)
            lengths[:full] = bs
            if arr.size % bs:
                lengths[full] = arr.size % bs
            return x, lengths, S
    encs = [encode_opening_symbols(b) for b in blocks]
    S = _bucket(max((len(e) for e in encs), default=1), base=1024)
    x = np.zeros((B, S), dtype=np.uint8)
    lengths = np.zeros(B, dtype=np.int32)
    for i, e in enumerate(encs):
        x[i, : len(e)] = np.frombuffer(e, dtype=np.uint8)
        lengths[i] = len(e)
    return x, lengths, S


def _encode_lzss_pipeline(blocks: list[bytes], mesh, with_arith: bool, window: int = 4096):
    from raisin_jax.ops import pipeline_jax

    x, lengths, S = _escaped_blocks(blocks, mesh)
    B = x.shape[0]
    n = _mesh_size(mesh)
    if with_arith:
        bound = arithmetic_scan.BITS_PER_STEP_BOUND * (S + 8) * (B // n) // 8 + B * 4
        caps = (_cap_bytes(int(lengths.sum()), B) // n * n, bound * n)
    else:
        caps = ((S * (B // n) + 16) * n,)  # tokens never exceed the input
    for cap in caps:
        fn = _spmd(
            pipeline_jax.lzss_encode_packed, mesh, 2, 4,
            window=window, cap_bytes=cap // n, with_arith=with_arith,
        )
        flat, out_lens, tok_lens, oflow = fn(_shard_blocks(x, mesh), _shard_blocks(lengths, mesh))
        out_lens = np.asarray(out_lens)
        if _fits(out_lens, cap, mesh):
            break
    tok_lens = np.asarray(tok_lens)
    payloads = _split_flat(np.asarray(flat), out_lens, len(blocks), mesh)
    # a carried pending run past the kernel's bound: exact host re-encode
    for i in np.nonzero(np.asarray(oflow)[: len(blocks)])[0]:
        payloads[i] = _native("arithmetic").compress(_native("lzss").compress(blocks[i], window))
    return payloads, [int(t) for t in tok_lens[: len(blocks)]]


def _encode_lzss_batch(blocks: list[bytes], mesh, window: int = 4096) -> list[bytes]:
    payloads, _ = _encode_lzss_pipeline(blocks, mesh, with_arith=False, window=window)
    return payloads


def _encode_lzss_arithmetic_batch(blocks: list[bytes], mesh, window: int = 4096):
    return _encode_lzss_pipeline(blocks, mesh, with_arith=True, window=window)


# ---------------------------------------------------------------------------
# Device batch decoders


def _flat_segments(payloads: list[bytes], mesh):
    """Concatenate payloads into per-device segments with LOCAL offsets: each
    shard holds only its own bytes (a replicated flat buffer would broadcast
    the whole stream to every device and serialize the readback).

    Returns (flat, offs, lens, max_bytes, B)."""
    B = _pad_block_count(len(payloads), mesh)
    n = _mesh_size(mesh)
    per_seg = B // n
    lens = np.zeros(B, dtype=np.int32)
    lens[: len(payloads)] = [len(p) for p in payloads]
    seg_lens = lens.reshape(n, per_seg)
    ends = np.cumsum(seg_lens, axis=1)
    offs = (ends - seg_lens).astype(np.int32).reshape(B)
    cap_local = _bucket(int(ends[:, -1].max()) + 16, base=128)
    flat = np.zeros(n * cap_local, dtype=np.uint8)
    for seg in range(n):
        chunk = b"".join(payloads[seg * per_seg : (seg + 1) * per_seg])
        flat[seg * cap_local : seg * cap_local + len(chunk)] = np.frombuffer(chunk, dtype=np.uint8)
    return flat, offs, lens, _bucket(int(lens.max()), base=128), B


def _decode_arithmetic_batch(payloads: list[bytes], out_lens: list[int], mesh) -> list[bytes]:
    flat, offs, lens, max_bytes, B = _flat_segments(payloads, mesh)
    outl = np.zeros(B, dtype=np.int32)
    outl[: len(out_lens)] = out_lens
    steps = _bucket(max(out_lens) + 1)
    dec = _spmd(
        arithmetic_scan.decode_blocks_packed, mesh, 4, 2,
        num_steps=steps, max_bytes=max_bytes,
    )
    syms, eof_ok = dec(*(_shard_blocks(a, mesh) for a in (flat, offs, lens, outl)))
    syms = np.asarray(syms)
    eof_ok = np.asarray(eof_ok)
    out = []
    for i in range(len(payloads)):
        if not bool(eof_ok[i]):
            raise ValueError(f"container: block {i} missing EOF symbol")
        out.append(syms[i, : out_lens[i]].tobytes())
    return out


def _decode_lzss_arithmetic_batch(
    payloads: list[bytes], tok_lens: list[int], out_lens: list[int], mesh
) -> list[bytes]:
    """lzss,arithmetic decode with the token streams kept on the device
    (pipeline_jax.lzss_arith_decode); the host reads back the decoded rows.

    Escape-expanding blocks (a 0x5C in the escaped text) get the exact
    escape decode on the host; a block whose escaped text outgrows the row
    capacity is decoded on the host from its payload."""
    from raisin_jax.ops import pipeline_jax

    flat, offs, lens, max_bytes, B = _flat_segments(payloads, mesh)
    tl = np.zeros(B, dtype=np.int32)
    tl[: len(tok_lens)] = tok_lens
    steps = _bucket(max(tok_lens) + 1)
    mo = max(out_lens)
    # escaped text is at most twice the block; size rows for the common case
    cap_out = _gbucket(mo + mo // 8 + 128, base=4096)
    dec = _spmd(
        pipeline_jax.lzss_arith_decode, mesh, 4, 4,
        num_steps=steps, max_bytes=max_bytes, cap_out=cap_out,
    )
    rows, out_len, eof_ok, esc = dec(*(_shard_blocks(a, mesh) for a in (flat, offs, lens, tl)))
    count = len(payloads)
    eof_ok = np.asarray(eof_ok)[:count]
    if not eof_ok.all():
        raise ValueError(f"container: block {int(np.argmin(eof_ok))} missing EOF symbol")
    out_len = np.asarray(out_len)[:count]
    esc = np.asarray(esc)[:count]
    body = np.asarray(rows[:, :mo])
    out = []
    for i in range(count):
        if not esc[i] and out_len[i] == out_lens[i]:
            out.append(body[i, : out_lens[i]].tobytes())
        elif out_len[i] <= cap_out:
            out.append(decode_opening_symbols_np(np.asarray(rows[i, : out_len[i]]).tobytes()))
        else:
            out.append(_native("lzss").decompress(_native("arithmetic").decompress(payloads[i])))
        if len(out[-1]) != out_lens[i]:
            raise ValueError(
                f"container: block {i} decoded {len(out[-1])} bytes, expected {out_lens[i]}"
            )
    return out


def _batched(fn, mesh, block_size: int, *columns):
    """Run a batch coder over dispatch-sized slices of per-block columns and
    join the results (lists, or tuples of lists)."""
    parts = [
        fn(*(c[lo:hi] for c in columns), mesh)
        for lo, hi in _dispatches(len(columns[0]), block_size, mesh)
    ]
    if isinstance(parts[0], tuple):
        return tuple(sum((list(p[k]) for p in parts), []) for k in range(len(parts[0])))
    return sum((list(p) for p in parts), [])


# ---------------------------------------------------------------------------
# Container


def compress_container(
    data: bytes,
    algorithms: list[str] | tuple[str, ...] = ("lzss", "arithmetic"),
    block_size: int = DEFAULT_BLOCK_SIZE,
    mesh=None,
    window: int = 4096,
) -> bytes:
    """Block-parallel encode into the RSNB container.

    ``window`` is the LZSS search window (lz.NewWriterLevel parity,
    lzss.go:42). With block_size >> window it sets the speed/ratio point:
    match-search work scales ~linearly with the window while the ratio
    improves with it; payloads stay reference-decodable at any value (the
    token format carries explicit distances).
    """
    algorithms = tuple(algorithms)
    blocks = [data[i : i + block_size] for i in range(0, len(data), block_size)] or [b""]
    lz_device = window <= MAX_DEVICE_WINDOW

    aux: list[list[int]] = []
    if algorithms == ("arithmetic",):
        payloads = _batched(_encode_arithmetic_batch, mesh, block_size, blocks)
    elif algorithms == ("lzss",) and lz_device:
        payloads = _batched(
            functools.partial(_encode_lzss_batch, window=window), mesh, block_size, blocks
        )
    elif algorithms == ("lzss", "arithmetic") and lz_device:
        payloads, inter_lens = _batched(
            functools.partial(_encode_lzss_arithmetic_batch, window=window),
            mesh, block_size, blocks,
        )
        aux.append(inter_lens)
    elif algorithms == ("huffman",):
        from raisin_jax.ops import huffman_blocks

        payloads = huffman_blocks.encode_blocks(blocks)
    elif algorithms == ("lzss", "huffman") and lz_device:
        from raisin_jax.ops import huffman_blocks

        tokens = _batched(
            functools.partial(_encode_lzss_batch, window=window), mesh, block_size, blocks
        )
        payloads = huffman_blocks.encode_blocks(tokens)
        aux.append([len(t) for t in tokens])
    else:
        # host path: any registered pipeline, still block-split (window
        # honored for lzss layers; windows past MAX_DEVICE_WINDOW land here)
        from raisin_jax.engine.core import compress_bytes

        payloads = []
        for b in blocks:
            payloads.append(compress_bytes(b, algorithms, window=window))
            _progress(len(payloads), len(blocks))

    return assemble_container(payloads, aux, algorithms, block_size, window, len(data))


def assemble_container(
    payloads: list[bytes],
    aux: list[list[int]],
    algorithms: tuple[str, ...],
    block_size: int,
    window: int,
    orig_size: int,
) -> bytes:
    """Frame already-encoded per-block payloads as an RSNB container.

    The multi-host path uses this directly: each process encodes its
    process_block_range locally, segments are gathered in rank order, and
    this single cheap header pass makes them one container.
    """
    algo_str = ",".join(algorithms).encode("ascii")
    head = MAGIC + struct.pack(
        "<BB", VERSION, len(algo_str)
    ) + algo_str + struct.pack("<IIQIB", block_size, window, orig_size, len(payloads), len(aux))
    sizes = struct.pack(f"<{len(payloads)}I", *(len(p) for p in payloads))
    aux_tables = b"".join(struct.pack(f"<{len(t)}I", *t) for t in aux)
    return head + sizes + aux_tables + b"".join(payloads)


def parse_container(data: bytes):
    if data[:4] != MAGIC:
        raise ValueError("not an RSNB container")
    version, algo_len = struct.unpack_from("<BB", data, 4)
    if version not in (1, VERSION):
        raise ValueError(f"unsupported RSNB version {version}")
    pos = 6
    algorithms = tuple(data[pos : pos + algo_len].decode("ascii").split(","))
    pos += algo_len
    if version == 1:
        block_size, orig_size, num_blocks, num_aux = struct.unpack_from("<IQIB", data, pos)
        window = 4096
        pos += 17
    else:
        block_size, window, orig_size, num_blocks, num_aux = struct.unpack_from(
            "<IIQIB", data, pos
        )
        pos += 21
    sizes = struct.unpack_from(f"<{num_blocks}I", data, pos)
    pos += 4 * num_blocks
    aux = []
    for _ in range(num_aux):
        aux.append(list(struct.unpack_from(f"<{num_blocks}I", data, pos)))
        pos += 4 * num_blocks
    payloads = []
    for s in sizes:
        payloads.append(data[pos : pos + s])
        pos += s
    return algorithms, block_size, orig_size, payloads, aux, window


def decompress_container(data: bytes, mesh=None) -> bytes:
    """Block-parallel decode of an RSNB container."""
    algorithms, block_size, orig_size, payloads, aux, window = parse_container(data)
    out_lens = [
        min(block_size, orig_size - i * block_size) for i in range(len(payloads))
    ]
    if orig_size == 0:
        return b""

    if algorithms == ("arithmetic",):
        blocks = _batched(_decode_arithmetic_batch, mesh, block_size, payloads, out_lens)
    elif algorithms == ("lzss", "arithmetic") and aux and window <= MAX_DEVICE_WINDOW:
        blocks = _batched(
            _decode_lzss_arithmetic_batch, mesh, block_size, payloads, aux[0], out_lens
        )
    elif algorithms == ("lzss", "arithmetic") and aux:
        # windows past the device token parse: arithmetic layer on device,
        # LZSS token decode on the host (C native), pool-threaded
        inter = _batched(_decode_arithmetic_batch, mesh, block_size, payloads, aux[0])
        blocks = list(_pool().map(_native("lzss").decompress, inter))
    elif algorithms == ("huffman",):
        from raisin_jax.ops import huffman_blocks

        blocks = huffman_blocks.decode_blocks(payloads, out_bound=block_size)
    elif algorithms == ("lzss", "huffman"):
        from raisin_jax.ops import huffman_blocks

        bound = max(aux[0]) if aux and aux[0] else None
        tokens = huffman_blocks.decode_blocks(payloads, out_bound=bound)
        blocks = list(_pool().map(_native("lzss").decompress, tokens))
    else:
        from raisin_jax.engine.core import decompress_bytes

        blocks = [decompress_bytes(p, list(algorithms)) for p in payloads]

    out = b"".join(blocks)
    if len(out) != orig_size:
        raise ValueError(f"container: decoded {len(out)} bytes, expected {orig_size}")
    return out
