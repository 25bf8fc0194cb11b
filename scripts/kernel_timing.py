"""Time each device kernel of the container path against its plain version.

    python scripts/kernel_timing.py [--mb 64]

On one GPU, at the headline shape (64 KiB blocks, window 4096, 1024 blocks
per 64 MiB), in one process:

- arithmetic encode: the Pallas kernel (ops/arithmetic_gpu.encode_packed)
  against the XLA scan and bit expansion it replaces;
- arithmetic decode: the kernel against the XLA scan decode;
- LZSS token decode: the XLA decode (lzss_jax.decode_blocks) against the
  native C decode, pool-threaded, of the same token streams;
- LZSS match search and commit (XLA), for the record;
- end to end: the 64 MiB lzss,arithmetic container encode and decode with
  the kernels, then with the XLA scans swapped in here (the package has no
  switch), and the decode with the LZSS layer on the host instead.

Device times end in ``block_until_ready``; each is the best of ``--iters``
runs after a warm-up run. With ``--trace`` the device stages also run once
under ``jax.profiler.trace`` and the device time of each XLA module and op
is read back from the trace. Results print as JSON and go to
chiprun_out/kernel_timing.json, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BLOCK = 65536
WINDOW = 4096


def best(fn, iters: int) -> float:
    import jax

    jax.block_until_ready(fn())  # warm-up (compiles)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return min(times)


def reduce_trace(path: str) -> dict:
    """Device time per kernel on the GPU compute streams (top 12, seconds),
    the copy time, and the device's busy time: the union of all its
    compute and copy intervals."""
    from jax.profiler import ProfileData

    ops: collections.Counter = collections.Counter()
    copies = 0.0
    spans = []
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for e in line.events:
                if "Compute" in line.name and not e.name.startswith("Memcpy"):
                    ops[e.name] += e.duration_ns * 1e-9
                else:
                    copies += e.duration_ns * 1e-9
                spans.append((e.start_ns, e.start_ns + e.duration_ns))
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return {"kernels": dict(ops.most_common(12)), "kernel_s": sum(ops.values()),
            "copy_s": copies, "busy_s": busy * 1e-9}


def trace_device_times(fn, out_dir: str) -> dict:
    """Run fn once under the profiler; reduce_trace of it, with the host
    wall time of the run (idle share = 1 - busy_s / wall_s)."""
    import jax

    with jax.profiler.trace(out_dir):
        t0 = time.perf_counter()
        fn()
        wall = time.perf_counter() - t0
    path = sorted(glob.glob(os.path.join(out_dir, "plugins", "profile", "*", "*.xplane.pb")))[-1]
    return {**reduce_trace(path), "wall_s": wall}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mb", type=int, default=64)
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--trace", action="store_true", help="also read device times from a trace")
    args = ap.parse_args()

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    import jax
    import jax.numpy as jnp

    from bench import make_corpus
    from raisin_jax.native import lzss_decompress
    from raisin_jax.ops import arithmetic_gpu, arithmetic_scan, lzss_jax
    from raisin_jax.parallel import blocks as blk

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX found {dev.platform!r}")
    res: dict = {"card": card, "device_kind": dev.device_kind, "mb": args.mb}
    data = make_corpus(args.mb << 20)
    B = len(data) // BLOCK
    x, lengths, S = blk._escaped_blocks([data[i * BLOCK : (i + 1) * BLOCK] for i in range(B)], None)
    x, lengths = jnp.asarray(x), jnp.asarray(lengths)
    xi = jnp.where(jnp.arange(S)[None, :] < lengths[:, None], x.astype(jnp.int32), -1)

    match = jax.jit(lzss_jax.find_matches_blocks, static_argnums=(2, 3))
    res["match_s"] = best(lambda: match(xi, lengths, WINDOW, S // lzss_jax.TILE), args.iters)
    L, D = match(xi, lengths, WINDOW, S // lzss_jax.TILE)
    res["commit_s"] = best(lambda: lzss_jax.commit_blocks(xi, L, D, lengths), args.iters)
    tok, tok_len = lzss_jax.commit_blocks(xi, L, D, lengths)
    steps = (S + 8 + 127) // 128 * 128
    payload = jnp.pad(tok, ((0, 0), (0, steps - S)))
    cap = int(np.asarray(tok_len).sum()) + 16 * B + 4096
    mbits = (9 * steps + 32 + 7) // 8 * 8
    res.update(blocks=B, steps=steps, token_bytes=int(np.asarray(tok_len).sum()))
    print(json.dumps(res), flush=True)

    enc_k = jax.jit(arithmetic_gpu.encode_packed, static_argnums=(2, 3))
    enc_x = jax.jit(arithmetic_scan._encode_packed_xla, static_argnums=(2, 3, 4))
    res["arith_encode_kernel_s"] = best(lambda: enc_k(payload, tok_len, cap, mbits), args.iters)
    res["arith_encode_kernel_stream_s"] = best(
        lambda: arithmetic_gpu.encode_stream(payload, tok_len, mbits // 8), args.iters
    )
    print(json.dumps(res), flush=True)
    res["arith_encode_xla_s"] = best(lambda: enc_x(payload, tok_len, steps, cap, mbits), 1)
    flat, blen, _ = enc_k(payload, tok_len, cap, mbits)
    blen_np = np.asarray(blen)
    offs = jnp.asarray(np.concatenate([[0], np.cumsum(blen_np)[:-1]]).astype(np.int32))
    dargs = (flat, offs, blen, tok_len)
    dec_k = jax.jit(arithmetic_gpu.decode_packed, static_argnames=("num_steps",))
    dec_x = jax.jit(arithmetic_scan._decode_packed_xla, static_argnames=("num_steps", "max_bytes"))
    res["arith_decode_kernel_s"] = best(lambda: dec_k(*dargs, num_steps=steps), args.iters)
    mxb = blk._bucket(int(blen_np.max()), base=128)
    res["arith_decode_xla_s"] = best(lambda: dec_x(*dargs, num_steps=steps, max_bytes=mxb), 1)
    print(json.dumps(res), flush=True)

    cap_out = blk._gbucket(BLOCK + BLOCK // 8 + 128, base=4096)
    res["lzss_decode_xla_s"] = best(lambda: lzss_jax.decode_blocks(tok, tok_len, cap_out), args.iters)
    tok_np, tl_np = np.asarray(tok), np.asarray(tok_len)
    streams = [tok_np[i, : tl_np[i]].tobytes() for i in range(B)]

    def host_lzss():
        return list(blk._pool().map(lzss_decompress, streams))

    res["lzss_decode_native_pool_s"] = best(host_lzss, args.iters)
    print(json.dumps(res), flush=True)

    if args.trace:
        def stages():
            jax.block_until_ready(match(xi, lengths, WINDOW, S // lzss_jax.TILE))
            jax.block_until_ready(lzss_jax.commit_blocks(xi, L, D, lengths))
            jax.block_until_ready(enc_k(payload, tok_len, cap, mbits))
            jax.block_until_ready(dec_k(*dargs, num_steps=steps))
            jax.block_until_ready(lzss_jax.decode_blocks(tok, tok_len, cap_out))

        res["trace"] = trace_device_times(stages, os.path.join("chiprun_out", "trace"))
        print(json.dumps(res["trace"]), flush=True)

    # end to end: kernels, then the XLA scans swapped in
    from raisin_jax.parallel.blocks import compress_container, decompress_container

    def e2e(tag: str, iters: int) -> bytes:
        c = compress_container(data, ("lzss", "arithmetic"), block_size=BLOCK, window=WINDOW)
        res[f"e2e_encode_{tag}_s"] = best(
            lambda: compress_container(data, ("lzss", "arithmetic"), block_size=BLOCK, window=WINDOW),
            iters,
        )
        res[f"e2e_decode_{tag}_s"] = best(lambda: decompress_container(c), iters)
        assert decompress_container(c) == data
        print(json.dumps(res), flush=True)
        return c

    c_kernel = e2e("kernel", args.iters)
    if args.trace:
        res["trace_e2e_encode"] = trace_device_times(
            lambda: compress_container(data, ("lzss", "arithmetic"), block_size=BLOCK, window=WINDOW),
            os.path.join("chiprun_out", "trace_encode"),
        )
        res["trace_e2e_decode"] = trace_device_times(
            lambda: decompress_container(c_kernel), os.path.join("chiprun_out", "trace_decode")
        )
        print(json.dumps({k: res[k] for k in ("trace_e2e_encode", "trace_e2e_decode")}), flush=True)
    algos, bs, _, payloads, aux, _ = blk.parse_container(c_kernel)
    out_lens = [min(bs, len(data) - i * bs) for i in range(len(payloads))]

    def host_lzss_decode():
        inter = blk._decode_arithmetic_batch(payloads, aux[0], None)
        return list(blk._pool().map(lzss_decompress, inter))

    res["e2e_decode_kernel_host_lzss_s"] = best(host_lzss_decode, args.iters)
    assert b"".join(host_lzss_decode()) == data
    assert b"".join(blk._decode_lzss_arithmetic_batch(payloads, aux[0], out_lens, None)) == data

    arithmetic_gpu.encode_packed = lambda p, n, cap_b, mb: arithmetic_scan._encode_packed_xla(
        p, n, p.shape[1], cap_b, mb
    )
    arithmetic_gpu.decode_packed = lambda f, o, b, n, num_steps: arithmetic_scan._decode_packed_xla(
        f, o, b, n, num_steps=num_steps, max_bytes=blk._bucket(int(max(len(p) for p in payloads)), base=128)
    )
    jax.clear_caches()
    c_xla = e2e("xla", 1)
    assert c_xla == c_kernel, "kernel and XLA containers differ"
    res["peak_bytes_in_use"] = (dev.memory_stats() or {}).get("peak_bytes_in_use")
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "kernel_timing.json"), "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
