"""Benchmark entry point: prints ONE JSON line for the driver.

Headline metric: end-to-end encode throughput (MB/s) of the default
lzss,arithmetic pipeline in RSNB block-parallel container mode (host bytes
in -> container bytes out, including transfers and host assembly), on one
GPU; it exits when JAX finds no GPU. Every result names the device.

Config: 64 MiB input, 64 KiB blocks, LZSS window 4096 — the reference's
own operating point (lzss.go:35). Both knobs are CLI-exposed
(-blocksize / -window).

Ratio accounting (honest): `compression_ratio_pct` is the container's
real ratio; `oracle_whole_file_ratio_pct` is what raisin-Go's whole-file
stream would produce on the same data (measured via the byte-exact native
oracle on a sample); the gap is the price of block-parallel window resets
plus container framing, and `ratio_max_config_pct` shows the container
config that closes it (65536/4096) when ratio matters more than speed.

Per-kernel device times: scripts/kernel_timing.py.

Baseline: the reference publishes no GB/s figures (BASELINE.md). The only
measured datapoint is raisin-Go's arithmetic coder at 40155 B / 20.89 ms
= 1.92 MB/s (reference ai/data.json:1-30) — and its LZSS (goroutine per
byte) is far slower, so using 1.92 MB/s for the full lzss+arithmetic
pipeline is conservative in Go's favor.

Env knobs:
  RAISIN_BENCH_MB       input size in MiB (default 64)
  RAISIN_BENCH_BLOCK    block size in bytes (default 65536)
  RAISIN_BENCH_WINDOW   LZSS window (default 4096)
  RAISIN_BENCH_ITERS    timed iterations (default 3)
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

GO_BASELINE_MBPS = 40155 / 20.89e-3 / 1e6  # ai/data.json: arithmetic, 40155 B in 20.89 ms


def make_corpus(n_bytes: int, seed: int = 0) -> bytes:
    """Deterministic text-like corpus (word soup with repetition structure)."""
    rng = np.random.default_rng(seed)
    words = [
        b"the", b"quick", b"brown", b"fox", b"jumps", b"over", b"lazy", b"dog",
        b"compression", b"entropy", b"arithmetic", b"huffman", b"lzss", b"window",
        b"token", b"block", b"stream", b"model", b"frequency", b"symbol",
    ]
    idx = rng.integers(0, len(words), size=n_bytes // 5 + 16)
    out = b" ".join(words[i] for i in idx)
    return out[:n_bytes]


def _best(fn, iters):
    """Best wall time of ``iters`` calls; each ends in block_until_ready (the
    container paths return host bytes, so this only guards the clock)."""
    import jax

    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return min(times)


def device_info() -> dict:
    """The device as JAX reports it, and the card's name and power limit.
    Fails unless JAX's platform is the GPU: a CPU time is not a device time."""
    import subprocess

    import jax

    d = jax.devices()[0]
    if d.platform != "gpu":
        raise SystemExit(f"bench.py measures the GPU; JAX found platform {d.platform!r}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    return {"platform": d.platform, "kind": d.device_kind, "count": len(jax.devices()), "card": card}


def ratio_detail(data: bytes, container_len: int, block: int, window: int) -> dict:
    """Container ratio vs the whole-file oracle ratio (the raisin-Go
    equivalent stream, engine.go:443) on a sample, plus the max-ratio
    container config for context."""
    try:
        from raisin_jax.native import arith_compress, lzss_compress
    except Exception as e:  # pragma: no cover - native build failure
        return {"oracle_error": repr(e)[:120]}
    sample = data[: min(len(data), 4 << 20)]
    oracle = len(arith_compress(lzss_compress(sample)))
    return {
        "compression_ratio_pct": round(container_len / len(data) * 100, 2),
        "oracle_whole_file_ratio_pct": round(oracle / len(sample) * 100, 2),
        "ratio_gap_pct_points": round(
            container_len / len(data) * 100 - oracle / len(sample) * 100, 2
        ),
        "ratio_note": (
            f"gap = block window resets (bs={block}, win={window}) vs the "
            f"whole-file raisin-Go stream; oracle measured on a "
            f"{len(sample) >> 20} MiB sample"
        ),
    }


def native_baseline(data: bytes, window: int) -> dict:
    """Measured single-stream native C oracle throughput (same wire format,
    same pipeline): a faithful CPU baseline that bounds what raisin-Go could
    plausibly do on this machine, hardening the 10x claim's denominator
    (BASELINE.md:29-31 — no Go toolchain exists in this environment, and the
    C path reimplements the exact formats the Go code produces)."""
    try:
        from raisin_jax.native import (
            arith_compress,
            arith_decompress,
            lzss_compress,
            lzss_decompress,
        )
    except Exception as e:  # pragma: no cover - native build failure
        return {"native_error": repr(e)[:120]}
    sample = data[: min(len(data), 1 << 20)]
    t0 = time.perf_counter()
    toks = lzss_compress(sample, window)
    comp = arith_compress(toks)
    enc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = lzss_decompress(arith_decompress(comp))
    dec_s = time.perf_counter() - t0
    assert back == sample
    return {
        "native_c_encode_mbps": round(len(sample) / enc_s / 1e6, 3),
        "native_c_decode_mbps": round(len(sample) / dec_s / 1e6, 3),
        "native_c_sample_mb": round(len(sample) / 1e6, 2),
        "native_c_note": (
            "single-stream C oracle (rsn_native.c), same .rsn wire format "
            "and window; upper-bounds the Go reference on this host"
        ),
    }


def main() -> None:
    mb = float(os.environ.get("RAISIN_BENCH_MB", "64"))
    block = int(os.environ.get("RAISIN_BENCH_BLOCK", "65536"))
    window = int(os.environ.get("RAISIN_BENCH_WINDOW", "4096"))
    iters = int(os.environ.get("RAISIN_BENCH_ITERS", "3"))

    from raisin_jax.parallel.blocks import compress_container, decompress_container

    device = device_info()
    data = make_corpus(int(mb * (1 << 20)))

    # warm-up: compile + one full pass, and verify losslessness
    t0 = time.perf_counter()
    container = compress_container(
        data, ("lzss", "arithmetic"), block_size=block, window=window
    )
    warm = time.perf_counter() - t0
    assert decompress_container(container) == data, "bench round-trip failed"

    enc_s = _best(
        lambda: compress_container(
            data, ("lzss", "arithmetic"), block_size=block, window=window
        ),
        iters,
    )
    dec_s = _best(lambda: decompress_container(container), iters)

    detail = {
        "input_mb": round(len(data) / 1e6, 2),
        "block_size": block,
        "window": window,
        "warmup_s": round(warm, 2),
        "encode_s": round(enc_s, 4),
        "decode_s": round(dec_s, 4),
        "decode_mbps": round(len(data) / dec_s / 1e6, 3),
        "decode_vs_baseline": round(len(data) / dec_s / 1e6 / GO_BASELINE_MBPS, 2),
        "device": device,
        "go_baseline_mbps": round(GO_BASELINE_MBPS, 2),
        **ratio_detail(data, len(container), block, window),
        **native_baseline(data, window),
    }
    try:
        # secondary metric: the BASELINE config-4 stack (lzss,huffman) on the
        # block-parallel device path, smaller input to bound bench time
        hdata = data[: 8 << 20]
        hc = compress_container(hdata, ("lzss", "huffman"), block_size=block, window=window)
        assert decompress_container(hc) == hdata, "huffman stack round-trip failed"
        he = _best(
            lambda: compress_container(
                hdata, ("lzss", "huffman"), block_size=block, window=window
            ),
            max(1, iters - 1),
        )
        hd = _best(lambda: decompress_container(hc), max(1, iters - 1))
        detail["huffman_stack"] = {
            "input_mb": round(len(hdata) / 1e6, 2),
            "encode_mbps": round(len(hdata) / he / 1e6, 3),
            "decode_mbps": round(len(hdata) / hd / 1e6, 3),
            "compression_ratio_pct": round(len(hc) / len(hdata) * 100, 2),
        }
    except Exception as e:
        detail["huffman_stack_error"] = repr(e)[:200]

    mbps = len(data) / enc_s / 1e6
    result = {
        "metric": "encode_throughput_lzss_arithmetic_blocks",
        "value": round(mbps, 3),
        "unit": "MB/s",
        "vs_baseline": round(mbps / GO_BASELINE_MBPS, 2),
        "detail": detail,
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
