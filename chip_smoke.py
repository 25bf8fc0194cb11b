"""Smoke test of the container path on one NVIDIA GPU, end to end.

    python chip_smoke.py          # one GPU: every phase below
    python chip_smoke.py --four   # four GPUs: the 'data' mesh path only

Phases (one process; any failure exits non-zero and prints no result line):

1. device: platform, kind, count, the card's name and power limit; the
   device and native backends must be registered.
2. kernels: the arithmetic encode and decode kernels compiled at the real
   width (1024 blocks of 64 KiB, the production steps), compared byte for
   byte with the XLA scans they replace.
3. main path: a 64 MiB lzss,arithmetic container (block 65536, window 4096),
   every block equal to the native oracle's arith(lzss(block)), and the
   decode equal to the input.
4. other pipelines: arithmetic and lzss,huffman containers of 8 MiB.
5. CLI: ``raisin FILE -container`` then ``grape FILE.rsn -no-delete``, run
   in-process.
6. timings: compile (warm-up) seconds, encode and decode MB/s, peak device
   memory.

With ``--four`` it runs a 256 MiB container over a four-device mesh
(64 MiB per card) and the one-card container it must equal, and nothing
else. The last line is one JSON object: ok, and the device as JAX reports it.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

BLOCK = 65536
WINDOW = 4096
MAIN_MB = 64


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


def _phase(name: str):
    print(f"== {name}", flush=True)


def device_phase(card: str):
    import jax

    from raisin_jax.engine import registry

    devs = jax.devices()
    d = devs[0]
    print(f"platform={d.platform} kind={d.device_kind} count={len(devs)}")
    print(f"nvidia-smi: {card}")
    if d.platform != "gpu":
        raise SystemExit(f"no GPU: JAX found platform {d.platform!r}")
    missing = [c for c in ("arithmetic", "lzss", "huffman") if "device" not in registry.available_backends(c)]
    if missing:
        raise SystemExit(f"device backends not registered for {missing}")
    from raisin_jax import native

    native._load()
    print("backends: device registered for arithmetic/lzss/huffman; native C loaded "
          f"({registry.available_backends('lzss')})")
    return d


def kernels_phase(data: bytes, card: str) -> None:
    import jax
    import jax.numpy as jnp

    from raisin_jax.ops import arithmetic_gpu, arithmetic_scan, lzss_jax
    from raisin_jax.parallel import blocks as blk

    B = len(data) // BLOCK
    x, lengths, S = blk._escaped_blocks([data[i * BLOCK : (i + 1) * BLOCK] for i in range(B)], None)
    xi = jnp.where(jnp.arange(S)[None, :] < lengths[:, None], jnp.asarray(x).astype(jnp.int32), -1)
    L, D = lzss_jax.find_matches_blocks(xi, jnp.asarray(lengths), WINDOW, S // lzss_jax.TILE)
    tok, tok_len = lzss_jax.commit_blocks(xi, L, D, jnp.asarray(lengths))
    steps = (S + 8 + 127) // 128 * 128
    payload = jnp.pad(tok, ((0, 0), (0, steps - S)))
    cap = int(np.asarray(tok_len).sum()) + 16 * B + 4096
    mbits = (9 * steps + 32 + 7) // 8 * 8

    enc_k = jax.jit(arithmetic_gpu.encode_packed, static_argnums=(2, 3))
    enc_x = jax.jit(arithmetic_scan._encode_packed_xla, static_argnums=(2, 3, 4))
    compiled = enc_k.lower(payload, tok_len, cap, mbits).compile()
    print(f"encode kernel B={B} steps={steps}: {compiled.memory_analysis()}")
    got = enc_k(payload, tok_len, cap, mbits)
    want = enc_x(payload, tok_len, steps, cap, mbits)
    assert not np.asarray(got[2]).any(), "encode kernel overflow flag"
    assert np.array_equal(np.asarray(got[1]), np.asarray(want[1])), "encode byte lengths differ"
    assert np.array_equal(np.asarray(got[0]), np.asarray(want[0])), "encode bytes differ"
    total = int(np.asarray(got[1]).sum())
    print(f"encode kernel == XLA scan: {B} blocks, {total} bytes, byte-exact")

    blen = np.asarray(got[1])
    offs = jnp.asarray(np.concatenate([[0], np.cumsum(blen)[:-1]]).astype(np.int32))
    args = (got[0], offs, jnp.asarray(blen), tok_len)
    dec_k = jax.jit(arithmetic_gpu.decode_packed, static_argnames=("num_steps",))
    compiled = dec_k.lower(*args, num_steps=steps).compile()
    print(f"decode kernel B={B} steps={steps}: {compiled.memory_analysis()}")
    d1 = dec_k(*args, num_steps=steps)
    d2 = arithmetic_scan._decode_packed_xla(
        *args, num_steps=steps, max_bytes=blk._bucket(int(blen.max()), base=128)
    )
    assert np.asarray(d1[1]).all(), "decode kernel missed EOF"
    assert np.array_equal(np.asarray(d1[0]), np.asarray(d2[0])), "decode symbols differ"
    assert np.array_equal(np.asarray(d1[0])[:, :S], np.asarray(tok)), "decode != token streams"
    print(f"decode kernel == XLA scan == token streams: {B} blocks, byte-exact")


def dispatch_memory(blocks, payloads, tok_lens) -> None:
    """memory_analysis() of the main path's one encode and one decode
    dispatch at full size (the container's own shapes and statics)."""
    from raisin_jax.ops import pipeline_jax
    from raisin_jax.parallel import blocks as blk

    x, lengths, _ = blk._escaped_blocks(blocks, None)
    cap = blk._cap_bytes(int(lengths.sum()), x.shape[0])
    enc = pipeline_jax.lzss_encode_packed.lower(
        x, lengths, window=WINDOW, cap_bytes=cap, with_arith=True
    ).compile()
    print(f"encode dispatch B={x.shape[0]}: {enc.memory_analysis()}")
    flat, offs, lens, max_bytes, _ = blk._flat_segments(payloads, None)
    tl = np.asarray(tok_lens, dtype=np.int32)
    dec = pipeline_jax.lzss_arith_decode.lower(
        flat, offs, lens, tl, num_steps=blk._bucket(int(tl.max()) + 1), max_bytes=max_bytes,
        cap_out=blk._gbucket(BLOCK + BLOCK // 8 + 128, base=4096),
    ).compile()
    print(f"decode dispatch B={len(payloads)}: {dec.memory_analysis()}")


def main_path_phase(data: bytes, card: str, dev) -> dict:
    from raisin_jax.native import arith_compress, lzss_compress
    from raisin_jax.parallel.blocks import (
        _pool,
        compress_container,
        decompress_container,
        parse_container,
    )

    def enc():
        return compress_container(data, ("lzss", "arithmetic"), block_size=BLOCK, window=WINDOW)

    t0 = time.perf_counter()
    c = enc()
    warm_enc = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = decompress_container(c)
    warm_dec = time.perf_counter() - t0
    assert back == data, "64 MiB container round trip failed"
    _, bs, _, payloads, aux, _ = parse_container(c)
    blocks = [data[i : i + bs] for i in range(0, len(data), bs)]
    oracle = list(_pool().map(lambda b: arith_compress(lzss_compress(b, WINDOW)), blocks))
    bad = [i for i, (p, o) in enumerate(zip(payloads, oracle)) if p != o]
    assert not bad, f"blocks differ from the native oracle: {bad[:10]}"
    print(f"main path: {len(payloads)} blocks == native oracle arith(lzss(block)); "
          f"decode == input; container {len(c)} B ({len(c) / len(data) * 100:.3f}%)")
    dispatch_memory(blocks, payloads, aux[0])

    t0 = time.perf_counter()
    c2 = enc()
    enc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = decompress_container(c2)
    dec_s = time.perf_counter() - t0
    assert c2 == c and back == data
    peak = (dev.memory_stats() or {}).get("peak_bytes_in_use")
    mb = len(data) / 1e6
    print(f"timing [{card}]: warm-up (compile + first run) encode {warm_enc:.3f} s, "
          f"decode {warm_dec:.3f} s")
    print(f"timing [{card}]: encode {mb / enc_s:.3f} MB/s ({enc_s:.3f} s), "
          f"decode {mb / dec_s:.3f} MB/s ({dec_s:.3f} s), {MAIN_MB} MiB lzss,arithmetic")
    print(f"timing [{card}]: peak_bytes_in_use {peak} (since start, kernels phase included)")
    return {"encode_s": enc_s, "decode_s": dec_s}


def pipelines_phase(data: bytes) -> None:
    from raisin_jax.parallel.blocks import compress_container, decompress_container

    part = data[: 8 << 20]
    for algos in (("arithmetic",), ("lzss", "huffman")):
        t0 = time.perf_counter()
        c = compress_container(part, algos, block_size=BLOCK, window=WINDOW)
        assert decompress_container(c) == part, f"{algos} round trip failed"
        print(f"{','.join(algos)}: 8 MiB round trip ok, {len(c)} B, "
              f"{time.perf_counter() - t0:.3f} s with compiles")


def cli_phase(data: bytes) -> None:
    from raisin_jax.cli import main as cli_main

    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".build", "smoke")
    os.makedirs(work, exist_ok=True)
    path = os.path.join(work, "input.txt")
    with open(path, "wb") as f:
        f.write(data[: 3 << 20])
    assert cli_main(["raisin", path, "-container"]) == 0, "raisin -container failed"
    os.rename(path, path + ".orig")
    assert cli_main(["grape", path + ".rsn", "-no-delete"]) == 0, "grape failed"
    with open(path, "rb") as f:
        assert f.read() == data[: 3 << 20], "CLI round trip differs"
    assert os.path.exists(path + ".rsn")
    print("cli: raisin -container / grape -no-delete round trip ok (3 MiB)")


def four_phase(data: bytes, card: str) -> None:
    from raisin_jax.parallel.blocks import compress_container, decompress_container
    from raisin_jax.parallel.mesh import data_mesh

    mesh = data_mesh(4)

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0

    def enc(m):
        return compress_container(data, ("lzss", "arithmetic"), block_size=BLOCK, window=WINDOW, mesh=m)

    c4, warm4 = timed(lambda: enc(mesh))
    back, dwarm4 = timed(lambda: decompress_container(c4, mesh=mesh))
    assert back == data, "4-device round trip failed"
    c4, enc4 = timed(lambda: enc(mesh))
    back, dec4 = timed(lambda: decompress_container(c4, mesh=mesh))
    assert back == data, "4-device round trip failed"
    c1, enc1 = timed(lambda: enc(None))
    assert c4 == c1, "4-device container differs from the one-device container"
    mb = len(data) / 1e6
    print(f"four: {mb:.1f} MB over data_mesh(4) == one-device container byte for byte, "
          "decode == input")
    print(f"timing [{card} x4]: warm-up (compile + first run) encode {warm4:.3f} s, "
          f"decode {dwarm4:.3f} s")
    print(f"timing [{card} x4]: encode {mb / enc4:.3f} MB/s ({enc4:.3f} s), "
          f"decode {mb / dec4:.3f} MB/s ({dec4:.3f} s); one device, first run: "
          f"encode {enc1:.3f} s")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true", help="run only the four-GPU mesh path")
    args = ap.parse_args()

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    card = _card()
    import jax

    from bench import make_corpus

    _phase("device")
    dev = device_phase(card)
    n_need = 4 if args.four else 1
    if len(jax.devices()) < n_need:
        raise SystemExit(f"need {n_need} GPUs, found {len(jax.devices())}")
    if args.four:
        _phase("four")
        four_phase(make_corpus(4 * MAIN_MB << 20), card)
    else:
        data = make_corpus(MAIN_MB << 20)
        _phase("kernels")
        kernels_phase(data, card)
        _phase("main path")
        main_path_phase(data, card, dev)
        _phase("other pipelines")
        pipelines_phase(data)
        _phase("cli")
        cli_phase(data)
    print(f"card: {card}")
    print(json.dumps({
        "ok": True,
        "device": {"platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
