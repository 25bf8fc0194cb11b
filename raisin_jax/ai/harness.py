"""Benchmark harness + dataset generation (parity with reference ai/main.py).

The reference downloads the Canterbury/Calgary corpora and generates
synthetic PDFs/JPEGs (ai/main.py:14-29, helpers/generator.py), benchmarks
every file × algorithm through engine.BenchmarkFile with WriteOutFiles=False
(helpers/compressor.py:91-98), and dumps data.json. This environment has no
network, so the corpus is synthesized locally with comparable variety.
"""

from __future__ import annotations

import json
import os
import random

from raisin_jax.ai.features import entropy_nats, file_features, sniff_mime
from raisin_jax.engine.benchmark import Settings, benchmark_file

DEFAULT_ALGORITHMS = [
    ["lzss"],
    ["huffman"],
    ["arithmetic"],
    ["flate"],
    ["gzip"],
    ["lzw"],
    ["zlib"],
    ["lzss", "arithmetic"],
    ["lzss", "huffman"],
]


def _words(rng: random.Random, n: int) -> bytes:
    vocab = [
        "the", "of", "and", "a", "to", "in", "is", "you", "that", "it",
        "compression", "entropy", "window", "stream", "block", "frequency",
        "probability", "symbol", "token", "dictionary", "algorithm",
    ]
    out = []
    size = 0
    while size < n:
        w = rng.choice(vocab)
        out.append(w)
        size += len(w) + 1
    return " ".join(out).encode()[:n]


def generate_dataset(directory: str, seed: int = 0) -> list[str]:
    """Synthesize a varied corpus (text, structured, repetitive, binary)."""
    rng = random.Random(seed)
    os.makedirs(directory, exist_ok=True)
    files: list[str] = []

    def emit(name: str, data: bytes) -> None:
        path = os.path.join(directory, name)
        with open(path, "wb") as f:
            f.write(data)
        files.append(path)

    emit("plain.txt", _words(rng, 40_000))
    emit("repetitive.txt", (b"na na na hey hey hey goodbye\n" * 800)[:20_000])
    emit("random.bin", bytes(rng.randrange(256) for _ in range(20_000)))
    emit("zeros.bin", b"\x00" * 8 + bytes(rng.randrange(1, 256) for _ in range(30)) * 500)
    emit(
        "structured.csv",
        b"".join(
            b"%d,%s,%d.%02d\n" % (i, b"item", rng.randrange(1000), rng.randrange(100))
            for i in range(2000)
        ),
    )
    emit(
        "halfhalf.bin",
        _words(rng, 10_000) + bytes(rng.randrange(256) for _ in range(10_000)),
    )
    return files


def benchmark_files(
    files: list[str],
    algorithms: list[list[str]] | None = None,
    out_json: str | None = None,
) -> list[dict]:
    """Per-file per-algorithm results (shape of the reference's data.json)."""
    algorithms = algorithms or DEFAULT_ALGORITHMS
    records = []
    for path in files:
        with open(path, "rb") as f:
            data = f.read()
        record = {
            "file": os.path.basename(path),
            "size": len(data),
            "entropy_nats": entropy_nats(data),
            "mime": sniff_mime(data),
            "features": file_features(data).tolist(),
            "results": [],
        }
        for algo in algorithms:
            try:
                r = benchmark_file(algo, path, Settings())
                record["results"].append(
                    {
                        "algorithms": algo,
                        "ratio_pct": r.ratio,
                        "seconds": r.seconds,
                        "lossless": r.lossless,
                    }
                )
            except Exception as exc:  # failure isolation, like the suite
                record["results"].append(
                    {"algorithms": algo, "failed": True, "error": str(exc)}
                )
        lossless = [r for r in record["results"] if r.get("lossless")]
        if lossless:
            best = min(lossless, key=lambda r: r["ratio_pct"])
            record["best"] = best["algorithms"]
        records.append(record)
    if out_json:
        with open(out_json, "w") as f:
            json.dump(records, f, indent=1)
    return records
