#!/bin/sh
# CI benchmark + publish pipeline — the raisin-jax equivalent of the
# reference's Travis flow (/root/reference/.travis.yml:19-29), which runs
# the full Canterbury benchmark inside Docker (Dockerfile:19-20 fetches the
# corpus) and deploys the generated index.html to gh-pages.
#
# One command reproduces the published-page artifact:
#   scripts/ci_bench.sh [outdir]
#
# Steps:
#   1. materialize the (deterministic, network-free) Canterbury-shaped
#      corpus under $outdir/corpus/;
#   2. run the same benchmark command line the reference CI runs
#      (.travis.yml:19: algorithms lzss,dmc,huffman,flate,gzip,lzw,zlib,
#      arithmetic,[lzss,huffman],[lzss,arithmetic],[arithmetic,huffman])
#      with -generate to emit index.html;
#   3. copy index.html plus a machine-readable results.json into $outdir
#      (the gh-pages deploy step publishes whatever lands there).
set -eu

OUT="${1:-ci_out}"
SCALE="${RAISIN_CI_SCALE:-0.05}"
ROOT="$(cd "$(dirname "$0")/.." && pwd)"
mkdir -p "$OUT"
OUT="$(cd "$OUT" && pwd)"

cd "$ROOT"
python - "$OUT" "$SCALE" <<'EOF'
import json
import os
import sys

sys.path.insert(0, os.getcwd())
from raisin_jax.engine.benchmark import benchmark_suite
from raisin_jax.utils.corpus import write_corpus

out, scale = sys.argv[1], float(sys.argv[2])
corpus_dir = os.path.join(out, "corpus")
os.makedirs(corpus_dir, exist_ok=True)
files = write_corpus(corpus_dir, scale=scale)

# the reference CI's exact algorithm list (.travis.yml:19)
algorithms = [
    "lzss", "dmc", "huffman", "flate", "gzip", "lzw", "zlib", "arithmetic",
    ["lzss", "huffman"], ["lzss", "arithmetic"], ["arithmetic", "huffman"],
]
html, results = benchmark_suite(files, algorithms, generate_html=True)
with open(os.path.join(out, "index.html"), "w") as f:
    f.write(html)
rows = [
    {
        "engine": r.compression_engine,
        "time_taken": r.time_taken,
        "compression_ratio": r.ratio,
        "entropy": r.entropy,
        "lossless": r.lossless,
        "failed": r.failed,
        "original_bytes": r.original_bytes,
        "compressed_bytes": r.compressed_bytes,
    }
    for r in results
]
with open(os.path.join(out, "results.json"), "w") as f:
    json.dump(rows, f, indent=1)
print(f"wrote {out}/index.html and {out}/results.json ({len(rows)} rows)")
EOF
