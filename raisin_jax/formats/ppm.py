"""PPM (prediction by partial matching) — placeholder, parity with the reference.

The reference's ``compressor/prediction/ppm.go`` is entirely commented out —
algorithm notes only (ppm.go:7-15): maintain per-context (order-k) symbol
statistics, predict the next byte from the longest matching context, fall
back through shorter contexts via escape symbols, and drive an arithmetic
coder with the blended probabilities.

Device design sketch for when this graduates (kept for parity with the
reference's notes): contexts hashed to a table of (context -> 256 counts)
rows living in HBM, batched gather per block position, the same scan
arithmetic coder as ops/arithmetic_scan for the entropy stage, blocks
data-parallel over the mesh exactly like the registered codecs.

Not registered in the engine (the reference never registers it either).
"""

from __future__ import annotations


def compress(data: bytes) -> bytes:  # pragma: no cover - parity placeholder
    raise NotImplementedError("ppm: placeholder, like the reference's compressor/prediction")


def decompress(data: bytes) -> bytes:  # pragma: no cover - parity placeholder
    raise NotImplementedError("ppm: placeholder, like the reference's compressor/prediction")
