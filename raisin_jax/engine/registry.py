"""Codec registry: algorithm names -> implementations.

Parity with the reference's ``Readers``/``Writers`` maps (engine/engine.go:48,101)
and the ``Engines``/``Suites`` declarations (engine/engine.go:33,36). Unlike the
reference — where the ``all``/``suite`` pseudo-entries are declared but never
expanded, so ``-algorithm=all`` panics — this registry expands them.

Backends: each codec may have several implementations registered under a
backend tag:

- ``host``   — the exact-format oracle (always present; NumPy/Python)
- ``native`` — C fast path (same format; registered by raisin_jax.native)
- ``device`` — JAX kernels: XLA, and Pallas on the GPU (registered by raisin_jax.ops)

``get_codec`` resolves the preferred backend with fallback device -> native
-> host. Every backend of a codec produces byte-identical output.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from raisin_jax.formats import (
    arithmetic_ref,
    dmc_ref,
    huffman_ref,
    lzss_ref,
    mcc_ref,
    stdlib_codecs,
)

ENGINES = [
    "all",
    "suite",
    "lzss",
    "dmc",
    "huffman",
    "mcc",
    "flate",
    "gzip",
    "lzw",
    "zlib",
    "arithmetic",
]

SUITES: dict[str, list[str]] = {
    "all": ENGINES[2:],
    "suite": ["lzss", "dmc", "huffman", "mcc", "flate", "gzip", "lzw", "zlib", "arithmetic"],
}

# Auto order for SINGLE-STREAM whole-file codecs (reference-parity `.rsn`
# paths, engine.go:443): the stream is one sequential scan, so the native C
# runtime is the fastest implementation at every size, and the device
# backend — which would pay a multi-second jit compile for zero intra-stream
# parallelism — comes last. The device scale path is the block container
# (parallel/blocks), which dispatches its own device pipelines and is
# unaffected by this order; `-backend=device` still forces the device codecs
# explicitly (and the container's host fallbacks deliberately bypass auto).
_FALLBACK_ORDER = ("native", "host", "device")


@dataclass(frozen=True)
class Codec:
    name: str
    backend: str
    compress: Callable[[bytes], bytes]
    decompress: Callable[[bytes], bytes]


# name -> backend -> (compress, decompress)
_IMPLS: dict[str, dict[str, tuple[Callable, Callable]]] = {}

_preferred_backend = "auto"


def register_backend(
    name: str,
    backend: str,
    compress: Callable[[bytes], bytes],
    decompress: Callable[[bytes], bytes],
) -> None:
    _IMPLS.setdefault(name, {})[backend] = (compress, decompress)


def set_preferred_backend(backend: str) -> None:
    """'auto' (device -> native -> host), or a specific backend tag."""
    global _preferred_backend
    _preferred_backend = backend


def available_backends(name: str) -> list[str]:
    return sorted(_IMPLS.get(name, {}))


def get_codec(name: str, backend: str | None = None) -> Codec:
    impls = _IMPLS.get(name)
    if impls is None:
        raise KeyError(f"unknown compression algorithm: {name!r}")
    want = backend or _preferred_backend
    if want != "auto":
        if want not in impls:
            want_order = (want,) + _FALLBACK_ORDER  # specific backend then fallbacks
        else:
            want_order = (want,)
    else:
        want_order = _FALLBACK_ORDER
    for tag in want_order:
        if tag in impls:
            c, d = impls[tag]
            return Codec(name, tag, c, d)
    raise KeyError(f"no implementation registered for {name!r}")


def expand_algorithms(algorithms: list[str]) -> list[str]:
    """Expand 'all'/'suite' pseudo-algorithms (functional superset of engine.go:36)."""
    out: list[str] = []
    for algo in algorithms:
        if algo in SUITES:
            out.extend(SUITES[algo])
        else:
            out.append(algo)
    return out


# --- host oracle registrations -------------------------------------------

register_backend("arithmetic", "host", arithmetic_ref.compress, arithmetic_ref.decompress)
register_backend("huffman", "host", huffman_ref.compress, huffman_ref.decompress)
register_backend("lzss", "host", lzss_ref.compress, lzss_ref.decompress)
register_backend("mcc", "host", mcc_ref.compress, mcc_ref.decompress)
register_backend("dmc", "host", dmc_ref.compress, dmc_ref.decompress)
register_backend("flate", "host", stdlib_codecs.flate_compress, stdlib_codecs.flate_decompress)
register_backend("gzip", "host", stdlib_codecs.gzip_compress, stdlib_codecs.gzip_decompress)
register_backend("zlib", "host", stdlib_codecs.zlib_compress, stdlib_codecs.zlib_decompress)
register_backend("lzw", "host", stdlib_codecs.lzw_compress, stdlib_codecs.lzw_decompress)


def _register_optional_backends() -> None:
    """Pull in native/device backends if their modules import cleanly."""
    import warnings

    for modname in ("raisin_jax.native", "raisin_jax.ops"):
        try:
            mod = __import__(modname, fromlist=["register"])
            mod.register()
        except ModuleNotFoundError:
            pass
        except Exception as exc:  # a broken accelerator must not take down the host path
            warnings.warn(f"{modname} backend unavailable: {exc!r}")


_register_optional_backends()
