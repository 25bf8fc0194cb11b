"""Native (C) host runtime: fast sequential paths sharing the exact formats.

Compiled from ``src/rsn_native.c`` with g++ on first use (result cached by
source hash under ``.build/native/`` in the checkout, git-ignored) and
loaded via ctypes.
Registered into the engine registry under the ``native`` backend tag; every
byte it produces is identical to the host oracle / device kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

_SRC = os.path.join(os.path.dirname(__file__), "src", "rsn_native.c")
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_CACHE = os.environ.get("RAISIN_NATIVE_CACHE") or os.path.join(_REPO, ".build", "native")

_lib = None


class NativeBuildError(RuntimeError):
    pass


def _build() -> str:
    with open(_SRC, "rb") as f:
        src = f.read()
    tag = hashlib.sha256(src).hexdigest()[:16]
    os.makedirs(_CACHE, exist_ok=True)
    so_path = os.path.join(_CACHE, f"rsn_native-{tag}.so")
    if os.path.exists(so_path):
        return so_path
    tmp = so_path + ".tmp"
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-x", "c", _SRC, "-o", tmp]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise NativeBuildError(f"native build failed:\n{proc.stderr}")
    os.replace(tmp, so_path)
    return so_path


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(_build())
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.rsn_free.argtypes = [u8p]
    lib.rsn_free.restype = None
    for name, extra in (
        ("rsn_lzss_compress", [ctypes.c_int]),
        ("rsn_lzss_decompress", []),
        ("rsn_arith_compress", []),
        ("rsn_arith_decompress", []),
        ("rsn_mcc_compress", []),
        ("rsn_mcc_decompress", []),
        ("rsn_dmc_compress", []),
        ("rsn_dmc_decompress", []),
    ):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_char_p, ctypes.c_long] + extra + [
            ctypes.POINTER(u8p),
            ctypes.POINTER(ctypes.c_long),
        ]
        fn.restype = ctypes.c_long
    _lib = lib
    return lib


def _call(fn_name: str, data: bytes, *extra) -> bytes:
    lib = _load()
    out_p = ctypes.POINTER(ctypes.c_uint8)()
    out_len = ctypes.c_long()
    rc = getattr(lib, fn_name)(
        data, ctypes.c_long(len(data)), *extra, ctypes.byref(out_p), ctypes.byref(out_len)
    )
    if rc != 0:
        # mirror the host oracles' messages (RSN_ERR_ALLOC=-1, RSN_ERR_FORMAT=-2,
        # RSN_ERR_DMC=-3)
        if rc == -2:
            raise ValueError(f"{fn_name}: malformed stream (ended without EOF symbol?)")
        if rc == -3:
            from raisin_jax.formats.dmc_ref import DmcError

            raise DmcError("dmc: stack emptied or no transition (reference panics)")
        raise MemoryError(f"{fn_name}: native allocation failure")
    try:
        return ctypes.string_at(out_p, out_len.value)
    finally:
        lib.rsn_free(out_p)


def lzss_compress(data: bytes, window_size: int = 4096) -> bytes:
    return _call("rsn_lzss_compress", data, ctypes.c_int(window_size))


def lzss_decompress(data: bytes) -> bytes:
    return _call("rsn_lzss_decompress", data)


def arith_compress(data: bytes) -> bytes:
    return _call("rsn_arith_compress", data)


def arith_decompress(data: bytes) -> bytes:
    return _call("rsn_arith_decompress", data)


def mcc_compress(data: bytes) -> bytes:
    return _call("rsn_mcc_compress", data)


def mcc_decompress(data: bytes) -> bytes:
    return _call("rsn_mcc_decompress", data)


def dmc_compress(data: bytes) -> bytes:
    return _call("rsn_dmc_compress", data)


def dmc_decompress(data: bytes) -> bytes:
    """Reference-parity stub (dmc.go:274): always b"Hello!"."""
    return _call("rsn_dmc_decompress", data)


def register() -> None:
    """Register native backends (called by engine.registry on import)."""
    from raisin_jax.engine.registry import register_backend

    _load()  # build now so failures surface as a registry warning
    register_backend("lzss", "native", lzss_compress, lzss_decompress)
    register_backend("arithmetic", "native", arith_compress, arith_decompress)
    register_backend("mcc", "native", mcc_compress, mcc_decompress)
    register_backend("dmc", "native", dmc_compress, dmc_decompress)
