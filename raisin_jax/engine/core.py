"""Algorithm layering and file orchestration.

Parity with reference engine/engine.go: stacking N algorithms feeds the full
output of layer k as the input of layer k+1 (engine.go:443-452), and
decompression applies the layers in reverse (engine.go:454-459). A `.rsn`
file has no container or header — layer identity/order is supplied
out-of-band (cmd/cli.go:99,133).
"""

from __future__ import annotations

import os
from typing import Iterable

from raisin_jax.engine.registry import expand_algorithms, get_codec

DEFAULT_WINDOW_SIZE = 4096


def compress_bytes(
    data: bytes,
    algorithms: Iterable[str],
    backend: str | None = None,
    window: int | None = None,
) -> bytes:
    """Apply codec layers in order (engine.go:443).

    ``window`` overrides the LZSS search window (lz.NewWriterLevel parity,
    lzss.go:42); other layers ignore it. Decompression never needs it (the
    token format carries explicit distances).
    """
    for name in expand_algorithms(list(algorithms)):
        codec = get_codec(name, backend)
        if name == "lzss" and window not in (None, DEFAULT_WINDOW_SIZE):
            data = _lzss_compress_windowed(data, window, codec.backend)
        else:
            data = codec.compress(data)
    return data


def _lzss_compress_windowed(data: bytes, window: int, backend: str) -> bytes:
    """LZSS compress at a non-default window on the selected backend."""
    if backend == "native":
        from raisin_jax.native import lzss_compress

        return lzss_compress(data, window)
    if backend == "device":
        from raisin_jax.ops import lzss_jax

        return lzss_jax.compress(data, window)
    from raisin_jax.formats import lzss_ref

    return lzss_ref.compress(data, window)


def decompress_bytes(data: bytes, algorithms: Iterable[str], backend: str | None = None) -> bytes:
    """Apply codec layers in reverse (engine.go:454)."""
    for name in reversed(expand_algorithms(list(algorithms))):
        data = get_codec(name, backend).decompress(data)
    return data


class CompressedFile:
    """Object API parity with reference engine.CompressedFile (engine.go:39).

    ``write`` compresses its argument and appends to ``compressed``;
    ``read`` lazily decompresses ``compressed`` into ``decompressed`` and
    streams it out in chunks.
    """

    def __init__(
        self,
        compression_engine: str = "",
        compressed: bytes = b"",
        max_search_buffer_length: int = DEFAULT_WINDOW_SIZE,
    ) -> None:
        self.compression_engine = compression_engine
        self.compressed = compressed
        self.decompressed: bytes | None = None
        self.max_search_buffer_length = max_search_buffer_length
        self._pos = 0

    def write(self, content: bytes) -> int:
        chunk = get_codec(self.compression_engine).compress(content)
        self.compressed += chunk
        return len(chunk)

    def read(self, size: int = -1) -> bytes:
        if self.decompressed is None:
            self.decompressed = get_codec(self.compression_engine).decompress(self.compressed)
        if size < 0:
            out = self.decompressed[self._pos :]
            self._pos = len(self.decompressed)
            return out
        out = self.decompressed[self._pos : self._pos + size]
        self._pos += len(out)
        return out


def get_compressed_file_from_path(path: str) -> CompressedFile:
    """Parity with engine.GetCompressedFileFromPath (engine.go:142)."""
    with open(path, "rb") as f:
        return CompressedFile(compressed=f.read())


def _resolve_mesh(devices: int | str | None):
    """Build the 1-D 'data' mesh for the container scale path.

    ``devices``: None/1 -> single device (no mesh); "auto" -> all visible
    devices; N -> the first N devices.
    """
    if devices in (None, 1, "1", ""):
        return None
    from raisin_jax.parallel.mesh import data_mesh

    if devices == "auto":
        return data_mesh()
    n = int(devices)
    return data_mesh(n) if n > 1 else None


def compress_file(
    algorithms: list[str],
    path: str,
    output: str,
    quiet: bool = False,
    backend: str | None = None,
    container: bool = False,
    block_size: int = 1 << 16,
    devices: int | str | None = None,
    window: int | None = None,
) -> bytes:
    """Parity with engine.CompressFile (engine.go:157).

    With ``container=True`` the output is an RSNB block container (the
    block-parallel scale path) instead of a raw layered stream; ``devices``
    shards the container blocks over a 'data' mesh (see _resolve_mesh);
    ``window`` sets the LZSS search window (NewWriterLevel parity).
    """
    with open(path, "rb") as f:
        contents = f.read()
    if not quiet:
        print("Compressing...")
    if container:
        from raisin_jax.parallel.blocks import compress_container

        compressed = compress_container(
            contents, tuple(algorithms), block_size, mesh=_resolve_mesh(devices),
            window=window if window is not None else DEFAULT_WINDOW_SIZE,
        )
    else:
        compressed = compress_bytes(contents, algorithms, backend, window=window)
    with open(output, "wb") as f:
        f.write(compressed)
    if not quiet:
        print(f"Original bytes: {len(contents)}")
        print(f"Compressed bytes: {len(compressed)}")
        ratio = len(compressed) / len(contents) * 100 if contents else float("inf")
        print(f"Compression ratio: {ratio:.2f}%")
    return compressed


def decompress_file(
    algorithms: list[str],
    path: str,
    output: str,
    quiet: bool = False,
    backend: str | None = None,
    devices: int | str | None = None,
) -> bytes:
    """Parity with engine.DecompressFile (engine.go:187)."""
    with open(path, "rb") as f:
        contents = f.read()
    if not quiet:
        print("Decompressing...")
    if contents[:4] == b"RSNB":
        from raisin_jax.parallel.blocks import decompress_container

        decompressed = decompress_container(contents, mesh=_resolve_mesh(devices))
    else:
        decompressed = decompress_bytes(contents, algorithms, backend)
    with open(output, "wb") as f:
        f.write(decompressed)
    return decompressed


def compress_files(algorithms: list[str], files: list[str], extension: str, **kw) -> None:
    """Parity with engine.CompressFiles (engine.go:150)."""
    for path in files:
        compress_file(algorithms, path, path + extension, **kw)


def decompress_files(algorithms: list[str], files: list[str], extension: str, **kw) -> None:
    """Parity with engine.DecompressFiles (engine.go:175)."""
    for path in files:
        if extension.strip():
            out = path + extension
        else:
            out = os.path.splitext(path)[0]
        decompress_file(algorithms, path, out, **kw)
