"""Quick e2e container bench at several input sizes / block sizes."""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench import make_corpus


def main():
    import jax

    from raisin_jax.parallel.blocks import compress_container, decompress_container

    print("backend:", jax.default_backend(), flush=True)
    sizes = [int(s) for s in os.environ.get("MB", "4,32").split(",")]
    configs = [
        tuple(int(v) for v in c.split(":"))
        for c in os.environ.get("CFG", "4096:4096").split(",")
    ]
    iters = int(os.environ.get("ITERS", "3"))
    for bs, win in configs:
        for mb in sizes:
            data = make_corpus(mb << 20)
            t0 = time.perf_counter()
            c = compress_container(data, ("lzss", "arithmetic"), block_size=bs, window=win)
            warm = time.perf_counter() - t0
            out = decompress_container(c)
            assert out == data, "roundtrip failed"
            enc = min(
                _t(lambda: compress_container(data, ("lzss", "arithmetic"), block_size=bs, window=win))
                for _ in range(iters)
            )
            dec = min(_t(lambda: decompress_container(c)) for _ in range(iters))
            n = len(data)
            print(
                f"bs={bs:6d} win={win:5d} mb={mb:3d}: enc {enc:7.3f}s ({n/enc/1e6:6.2f} MB/s) "
                f"dec {dec:7.3f}s ({n/dec/1e6:6.2f} MB/s) ratio {len(c)/n*100:5.2f}% "
                f"warm {warm:.1f}s",
                flush=True,
            )


def _t(fn):
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


if __name__ == "__main__":
    main()
