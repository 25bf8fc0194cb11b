"""Worker process for the 2-process jax.distributed container test.

Launched by tests/test_multihost.py (and usable standalone for manual
multi-host experiments):

    python scripts/multihost_worker.py <pid> <nprocs> <port> <outdir>

Each process: initializes jax.distributed against the localhost
coordinator, builds the global ('data', 'model') mesh spanning both
processes' virtual CPU devices, proves the DCN collective path with a
psum across the global 'data' axis, then container-encodes its
process_block_range of the input locally and writes its ordered segment
(payloads + token lengths) for the parent to reassemble.
"""

from __future__ import annotations

import os
import pickle
import sys


def main() -> None:
    pid, n, port, outdir = (
        int(sys.argv[1]),
        int(sys.argv[2]),
        sys.argv[3],
        sys.argv[4],
    )
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=4"
    )
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from raisin_jax.parallel import blocks as blk
    from raisin_jax.parallel import multihost

    multihost.initialize(f"localhost:{port}", n, pid)
    assert jax.process_count() == n, jax.process_count()
    assert jax.device_count() == 4 * n
    mesh = multihost.global_data_mesh(model_axis=1)
    assert mesh.shape["data"] == 4 * n

    # collective proof: psum over the host-spanning 'data' axis
    @jax.jit
    def allsum(x):
        return jax.shard_map(
            lambda v: jax.lax.psum(v, "data"),
            mesh=mesh,
            in_specs=P("data"),
            out_specs=P(),
        )(x)

    per = jax.process_count() * 4
    xs = jax.make_array_from_process_local_data(
        jax.sharding.NamedSharding(mesh, P("data")),
        __import__("numpy").arange(4, dtype="float32") + 10 * pid,
        (per,),
    )
    total = float(allsum(xs)[()] if allsum(xs).ndim == 0 else allsum(xs)[0])

    # container encode of this process's block range
    from bench import make_corpus

    data = make_corpus(1 << 18)
    bs = 8192
    nblocks = -(-len(data) // bs)
    lo, hi = multihost.process_block_range(nblocks)
    print(f"[worker {pid}] owns blocks [{lo}, {hi}) of {nblocks}", flush=True)
    myblocks = [data[i * bs : (i + 1) * bs] for i in range(lo, hi)]
    payloads, toks = blk._encode_lzss_arithmetic_batch(myblocks, None, window=2048)

    with open(os.path.join(outdir, f"seg{pid}.pkl"), "wb") as f:
        pickle.dump(
            {
                "range": (lo, hi),
                "payloads": payloads,
                "toks": toks,
                "psum": total,
                "nblocks": nblocks,
                "block_size": bs,
                "orig_size": len(data),
            },
            f,
        )
    print(f"[worker {pid}] done", flush=True)


if __name__ == "__main__":
    main()
