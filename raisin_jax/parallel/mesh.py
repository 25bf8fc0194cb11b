"""Device-mesh helpers for the block-sharded scale path.

The reference has no distributed layer at all (its maximum concurrency is
one goroutine per algorithm, engine.go:243, and one per byte, lzss.go:119).
The device equivalent: blocks are sharded data-parallel along a 'data'
mesh axis; the LZSS match search can additionally shard its distance
dimension along a 'model' axis (tensor-parallel) — see
parallel.lzss_sharded. Collectives are placed by XLA (psum/pmax); nothing is
hand-written.
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def data_mesh(n_devices: int | None = None) -> Mesh:
    """1-D mesh over the first n devices: axis 'data' shards blocks."""
    devices = jax.devices()
    n = len(devices) if n_devices is None else n_devices
    return jax.make_mesh((n,), ("data",), devices=devices[:n])


def best_mesh(n_devices: int | None = None, model_axis: int = 1) -> Mesh:
    """2-D mesh ('data', 'model'): blocks × intra-codec parallelism."""
    devices = jax.devices()
    n = len(devices) if n_devices is None else n_devices
    if n % model_axis != 0:
        raise ValueError(f"n_devices={n} not divisible by model_axis={model_axis}")
    return jax.make_mesh((n // model_axis, model_axis), ("data", "model"), devices=devices[:n])


def block_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (block) dimension along 'data', replicate the rest."""
    return NamedSharding(mesh, P("data"))
