"""Multi-host scaling entry points.

The reference has no distributed layer; the device story (SURVEY §5
"distributed communication backend") is: initialize `jax.distributed`, build
one global mesh spanning all hosts, shard blocks along 'data' (the network
between hosts, NVLink within), keep the tensor-parallel 'model' axis intra-host, and
let XLA place the collectives. Per-host container segments make ordered
reassembly trivial: each host compacts its local blocks (see
parallel.blocks segmented compaction) and rank order concatenates.

Tests run it for real as two coordinated CPU processes
(tests/test_multihost.py); the mesh/collective logic it feeds is also
validated on virtual devices by __graft_entry__.dryrun_multichip.
"""

from __future__ import annotations

import jax


def initialize(coordinator_address: str | None = None, num_processes: int | None = None, process_id: int | None = None) -> None:
    """Wrapper over jax.distributed.initialize with env-based defaults."""
    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    jax.distributed.initialize(**kwargs)


def global_data_mesh(model_axis: int = 1):
    """Mesh over ALL devices of all hosts: ('data', 'model').

    The 'data' axis spans hosts (block parallelism crosses the network); keep
    model_axis <= devices-per-host so the match-search collectives stay on
    NVLink.
    """
    devices = jax.devices()
    n = len(devices)
    if n % model_axis != 0:
        raise ValueError(f"{n} devices not divisible by model_axis={model_axis}")
    local = jax.local_device_count()
    if model_axis > local:
        raise ValueError(
            f"model_axis={model_axis} would span hosts (local devices: {local})"
        )
    return jax.make_mesh((n // model_axis, model_axis), ("data", "model"), devices=devices)


def process_block_range(num_blocks: int) -> tuple[int, int]:
    """The contiguous block range this process owns under 'data' sharding."""
    per = -(-num_blocks // jax.process_count())
    lo = min(jax.process_index() * per, num_blocks)
    return lo, min(lo + per, num_blocks)
