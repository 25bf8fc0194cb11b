"""Real 2-process jax.distributed exercise (SURVEY §5 distributed backend).

Launches two coordinator-connected CPU processes (4 virtual devices each),
each of which builds the global 8-device mesh, runs a psum across the
host-spanning 'data' axis, container-encodes its process_block_range
locally, and writes its ordered segment. The parent reassembles the
segments in rank order into one RSNB container and verifies a bit-exact
round trip against a single-process encode of the same data.
"""

from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "scripts", "multihost_worker.py")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_distributed_container(tmp_path):
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(pid), "2", str(port), str(tmp_path)],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-4000:]}"
        assert f"owns blocks" in out

    segs = []
    for pid in range(2):
        with open(tmp_path / f"seg{pid}.pkl", "rb") as f:
            segs.append(pickle.load(f))

    # both processes agreed on the psum across the global 'data' axis:
    # sum over 8 shards of (iota(4) + 10*pid) -> element 0 = 0+0+10+10 = 20
    assert segs[0]["psum"] == segs[1]["psum"]

    # disjoint, covering, ordered block ranges
    (lo0, hi0), (lo1, hi1) = segs[0]["range"], segs[1]["range"]
    nblocks = segs[0]["nblocks"]
    assert lo0 == 0 and hi0 == lo1 and hi1 == nblocks

    # rank-order reassembly == one container; bit-exact round trip
    from raisin_jax.parallel import blocks as blk
    from bench import make_corpus

    payloads = segs[0]["payloads"] + segs[1]["payloads"]
    toks = segs[0]["toks"] + segs[1]["toks"]
    container = blk.assemble_container(
        payloads, [toks], ("lzss", "arithmetic"),
        segs[0]["block_size"], 2048, segs[0]["orig_size"],
    )
    data = make_corpus(1 << 18)
    assert blk.decompress_container(container) == data

    # and the segments match what a single process produces
    single = blk.compress_container(
        data, ("lzss", "arithmetic"), block_size=segs[0]["block_size"], window=2048
    )
    assert container == single
