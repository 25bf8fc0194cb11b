"""Profiling/tracing hooks (SURVEY §5 parity, done properly).

The reference's profiling is vestigial: a commented-out pkg/profile import
(cmd/cli.go:11), a progress bar, and MemStats prints. Here:

- :func:`trace` — context manager around ``jax.profiler.trace`` producing a
  TensorBoard-loadable trace directory (CLI: ``-profile[=DIR]``).
- :class:`StageTimer` — wall-clock per-stage breakdown used by the benchmark
  harness to separate device compute from host packing (honest
  speed-of-light accounting; SURVEY §7 hard-part 6).
"""

from __future__ import annotations

import contextlib
import time


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/raisin_jax_trace"):
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


class StageTimer:
    """Accumulates wall-clock per named stage.

    >>> t = StageTimer()
    >>> with t.stage("match"): ...
    >>> t.report()  # {'match': 0.12, ...}
    """

    def __init__(self) -> None:
        self.totals: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] = self.totals.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> dict[str, float]:
        return dict(sorted(self.totals.items(), key=lambda kv: -kv[1]))
