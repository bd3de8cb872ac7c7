"""Timing and profiling kit.

The reference instruments with ad-hoc ``std::chrono`` prints around each
stage (`broad-phase-fused.cu:327-335`, `full-integration-test.cu:679-693`)
and a checked-in Nsight Compute command (`rai_build.yml:43`). Device-side
equivalents:

  * ``StageTimer`` — wall-clock stage timing with ``block_until_ready``
    fencing (async dispatch makes naive timing meaningless).
  * ``trace`` — context manager around ``jax.profiler`` emitting an xprof
    trace directory for Perfetto/XProf (the Nsight replacement).
  * ``benchmark`` — min-of-N protocol matching the reference report's
    methodology (§4.2: minimum of 5 runs, transfers included).
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import jax


class StageTimer:
    """Accumulates wall-clock time per named stage."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                jax.block_until_ready(block_on)
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t = self.totals[name]
            n = self.counts[name]
            lines.append(f"{name}: {t * 1e3:.2f} ms total, {n} calls, "
                         f"{t / n * 1e3:.3f} ms/call")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/robocheck_trace"):
    """Capture an xprof/Perfetto trace of the enclosed region."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def benchmark(fn, *args, runs: int = 5, warmup: int = 1) -> float:
    """Reference-protocol timing: best of ``runs`` after ``warmup`` calls;
    blocks on the result each run so device time is fully counted."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(runs):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best
