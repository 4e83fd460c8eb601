"""Profiling: named spans + per-kernel wall timing + jax.profiler traces.

Capability parity with the reference's three mechanisms (SURVEY.md §5.1):
Timer wall spans (ref: core/profiler.h:36-48), named-frame Profiler
(ref: core/profiler.h:49-90 — whose print_stats was an empty stub; ours
prints), and the per-kernel GPU event profiler + stats table
(ref: kernel/cuda/launch.cpp:47-117). Here, per-op timing uses
block_until_ready around jitted callables, and deep traces use
jax.profiler.trace viewable in XProf/TensorBoard.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


class Profiler:
    """Named-span accumulator with a sorted report (ref print_kernel_stats)."""

    def __init__(self):
        self.stats = defaultdict(lambda: [0, 0.0, float("inf"), 0.0])

    @contextlib.contextmanager
    def frame(self, name):
        t0 = time.perf_counter()
        try:
            import jax

            with jax.named_scope(name):
                yield
        except ImportError:
            yield
        dt = time.perf_counter() - t0
        s = self.stats[name]
        s[0] += 1
        s[1] += dt
        s[2] = min(s[2], dt)
        s[3] = max(s[3], dt)

    def print_stats(self, stream=None):
        import sys

        stream = stream or sys.stderr
        rows = sorted(self.stats.items(), key=lambda kv: -kv[1][1])
        stream.write(
            f"{'span':<32}{'calls':>8}{'total(ms)':>12}{'min(ms)':>10}"
            f"{'max(ms)':>10}{'avg(ms)':>10}\n"
        )
        for name, (n, total, mn, mx) in rows:
            stream.write(
                f"{name:<32}{n:>8}{1e3 * total:>12.2f}{1e3 * mn:>10.3f}"
                f"{1e3 * mx:>10.3f}{1e3 * total / max(n, 1):>10.3f}\n"
            )


def kernel_timer(fn, *args, warmup=1, iters=5, **kwargs):
    """Time a jitted callable with block_until_ready (per-kernel analog of
    the reference's cudaEvent pairs). Returns seconds per call (min)."""
    import jax

    for _ in range(warmup):
        out = fn(*args, **kwargs)
        jax.block_until_ready(out)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        jax.block_until_ready(out)
        times.append(time.perf_counter() - t0)
    return min(times)


@contextlib.contextmanager
def trace(logdir="/tmp/akari-trace"):
    """jax.profiler trace context (view with XProf/TensorBoard)."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()
