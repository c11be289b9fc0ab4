"""Profiling / tracing utilities (auxiliary-subsystem parity).

The reference's observability is wall-clock timing of Track() + an fps.txt
series (reference: src/kittirunner.cpp:145-160, src/selflocalization.cpp:
101-110).  Here the same numbers come from :class:`StageTimer`, and device-
level traces come from ``jax.profiler`` (viewable in TensorBoard/XProf) —
the device-level upgrade of "install gdb+valgrind and never call them"
(reference: Dockerfile.amd64:30-31).
"""

from __future__ import annotations

import contextlib
import statistics
import time
from collections import defaultdict

import jax


class StageTimer:
    """Accumulates wall-clock per named pipeline stage."""

    def __init__(self):
        self.samples: dict[str, list[float]] = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str, sync_value=None):
        t0 = time.time()
        yield
        if sync_value is not None:
            jax.block_until_ready(sync_value)
        self.samples[name].append(time.time() - t0)

    def summary(self) -> dict[str, dict[str, float]]:
        out = {}
        for name, xs in self.samples.items():
            out[name] = {
                "n": len(xs),
                "mean_ms": 1e3 * sum(xs) / len(xs),
                "median_ms": 1e3 * statistics.median(xs),
                "max_ms": 1e3 * max(xs),
            }
        return out

    def report(self) -> str:
        lines = []
        for name, s in sorted(self.summary().items()):
            lines.append(
                f"{name:30s} n={s['n']:4d} mean={s['mean_ms']:8.2f}ms "
                f"median={s['median_ms']:8.2f}ms max={s['max_ms']:8.2f}ms"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a jax.profiler trace for TensorBoard/XProf."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
