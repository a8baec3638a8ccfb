"""Timing and progress reporting.

Replaces the reference's chrono Timer (template/precomp.h:277-288) and the
per-iteration stdout line "Progress: X% photon count: N delta time: ... total
time: ..." (myapp.cpp:166-169). Also wraps jax.profiler for device traces —
in place of the reference's never-read CL_QUEUE_PROFILING_ENABLE queues
(template/template.cpp:1446-1449, SURVEY.md §5).
"""

from __future__ import annotations

import contextlib
import time


class Timer:
    """High-resolution elapsed-seconds timer (Timer, template/precomp.h:277)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._start = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self._start


class ProgressReporter:
    """Per-iteration progress in the reference's format."""

    def __init__(self, total_iterations: int, log=print):
        self.total = max(1, total_iterations)
        self.log = log
        self.timer = Timer()
        self.last = 0.0
        self.photons = 0

    def update(self, iteration: int, photons: int):
        now = self.timer.elapsed()
        delta = now - self.last
        self.last = now
        self.photons = photons
        pct = 100.0 * iteration / self.total
        self.log(
            f"Progress: {pct:.0f}% photon count: {photons} "
            f"delta time: {delta * 1e3:.0f}ms total time: {now * 1e3:.0f}ms "
            f"({photons / max(now, 1e-9) / 1e6:.2f} Mrays/s)"
        )


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a jax.profiler trace (view with TensorBoard/XProf)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
