"""Tracing / profiling utilities.

The reference's observability story is VCD waveform dumps + free-running
cycle counters (TOTAL_CYCLES, CompressionAccelerator.scala:36-38; busyCycles,
ScratchpadTest.scala:44-50; Treadle VCD, TestUtils.scala:16-18). The
device equivalents here:

  * `trace(path)`    — jax.profiler trace context (the waveform dump: view
                       in TensorBoard / Perfetto for per-op device timing).
  * `Timer`          — wall-clock stage timer that waits for the device
                       at section end (the cycle counter).
  * `device_bench()` — best-of-trials seconds per call, each trial ending
                       in jax.block_until_ready.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import jax


@contextlib.contextmanager
def trace(path: str):
    """jax.profiler trace context; open the result in TensorBoard/Perfetto."""
    jax.profiler.start_trace(path)
    try:
        yield path
    finally:
        jax.profiler.stop_trace()


@dataclasses.dataclass
class Timer:
    """Named wall-clock sections; a section given `result` waits for it."""
    sections: dict = dataclasses.field(default_factory=dict)

    @contextlib.contextmanager
    def section(self, name: str, result=None):
        t0 = time.perf_counter_ns()
        yield
        if result is not None:
            jax.block_until_ready(result)
        self.sections[name] = self.sections.get(name, 0) + \
            time.perf_counter_ns() - t0

    def report(self) -> str:
        total = sum(self.sections.values())
        lines = [f"{k:24s} {v/1e6:9.2f} ms ({100*v/max(1,total):4.1f}%)"
                 for k, v in self.sections.items()]
        return "\n".join(lines)


def device_bench(fn, *args, iters: int = 30, trials: int = 3) -> float:
    """Best-of-trials seconds per call: one warm-up call (compilation),
    then `iters` dispatches per trial, timed to block_until_ready on the
    last output (the device queue runs them in order)."""
    jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(trials):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        jax.block_until_ready(out)
        best = min(best, (time.perf_counter() - t0) / iters)
    return best
