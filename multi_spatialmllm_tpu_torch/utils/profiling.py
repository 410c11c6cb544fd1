"""Profiling helpers: wall-clock stage timers + optional device traces.

Replaces the reference's ad-hoc TimeCounter decoration (SURVEY.md §5.1)
with nestable timers and a `torch.profiler` trace context for inspecting
the device programs the stages run (the port's counterpart of the JAX
package's `jax.profiler` trace).
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator


class Timings:
    """Hierarchical named wall-clock timings."""

    def __init__(self):
        self.entries: list[tuple[str, float]] = []
        self._stack: list[str] = []

    @contextlib.contextmanager
    def section(self, name: str) -> Iterator[None]:
        self._stack.append(name)
        label = "/".join(self._stack)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.entries.append((label, time.perf_counter() - t0))
            self._stack.pop()

    def as_dict(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for label, dt in self.entries:
            out[label] = out.get(label, 0.0) + dt
        return out

    def report(self) -> str:
        return "\n".join(
            f"{label:48s} {dt:9.3f}s"
            for label, dt in sorted(self.as_dict().items()))


@contextlib.contextmanager
def device_trace(log_dir: str | None) -> Iterator[None]:
    """torch.profiler trace context over the CPU and, where present, CUDA
    activities; writes a Chrome trace (`trace_<pid>_<n>.json`, open it in
    Perfetto or chrome://tracing) under `log_dir` (no-op when log_dir is
    None)."""
    if log_dir is None:
        yield
        return
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    n = len([f for f in os.listdir(log_dir) if f.startswith("trace_")])
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{n}.json"))
