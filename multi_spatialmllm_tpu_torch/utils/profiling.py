"""Profiling: program spans, the store they write, and device traces.

A span (`with span(name):`) marks a region where the port does one kind
of work. It records only while a `torch.profiler` session is active (the
CLI's `--trace-dir`, a traced benchmark run); otherwise it costs one flag
read and records nothing. While a session is on, a span opens a host-only
range of its name in the trace (a `cpu_op`, not a `user_annotation`, so
nothing is mirrored onto the device's timeline) and adds its host seconds
to `STORE`; a device span (`device=True`) also records a CUDA event on
the current stream at entry and at exit and adds the seconds between
them. A span reads nothing back from the device and changes no op or its
order. Ranges entered on a thread other than the profiler's are absent
from the trace; their seconds are in the store.

`device_trace` exports a Chrome trace over a block (the port's
counterpart of the JAX package's `jax.profiler` trace).
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Iterator

import torch
from torch.autograd import profiler as _profiler

_Range = torch._C._profiler._RecordFunctionFast


class Timings:
    """Span seconds by name, shared by every thread: per name the host
    seconds, the count and, for device spans, the device seconds.

    Each open span keeps its own start, so spans nest freely and each
    thread's nesting is its own. A device span's CUDA events are resolved
    without waiting: at each later device span, the oldest whose end event
    the device has passed, and the rest at `snapshot()`, which waits for
    them. Without CUDA a device span's device seconds are its host
    seconds."""

    def __init__(self):
        self._lock = threading.Lock()
        self._spans: dict[str, dict] = {}
        self._pending: collections.deque = collections.deque()

    def add(self, name: str, host_s: float, device=None) -> None:
        """One span of `name`: `device` None (a host span), device
        seconds, or its (start, end) CUDA events."""
        with self._lock:
            entry = self._spans.get(name)
            if entry is None:
                entry = self._spans[name] = {"host_s": 0.0, "count": 0}
            entry["host_s"] += host_s
            entry["count"] += 1
            if device is None:
                return
            entry.setdefault("device_s", 0.0)
            if isinstance(device, float):
                entry["device_s"] += device
                return
            self._pending.append((entry, *device))
            self._resolve(wait=False)

    def _resolve(self, wait: bool) -> None:
        while self._pending:
            entry, start, end = self._pending[0]
            if wait:
                end.synchronize()
            elif not end.query():
                return
            entry["device_s"] += start.elapsed_time(end) * 1e-3
            self._pending.popleft()

    def snapshot(self) -> dict[str, dict]:
        """`{name: {"host_s", "count"[, "device_s"]}}` of every span since
        the last `reset()`, waiting for the device spans' events."""
        with self._lock:
            self._resolve(wait=True)
            return {name: dict(e) for name, e in self._spans.items()}

    def reset(self) -> None:
        with self._lock:
            self._spans.clear()
            self._pending.clear()


STORE = Timings()
snapshot = STORE.snapshot
reset = STORE.reset


def _event():
    """A timing CUDA event recorded on the current stream, or None where
    CUDA is not in use."""
    if not torch.cuda.is_initialized():
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class _Span:
    __slots__ = ("name", "device", "_range", "_start", "_t0")

    def __init__(self, name: str, device: bool):
        self.name, self.device = name, device

    def __enter__(self):
        self._range = _Range(self.name)
        self._range.__enter__()
        self._start = _event() if self.device else None
        self._t0 = time.perf_counter()

    def __exit__(self, *exc):
        host_s = time.perf_counter() - self._t0
        device = None
        if self.device:
            device = host_s if self._start is None else (self._start,
                                                         _event())
        self._range.__exit__(*exc)
        STORE.add(self.name, host_s, device)
        return False


_OFF = contextlib.nullcontext()


def span(name: str, device: bool = False):
    """A context manager that records the block as span `name` while a
    torch.profiler session is active, and does nothing otherwise."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, device)


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
