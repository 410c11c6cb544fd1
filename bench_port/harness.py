"""What every cell shares: the card checks, spans, the device trace and
its reduction, the result line, and the files found by name.

A cell is `workloads/<cell>.json`; its `config` names
`configs/<config>.json`, its `driver` names `traffic/<driver>.py` (a
module with `run(ctx) -> dict`), and the per-layer metrics are
`metrics/<metric>.py` readers (`read(ctx) -> float | None`). A metric's
unit, layer, source and `moves`, and the cells that report it, are
BENCHMARK.json's alone.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "multi_spatialmllm_tpu"})

# kernel-name markers of library matrix products (cuBLAS, cuBLASLt,
# CUTLASS, cuDNN's implicit GEMMs)
GEMM_MARKERS = ("gemm", "nvjet", "cutlass", "xmma", "cublas")
# the port's own kernels (ops/csrc)
PORT_MARKERS = ("flash_fwd", "flash_bwd", "paged_decode", "gmm_")


class BenchError(RuntimeError):
    """A run that cannot give a result (no card, a missing file)."""


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """`<kind>/<name>.py` under the benchmark's folder, as a module."""
    path = os.path.join(HERE, kind, f"{name}.py")
    if not os.path.isfile(path):
        raise BenchError(f"no {kind} file {path}")
    spec = importlib.util.spec_from_file_location(
        f"bench_port_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> dict:
    return load_json(ROOT, "BENCHMARK.json")


def cell_metrics(bench: dict, cell: str):
    """(end-to-end names, per-layer names) that `cell` reports: each
    metric of BENCHMARK.json that lists the cell under `workloads`, or
    has no `workloads` (an end-to-end metric of every cell; a per-layer
    one of every cell that reports the metric it `moves`)."""
    e2e = [m["name"] for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    per_layer = [m["name"] for m in bench["per_layer"]
                 if (cell in m["workloads"] if "workloads" in m
                     else m["moves"] in e2e)]
    return e2e, per_layer


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & FORBIDDEN)


def card_info(torch, n: int) -> dict:
    """The card's name, count and power limit (nvidia-smi)."""
    info = {"kind": torch.cuda.get_device_name(0), "count": n}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
        info["power_limit"] = out[0].split(",")[-1].strip() if out else "?"
    except (OSError, subprocess.SubprocessError):
        info["power_limit"] = "not read"
    return info


class Spans:
    """Host-clock spans of the benchmark's own calls into each layer:
    seconds and counts by name, each also a `record_function` range so
    the device trace can say what the host was doing."""

    def __init__(self):
        self.seconds: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        from torch.profiler import record_function

        t0 = time.perf_counter()
        with record_function(f"bench.{name}"):
            try:
                yield
            finally:
                self.seconds[name] = (self.seconds.get(name, 0.0)
                                      + time.perf_counter() - t0)
                self.counts[name] = self.counts.get(name, 0) + 1


class DeviceTrace:
    """torch.profiler over the window; `stop()` reduces the raw
    events (no per-event Python objects beyond one pass): device busy
    seconds (the union of kernel, copy and set intervals), device time by
    kernel name, and the idle time by the innermost benchmark span the
    host was in."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])

    def start(self):
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def stop(self) -> dict:
        """Close the window (after the card has finished its queued work;
        the profiler's own shutdown is outside it) and reduce."""
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        window_s = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)
        return {**reduce_events(self.prof.profiler.kineto_results),
                "window_s": window_s}


def reduce_events(results) -> dict:
    """Device busy seconds, device time by kernel name, and idle time by
    host span, from the profiler's raw events. The benchmark's ranges on
    the device's timeline (`bench.*`) are annotations, not work."""
    from torch.autograd import DeviceType

    dev, spans = [], []
    first = last = None
    for e in results.events():
        name, a, b = e.name(), e.start_ns(), e.end_ns()
        if e.device_type() == DeviceType.CUDA:
            if not name.startswith("bench."):
                dev.append((a, b, name))
        elif name.startswith("bench."):
            spans.append((a, b, name[6:]))
        first = a if first is None else min(first, a)
        last = b if last is None else max(last, b)
    by_name: dict[str, float] = {}
    for a, b, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-9
    dev.sort()
    # the idle stretches: before the first device event, between events,
    # after the last (bounded by the trace's first and last events)
    busy, gaps = 0, []
    cur_a = cur_b = None
    for a, b, _ in dev:
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                busy += cur_b - cur_a
            gaps.append((first if cur_b is None else cur_b, a))
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        busy += cur_b - cur_a
        gaps.append((cur_b, last))
    # label each idle gap by the innermost span around its midpoint: one
    # sweep, the spans by start, the open ones on a list (spans nest, so
    # the innermost is the latest open one)
    spans.sort()
    idle: dict[str, float] = {}
    open_, at = [], 0
    for a, b in sorted(gaps):
        if b <= a:
            continue
        mid = (a + b) // 2
        while at < len(spans) and spans[at][0] <= mid:
            open_.append(spans[at])
            at += 1
        open_ = [s for s in open_ if s[1] >= mid]
        label = open_[-1][2] if open_ else "outside any span"
        idle[label] = idle.get(label, 0.0) + (b - a) * 1e-9
    return {"busy_s": busy * 1e-9, "kernel_s": by_name,
            "n_device_events": len(dev), "idle_by_span": idle}


def kernel_seconds(trace: dict, patterns) -> float:
    return sum(s for n, s in trace["kernel_s"].items()
               if any(p in n for p in patterns))


def breakdown(trace: dict) -> dict:
    ops = sorted(trace["kernel_s"].items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(trace["idle_by_span"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:160], s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps]}


def quantile(values, q: float) -> float:
    """The q-quantile (0..1) by linear interpolation between order
    statistics."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    x = q * (len(v) - 1)
    i = int(x)
    return v[i] if i + 1 >= len(v) else v[i] + (x - i) * (v[i + 1] - v[i])


class Check:
    """The numbers `correct` is decided by: each with its limit."""

    def __init__(self):
        self.items: list[tuple[str, float, float]] = []

    def at_most(self, name: str, value: float, limit: float) -> None:
        self.items.append((name, float(value), float(limit)))

    @property
    def correct(self) -> bool:
        return bool(self.items) and all(v == v and v <= lim
                                        for _, v, lim in self.items)

    def as_dict(self) -> dict:
        return {n: {"value": v, "limit": lim} for n, v, lim in self.items}
