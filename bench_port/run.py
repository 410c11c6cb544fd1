"""The benchmark of `multi_spatialmllm_tpu_torch` on NVIDIA cards.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

One run is one process: it makes its inputs and weights from the seed,
sets up, warms the cell's own shapes, measures for `--seconds`, checks
what the timed path produced against the plain reference, and prints one
JSON line last on standard output:

    {"correct", "attempted", "failed", "metrics", "device"[, "breakdown"],
     "checks"}

With `--trace 0` the metrics are the cell's end-to-end ones (BENCHMARK.json),
with `--trace 1` its per-layer ones, read from a device trace of the
window, the program's counters and the benchmark's spans. It exits
non-zero without a result when no card is there, when the card count is
below the cell's, or when JAX or the JAX package got loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from bench_port import harness as H  # noqa: E402


class Context:
    """What a traffic driver gets: the cell, the seed, the run length, the
    spans, and the slots it fills for the metric readers."""

    def __init__(self, cell: str, spec: dict, seed: int, seconds: float,
                 trace: bool, device, t_start: float, overrides=None):
        from bench_port import model

        overrides = overrides or {}     # tests: a small model and run
        self.cell, self.seed = cell, seed
        self.spec = {**spec, "params": {**spec["params"],
                                        **overrides.get("params", {})}}
        self.seconds, self.trace, self.device = seconds, trace, device
        self.t_start = t_start
        self.cfg = model.load_config(spec["config"])
        for key, patch in overrides.get("config", {}).items():
            self.cfg[key] = ({**self.cfg[key], **patch}
                             if isinstance(patch, dict) else patch)
        self.dims = model.dims(self.cfg)
        self.spans = H.Spans()
        self.counters: dict = {}          # the program's and the window's
        self.trace_summary: dict | None = None
        self.peaks = None
        self.setup_s = None
        self.memory_peak = 0


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device,
             t_start: float | None = None, overrides=None) -> dict:
    """One run of `cell` on `device` -> the result dict (the line)."""
    import torch

    from bench_port.flops import PEAKS

    spec = H.load_json(H.HERE, "workloads", f"{cell}.json")
    bench = H.benchmark()
    e2e_names, layer_names = H.cell_metrics(bench, cell)
    ctx = Context(cell, spec, seed, seconds, trace, torch.device(device),
                  T_START if t_start is None else t_start, overrides)
    if ctx.device.type == "cuda":
        ctx.peaks = PEAKS.get(torch.cuda.get_device_name(ctx.device))
    driver = H.load_module("traffic", spec["driver"])
    out = driver.run(ctx)
    result = {"correct": out["check"].correct,
              "attempted": out["attempted"], "failed": out["failed"]}
    if trace:
        metrics = {}
        units = {m["name"]: m["unit"] for m in bench["per_layer"]}
        for name in layer_names:
            value = H.load_module("metrics", name).read(ctx)
            if value is not None:
                metrics[name] = {"value": value, "unit": units[name]}
    else:
        units = {m["name"]: m["unit"] for m in bench["end_to_end"]}
        metrics = {n: {"value": out["metrics"][n], "unit": units[n]}
                   for n in e2e_names if n in out["metrics"]}
    result["metrics"] = metrics
    dev = {"platform": "gpu" if ctx.device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(ctx.device)
                    if ctx.device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": ctx.memory_peak}
    if trace and ctx.trace_summary is not None:
        dev["busy_s"] = ctx.trace_summary["busy_s"]
        dev["window_s"] = ctx.trace_summary["window_s"]
        result["breakdown"] = H.breakdown(ctx.trace_summary)
    result["device"] = dev
    result["checks"] = out["check"].as_dict()
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    spec = H.load_json(H.HERE, "workloads", f"{args.workload}.json")
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 3
    n = torch.cuda.device_count()
    if n < spec["chips"]:
        print(f"the cell needs {spec['chips']} cards, {n} present",
              file=sys.stderr)
        return 3
    info = H.card_info(torch, n)
    print(f"card: {info['kind']} x{info['count']}, power limit "
          f"{info['power_limit']}", file=sys.stderr, flush=True)
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda")
    bad = H.forbidden_modules()
    if bad:
        print(f"loaded in this process: {bad}; the benchmark measures the "
              f"port alone", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
