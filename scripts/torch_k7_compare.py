#!/usr/bin/env python3
"""K7 (paged decode, native and int8 pools) timed at `chip_smoke.py`'s
shapes from one tree of the port, so that two trees compare in one call:

    python3 scripts/torch_k7_compare.py --root DIR [--root DIR2 ...]

Each root is a checkout holding `multi_spatialmllm_tpu_torch/`; it is
imported (and its kernels built) in a subprocess of its own. For each
root and shape (serve, long, skewed; phases 4 and 11's inputs, same seeds)
it prints the device ms from a CUDA graph's replay, the ms by CUDA events
around back-to-back wrapper calls, the wrapper's host us a call and the
bytes bound, as one JSON line a root, after the card's name and power
limit. No correctness check: phases 4 and 11 hold the kernels. Needs
CUDA; fails without it.
"""

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def measure(root):
    """Time K7 of the port under `root` (run in a subprocess)."""
    import importlib.util

    import torch

    # this tree's chip_smoke (its shapes and timers), the root's package
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    C = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(C)
    sys.path.insert(0, os.path.abspath(root))
    from multi_spatialmllm_tpu_torch.ops import paged_attention as P

    if not torch.cuda.is_available():
        raise SystemExit("torch_k7_compare: no CUDA device")
    if not P.__file__.startswith(os.path.abspath(root)):
        raise SystemExit(f"imported {P.__file__}, not from {root}")
    result = {"root": root}
    for quant in (False, True):
        shapes = C.k7_shapes(torch, P, quant)
        times = {}
        for label, args in shapes.items():
            times[label] = C.k7_times(torch, P, args)
            times[label]["bound_ms"] = C.k7_bound(args)[0][0]
        result["int8" if quant else "native"] = times
    print(json.dumps(result), flush=True)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", action="append", required=True)
    parser.add_argument("--child", action="store_true",
                        help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.child:
        measure(args.root[0])
        return 0
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    for root in args.root:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--child",
                        "--root", root], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
