"""What a fresh process pays on the card before its first step: seconds of
each first call, in order, synchronised (importing torch, the CUDA context,
a first bf16 matmul, a first convolution at the ViT's patch embedding, the
flash kernels' first forward and backward through the port's op), then
the same calls again. Run once alone and then as `--procs` processes at
once, as the smoke's gloo worlds start theirs.

    python3 scripts/torch_first_call_probe.py [--procs 4]

Needs the kernels built (any `chip_smoke.py` run builds them first).
Prints one JSON line: {"alone": {...}, "together": [{...}, ...]}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

T0 = time.perf_counter()
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def probe() -> dict:
    import torch

    out = {"import_torch": time.perf_counter() - T0}
    sys.path.insert(0, REPO)
    from multi_spatialmllm_tpu_torch.ops import attention as A

    def timed(name, fn, settle=True):
        if settle:
            torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out[name] = time.perf_counter() - t

    dev = torch.device("cuda")
    timed("context", lambda: torch.zeros(1, device=dev), settle=False)
    a = torch.randn(1024, 1024, device=dev, dtype=torch.bfloat16)
    tiles = torch.randn(8, 3, 448, 448, device=dev, dtype=torch.bfloat16)
    w = torch.randn(1024, 3, 14, 14, device=dev, dtype=torch.bfloat16)
    q = torch.randn(1, 16, 1025, 64, device=dev, dtype=torch.bfloat16,
                    requires_grad=True)

    def attention():
        return A.trainable_flash_attention(q, q, q, True)

    for rnd in ("first", "second"):
        timed(f"{rnd}_matmul", lambda: a @ a)
        timed(f"{rnd}_conv", lambda: torch.nn.functional.conv2d(
            tiles, w, stride=14))
        timed(f"{rnd}_flash_fwd", attention)
        timed(f"{rnd}_flash_bwd", lambda: attention().sum().backward())
    out = {k: round(v, 4) for k, v in out.items()}
    out["module_loading"] = os.environ.get("CUDA_MODULE_LOADING")
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, default=4)
    ap.add_argument("--child", action="store_true")
    args = ap.parse_args()
    if args.child:
        print(json.dumps(probe()), flush=True)
        return
    cmd = [sys.executable, os.path.abspath(__file__), "--child"]
    alone = json.loads(subprocess.run(cmd, capture_output=True, text=True,
                                      check=True).stdout.splitlines()[-1])
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True)
             for _ in range(args.procs)]
    together = [json.loads(p.communicate()[0].splitlines()[-1])
                for p in procs]
    print(json.dumps({"alone": alone, "together": together}), flush=True)


if __name__ == "__main__":
    main()
