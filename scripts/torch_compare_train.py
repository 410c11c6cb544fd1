#!/usr/bin/env python3
"""Two checkouts of the port on one GPU, in the order A B B A (so that
drift within the call cancels): chip_smoke.py phase 13's MoE trainer,
phase 20's bench MoE LoRA, and the optimizer update of a train step.

    python3 scripts/torch_compare_train.py --a PARENT_ROOT --b ROOT \
        [--passes 4] [--parts train,update]

Each pass runs up to two processes from the checkout's root:

- chip_smoke.py's own `phase_train` on phase 13's model (`--config bench
  --moe-experts 4 --moe-impl ragged --moe-kernel pallas`, nothing cut:
  4 steps through the train CLI's `train_steps`) and its
  `lora_train_cli` on phase 20's bench MoE LoRA (5 steps through the
  train CLI): steps/s and tokens/s (the first step left out), peak GiB,
  launches a step;
- `AdamW.update` alone on phase 13's parameters, with random gradients
  scaled to a global norm of 0.5 (under the clip) and of 2.0 (over it):
  the median of UPDATE_REPS by CUDA events.

`--parts` picks among `train` and `update`. A step's phases at a cell's
shapes come from the benchmark's traced runs (`bench_port/run.py
--trace 1`: `optimizer_ms.train` and the other phase metrics).

Prints one JSON line a pass, then the card's name and power limit. Each
checkout builds its kernels into its own tree. Needs CUDA.
"""

import argparse
import json
import os
import subprocess
import sys

# runs in the checkout's root: its own chip_smoke.py and package
TRAIN = r"""
import json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as S
from multi_spatialmllm_tpu_torch import __main__ as cli
from multi_spatialmllm_tpu_torch.models import mllm as M
from multi_spatialmllm_tpu_torch.ops import attention as A
from multi_spatialmllm_tpu_torch.ops import grouped_matmul as G
from multi_spatialmllm_tpu_torch.parallel import train as T
flash = [A.FLASH_FWD, A.FLASH_BWD_DQ, A.FLASH_BWD_DKV]
gmm = [G.GMM, G.GMM_T, G.TGMM]
S.build_all(flash + gmm)
cfg = S.moe_config(cli)
launches, summary, peak = S.phase_train(
    torch, M, T, cli, S.serve_tokenizer(), flash + gmm, base=cfg,
    layers=None, max_tiles=S.MOE_MAX_TILES,
    tiles_per_image=S.MOE_TILES_PER_IMAGE)
steps = summary["steps"]
out = {"moe_train": dict(summary, peak_gib=peak, launches_per_step={
    k: v / steps for k, v in launches.items()})}
torch.cuda.empty_cache()
flags = ["--config", "bench", "--moe-experts", "4", "--moe-impl", "ragged",
         "--moe-kernel", "pallas"]
launches, summary, peak, _, _ = S.lora_train_cli(
    torch, cli, flash + gmm, "bench MoE LoRA (experts frozen)", flags, cfg,
    None, S.MOE_MAX_TILES, S.MOE_TILES_PER_IMAGE)
out["moe_lora_train"] = dict(summary, peak_gib=peak, launches_per_step={
    k: v / S.REPEAT_STEPS for k, v in launches.items()})
print("RESULT " + json.dumps(out), flush=True)
"""

# the optimizer update alone on phase 13's model (random gradients of the
# parameters' shapes, scaled to a global norm under and over the clip):
# device ms by CUDA events, the median of UPDATE_REPS
UPDATE = r"""
import json, statistics, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as S
from multi_spatialmllm_tpu_torch import __main__ as cli
from multi_spatialmllm_tpu_torch.models import mllm as M
from multi_spatialmllm_tpu_torch.parallel import train as T
dev = torch.device("cuda")
model = M.MultiFrameMLLM(S.moe_config(cli), device=dev,
                         param_dtype=torch.float32)
opt = T.AdamW(list(model.named_parameters()), T.TrainConfig())
gen = torch.Generator(device=dev).manual_seed(0)
grads = [torch.randn(p.shape, generator=gen, device=dev) for p in opt.params]
unit = torch.sqrt(sum(g.square().sum() for g in grads))
out = {"params": sum(p.numel() for p in opt.params)}
for label, norm in (("under_clip", 0.5), ("over_clip", 2.0)):
    times = []
    for _ in range(int(sys.argv[1])):
        g = [x * (norm / unit) for x in grads]
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        opt.update(g)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        del g
    out[label + "_ms"] = statistics.median(times)
    out[label + "_ms_all"] = times
print("RESULT " + json.dumps(out), flush=True)
"""
UPDATE_REPS = 5


def run(argv, root, timeout):
    proc = subprocess.run(argv, cwd=root, capture_output=True, text=True,
                          timeout=timeout)
    if proc.returncode != 0:
        sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
        raise SystemExit(f"{argv[:3]} failed in {root} "
                         f"(exit {proc.returncode})")
    return proc.stdout


def result_of(out):
    return json.loads(next(line[len("RESULT "):] for line in out.splitlines()
                           if line.startswith("RESULT ")))


def one_pass(label, root, parts):
    root = os.path.abspath(root)
    result = {}
    if "train" in parts:
        result.update(result_of(run([sys.executable, "-c", TRAIN], root,
                                    900)))
    if "update" in parts:
        result["update"] = result_of(run(
            [sys.executable, "-c", UPDATE, str(UPDATE_REPS)], root, 600))
    result["tree"], result["root"] = label, root
    print(json.dumps(result), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--a", required=True, help="the first checkout's root")
    ap.add_argument("--b", required=True, help="the second checkout's root")
    ap.add_argument("--passes", type=int, default=4,
                    help="passes in the order A B B A A B B A ...")
    ap.add_argument("--parts", default="train,update",
                    help="comma-separated: train (phases 13 and 20's MoE "
                         "trainers), update (the optimizer update alone)")
    args = ap.parse_args()
    parts = set(args.parts.split(","))
    order = "ABBA" * (args.passes // 4 + 1)
    for label in order[:args.passes]:
        one_pass(label, args.a if label == "A" else args.b, parts)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
