#!/usr/bin/env python3
"""Where the port's training time goes, on one GPU: one step of
`chip_smoke.py` phase 9's trainer (flagship widths, LLM cut to
`chip_smoke.TRAIN_LAYERS` layers, float32 master weights, bf16 compute,
packed 4096-token rows, batch 2 in 2 microbatches) under torch.profiler.

    python3 scripts/torch_profile_train.py --out DIR [--moe]

With `--moe` the trainer is `chip_smoke.py` phase 13's: the routed-MoE
model (bench, 4 experts, ragged impl on K8; nothing cut, the train CLI's
tile defaults), files suffixed `_moe`.

After one warm-up step it times a step with CUDA events around the
optimizer update (clip + AdamW over every parameter), then profiles a
third step: the device-busy share of its host-clock time, the top
kernels, and device time by kind (the flash forward K1, the flash
backward K2/K3, K8's grouped products, matrix products, everything
else). Writes the operator table under DIR. Needs CUDA.
"""

import argparse
import dataclasses
import itertools
import json
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

GEMM_MARKERS = ("gemm", "nvjet", "cutlass", "xmma", "cublas")


def kind_of(name: str) -> str:
    low = name.lower()
    if "flash_fwd" in low:
        return "flash forward (K1)"
    if "flash_bwd" in low:
        return "flash backward (K2/K3)"
    if "gmm_" in low:
        return "grouped matmul (K8)"
    if any(m in low for m in GEMM_MARKERS):
        return "matrix products"
    return "other"


def main():
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as smoke
    from torch_profile_serve import profile

    from multi_spatialmllm_tpu_torch import __main__ as cli
    from multi_spatialmllm_tpu_torch.models import mllm as M
    from multi_spatialmllm_tpu_torch.models.data import DataConfig
    from multi_spatialmllm_tpu_torch.models.mixture import (
        load_meta,
        mixture_batches,
    )
    from multi_spatialmllm_tpu_torch.models.preprocess import (
        PreprocessConfig,
    )
    from multi_spatialmllm_tpu_torch.parallel import train as T

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True,
                    help="directory for the operator table and summary")
    ap.add_argument("--moe", action="store_true",
                    help="the routed-MoE trainer of smoke phase 13")
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    print(f"card: {smoke.card_name_and_power_limit()}")
    suffix = "_moe" if args.moe else ""

    if args.moe:
        cfg = smoke.moe_config(cli)
        max_tiles = smoke.MOE_MAX_TILES
        tiles_per_image = smoke.MOE_TILES_PER_IMAGE
    else:
        base = M.flagship_config()
        cfg = dataclasses.replace(base, llm=dataclasses.replace(
            base.llm, num_layers=smoke.TRAIN_LAYERS))
        max_tiles = tiles_per_image = 6
    dev = torch.device("cuda")
    model = M.MultiFrameMLLM(cfg, device=dev, param_dtype=torch.float32)
    M.init_random_weights(model, smoke.SEED)
    opt = T.AdamW(list(model.named_parameters()), T.TrainConfig(
        learning_rate=1e-5, warmup_steps=2, total_steps=4))
    step = T.make_train_step(model, opt, accum_steps=2)

    update = opt.update
    update_ms = []

    def timed_update(grads):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        norm = update(grads)
        end.record()
        torch.cuda.synchronize()
        update_ms.append(start.elapsed_time(end))
        return norm

    with tempfile.TemporaryDirectory() as root:
        meta = smoke.write_mixture(root, smoke.serve_tokenizer(), 64,
                                   smoke.SEED + 9)
        data_cfg = DataConfig(max_seq_len=4096, max_tiles=max_tiles,
                              preprocess=PreprocessConfig(
                                  tile_size=cfg.vit.image_size,
                                  max_tiles=tiles_per_image,
                                  resize_hw=None))
        batches = list(itertools.islice(mixture_batches(
            load_meta(meta), smoke.serve_tokenizer(), cfg,
            smoke.synthetic_frame, 2, data_cfg, seed=smoke.SEED,
            packed=True), 3))
    on_dev = [{k: torch.from_numpy(v).to(
        dev, dtype=torch.long if v.dtype.kind in "iu" else None)
        for k, v in b.items()} for b in batches]

    step(on_dev[0])                       # warm-up
    torch.cuda.synchronize()
    opt.update = timed_update
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    step(on_dev[1])
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end)
    opt.update = update
    print(f"step {step_ms:.3f} ms (CUDA events), of which the optimizer "
          f"update (clip + AdamW, {sum(p.numel() for p in opt.params)} "
          f"params) {update_ms[0]:.3f} ms")

    result = profile(torch, lambda: step(on_dev[2]), "train_step" + suffix,
                     args.out)
    by_kind = {}
    for name, ms, _ in result["kernels"]:
        by_kind[kind_of(name)] = by_kind.get(kind_of(name), 0.0) + ms
    for k, ms in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        print(f"  {k}: {ms:.3f} ms "
              f"({100 * ms / result['device_ms']:.1f}% of device time)")
    result.update(step_ms=step_ms, update_ms=update_ms[0], by_kind=by_kind)
    with open(os.path.join(args.out, f"profile_train{suffix}.json"),
              "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
