"""The readings the cells' limits are set from: the control and the faults.

    python3 bench_port/calibrate.py --workload <cell> --seeds S [S ...] \
        [--seconds 12]

Not part of a benchmark run. One JSON line a seed on standard output.

`internvl2_2b.sft` (the sft driver): per seed, the reference's first steps
in float32, then the same replay as the control (the reference in
bfloat16: weights, AdamW's moments and every product, the step below the
configuration's float32 master weights) and as the half-batch fault (the
reference in the program's place, each step over the first half of its
rows, the mean taken over them), each held to the float32 reference by
`checks.train_compare`. A state left unchanged reads 1 by that measure and
needs no run.

`internvl2_8b.spatial_qa` (the spatial_qa driver): per seed, the program
serves a short window through the benchmark's own path; then the same model
with its weights quantised to int8 (the program's `--quantize-weights`
path) reads each sampled request's prompt and served tokens in one
forward, and the token it puts first at each position is the control's; a
served token plus one is the altered-token fault. The reference's gap is
read for all three.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from bench_port import harness, mix, model  # noqa: E402
from bench_port.reference import checks  # noqa: E402


def train_seed(ctx) -> dict:
    import torch

    from bench_port import frames

    p = ctx.spec["params"]
    bank = mix.load_bank(p["bank"])
    tok = mix.tokenizer(bank)
    n = p["check_steps"]
    out = {}
    with tempfile.TemporaryDirectory() as root:
        names = frames.write_pool(root, ctx.seed, p["frame_pool"])
        t = time.perf_counter()
        ref = checks.train_readings(ctx, bank, tok, root, names, n)
        out["reference_s"] = time.perf_counter() - t
        ctrl = checks.train_readings(ctx, bank, tok, root, names, n,
                                     dtype=torch.bfloat16)
        out["control"] = checks.train_compare(ctrl, ref)
        rows = checks.reference_rows(ctx, bank, tok, root, names,
                                     n * p["batch"])
        half = [r for s in range(n) for r in
                rows[s * p["batch"]:s * p["batch"] + p["batch"] // 2]]
        w = model.draw_weights(model.weight_spec(ctx.cfg), ctx.seed,
                               ctx.device, torch.float32)
        for v in w.values():
            v.requires_grad_(True)
        losses, grad1 = checks.replay(w, ctx.dims, half, ctx.cfg["train"],
                                      p["batch"] // 2, n, tok.img_context_id)
        out["half_batch"] = checks.train_compare(
            {"losses": losses, "grad": grad1,
             "change": checks.changes(w, ctx.cfg, ctx.seed)}, ref)
        out["reference_losses"] = ref["losses"]
    for k in ("control", "half_batch"):
        out[k].pop("left_out")
    return out


def serve_seed(ctx) -> dict:
    import numpy as np
    import torch

    from multi_spatialmllm_tpu_torch.models.quantize import quantize_model

    traffic = harness.load_module("traffic", "spatial_qa")
    with tempfile.TemporaryDirectory() as root:
        s = traffic.Served(ctx, root)
        s.warm_up()
        loop, *_ = s.window(ctx.seconds, False)
        ids = checks.sample_requests(ctx, loop,
                                     ctx.spec["params"]["check_requests"])
        del s.batcher
        gc.collect()
        quantize_model(s.net)
        control = {}
        with torch.no_grad():
            for r in ids:
                req = s.build(json.loads(traffic.request_line(loop.recs[r])))
                seq = np.concatenate([req[0], np.asarray(loop.tokens[r],
                                                         np.int32)])
                logits, _ = s.net.prefill(
                    torch.as_tensor(seq[None], dtype=torch.long,
                                    device=ctx.device),
                    torch.as_tensor(req[1][None], device=ctx.device))
                control[r] = logits[0, len(req[0]) - 1:-1].argmax(-1).tolist()
        bank, tok = s.bank, s.tok
        del s
        gc.collect()
        torch.cuda.empty_cache()
        logits = checks.reference_logits(ctx, tok, root,
                                         [loop.recs[r] for r in ids],
                                         loop.tokens)
        vocab = ctx.dims["vocab"]
        read = {
            "served": [g for r in ids
                       for g in checks.gaps(logits[r], loop.tokens[r])],
            "control": [g for r in ids
                        for g in checks.gaps(logits[r], control[r])],
            "altered": [g for r in ids for g in checks.gaps(
                logits[r], [(t + 1) % vocab for t in loop.tokens[r]])]}
    return {k: checks.gap_stats(v) for k, v in read.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=12.0)
    args = ap.parse_args()

    import torch

    from bench_port.run import Context

    if not torch.cuda.is_available():
        print("needs the card", file=sys.stderr)
        return 3
    spec = harness.load_json(harness.HERE, "workloads",
                             f"{args.workload}.json")
    for seed in args.seeds:
        ctx = Context(args.workload, spec, seed, args.seconds, False,
                      torch.device("cuda"), time.perf_counter())
        t = time.perf_counter()
        got = (train_seed if spec["driver"] == "sft" else serve_seed)(ctx)
        print(json.dumps({"seed": seed, "s": time.perf_counter() - t,
                          **got}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
