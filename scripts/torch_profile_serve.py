#!/usr/bin/env python3
"""Where the port's serving time goes, on one GPU: torch.profiler over
one flagship prefill and one decode chunk of the PagedBatcher.

    python3 scripts/torch_profile_serve.py [--out DIR] [--moe]

Builds the `flagship` config with seeded random bf16 weights, warms up
with the smoke run's 16 requests, then profiles (a) the B=1 prefill +
page insert of a two-image request and (b) one decode chunk with all 8
slots live. With `--moe`: `chip_smoke.py` phase 14's routed-MoE model
(bench, 4 experts, ragged impl on K8) with int8 kv pools
(`bench_paged_config`), one-image requests, files suffixed `_moe`.

For each window it writes the top operators by device time and prints
the device-busy share of the window's host-clock time (the rest is the
device waiting on the host). Needs CUDA; fails without it.
"""

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def profile(torch, fn, label, out_dir, n_rows=30):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as prof

    torch.cuda.synchronize()
    with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = p.key_averages()
    # device-side rows only (kernels, memcpys): the operator rows above
    # them carry the same time again
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    table = events.table(sort_by="self_device_time_total", row_limit=n_rows)
    with open(os.path.join(out_dir, f"profile_{label}.txt"), "w") as f:
        f.write(table)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    print(f"[{label}] host wall {wall * 1e3:.3f} ms, device busy "
          f"{device_us / 1e3:.3f} ms ({100 * device_us / 1e6 / wall:.1f}% "
          f"of wall), {sum(e.count for e in kernels)} kernels")
    for e in top:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  "
              f"{e.count:6d}x  {e.key[:90]}")
    return {"wall_ms": wall * 1e3, "device_ms": device_us / 1e3,
            "kernels": [(e.key, e.self_device_time_total / 1e3, e.count)
                        for e in sorted(kernels, key=lambda e:
                                        -e.self_device_time_total)]}


def main():
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as smoke
    from multi_spatialmllm_tpu_torch import __main__ as cli
    from multi_spatialmllm_tpu_torch.models import mllm as M
    from multi_spatialmllm_tpu_torch.models import paged_kv as K

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out"))
    ap.add_argument("--moe", action="store_true",
                    help="the routed-MoE model with int8 kv pools")
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    suffix = "_moe" if args.moe else ""

    if args.moe:
        cfg = smoke.moe_config(cli)
        pcfg = K.bench_paged_config(kv_dtype="int8")
    else:
        cfg = M.flagship_config()
        pcfg = K.PagedConfig(slots=8, page_size=64, num_pages=256,
                             max_prompt_len=2048, max_new_tokens=32)
    model = M.MultiFrameMLLM(cfg, device="cuda")
    M.init_random_weights(model, smoke.SEED)
    model.eval()
    tok = smoke.serve_tokenizer()
    batcher = K.PagedBatcher(model, pcfg, pad_id=tok.pad_id,
                             eos_id=tok.eos_id)
    lines, tiles = smoke.serve_lines_for(cfg, smoke.N_SERVE, K,
                                         1 if args.moe else 2)
    to_request = cli.make_request_builder(cfg, tok, batcher, tiles.get)
    cli.serve_lines(batcher, lines, to_request, tok, lambda o: None)
    print(f"card: {smoke.card_name_and_power_limit()}")
    print(f"warm-up serve stats: {batcher.stats}")

    reqs = [to_request(json.loads(ln)) for ln in lines[:8]]
    two_image = reqs[1]      # one image with --moe
    results = {}

    def prefill():
        batcher._prefill_into(0, two_image[0], two_image[1])

    results["prefill"] = profile(torch, prefill, "prefill" + suffix,
                                 args.out)
    batcher._free_slot(0)
    for slot, (ids, t) in enumerate(reqs):
        batcher._prefill_into(slot, ids, t)
        batcher._extend_to(slot, int(batcher.positions[slot]) + pcfg.chunk)

    def decode():
        toks, _, _, _ = K.paged_decode_chunk(
            model, torch.as_tensor(batcher.last_token, device="cuda"),
            torch.as_tensor(batcher.positions, device="cuda"),
            batcher.pools,
            torch.as_tensor(batcher.page_table, device="cuda"), pcfg.chunk)
        toks.cpu()

    results["decode_chunk"] = profile(torch, decode, "decode_chunk" + suffix,
                                      args.out)
    with open(os.path.join(args.out, f"profile_summary{suffix}.json"),
              "w") as f:
        json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
