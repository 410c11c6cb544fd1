"""Traffic driver: supervised fine-tuning through the `train` command's loop.

The timed path is the port's: `__main__.train_steps` over
`prefetch_iterator(packed_batch_iterator(...))`, with
`parallel/train.make_train_step` and `AdamW` over every parameter, as
`train --packed` builds them. Set-up draws the weights, writes the frame
pool, and runs the first three steps through the same call and feed (they
warm every shape: all steps have one shape). The window then runs steps
until `--seconds` have passed. Afterwards the program is freed and the
reference replays the first three steps from the seed.

Cell parameters (`params` in the workload file): `bank`, `frame_pool`,
`seq_len`, `batch`, `row_tiles` (tiles a packed row holds), `prefetch`,
`check_steps`.
"""

from __future__ import annotations

import gc
import os
import sys
import tempfile
import time

import numpy as np

from bench_port import frames, harness, mix, model
from bench_port.flops import train_attn_flops, train_flops


class Feed:
    """The batch iterator handed to `train_steps`: waits on the program's
    prefetch queue under the `data_wait` span, counts what each step
    carries, and ends once the window's time is up (checked when the next
    batch is asked for, which is when the last step has finished)."""

    def __init__(self, batches, ctx, dims):
        self.it, self.ctx, self.d = batches, ctx, dims
        self.deadline = None
        self.rows = []                  # (segment lengths, real tiles)
        self.t_last = None
        self.step_s = []                # time between asks, a step each

    def __iter__(self):
        return self

    def __next__(self):
        now = time.perf_counter()
        if self.t_last is not None:
            self.step_s.append(now - self.t_last)
        self.t_last = now
        if self.deadline is not None and now >= self.deadline:
            raise StopIteration
        with self.ctx.spans("data_wait"):
            batch = next(self.it)
        segs, tiles = [], 0
        for seg_row in batch["segment_ids"]:
            ids, counts = np.unique(seg_row[seg_row > 0], return_counts=True)
            segs += counts.tolist()
        for ids_row in batch["input_ids"]:
            tiles += int((ids_row == self.d["img_id"]).sum()
                         // self.d["tokens_per_tile"])
        self.rows.append((segs, tiles))
        return batch


def run(ctx) -> dict:
    import torch

    from multi_spatialmllm_tpu_torch import __main__ as cli
    from multi_spatialmllm_tpu_torch.models import mllm as M
    from multi_spatialmllm_tpu_torch.models.data import (
        DataConfig,
        packed_batch_iterator,
        prefetch_iterator,
    )
    from multi_spatialmllm_tpu_torch.models.preprocess import PreprocessConfig
    from multi_spatialmllm_tpu_torch.parallel import train as T

    p, cfg, dev = ctx.spec["params"], ctx.cfg, ctx.device
    d = dict(ctx.dims)
    bank = mix.load_bank(p["bank"])
    tok = mix.tokenizer(bank)
    d["img_id"] = tok.img_context_id
    mcfg = model.mllm_config(cfg, "train", tok.img_context_id)
    tr = cfg["train"]
    with tempfile.TemporaryDirectory() as root:
        names = frames.write_pool(root, ctx.seed, p["frame_pool"])
        data_cfg = DataConfig(
            max_seq_len=p["seq_len"], max_tiles=p["row_tiles"],
            preprocess=PreprocessConfig(tile_size=d["image"],
                                        max_tiles=d["max_tiles"],
                                        resize_hw=None))
        batches = packed_batch_iterator(
            mix.records(bank, ctx.seed, names, stream=0), tok, mcfg,
            lambda rel: cli._read_image(os.path.join(root, rel)),
            p["batch"], data_cfg)
        feed = Feed(prefetch_iterator(batches, depth=p["prefetch"]), ctx, d)

        net = M.MultiFrameMLLM(mcfg, device=dev, param_dtype=torch.float32)
        model.load_into(net, cfg, ctx.seed)
        opt = T.AdamW(list(net.named_parameters()), T.TrainConfig(
            learning_rate=tr["learning_rate"],
            weight_decay=tr["weight_decay"], b1=tr["b1"], b2=tr["b2"],
            grad_clip=tr["grad_clip"], warmup_steps=tr["warmup_steps"],
            total_steps=tr["total_steps"]))
        program_step = T.make_train_step(net, opt, accum_steps=1)

        def step(batch):
            with ctx.spans("step"):
                return program_step(batch)
        n_check = p["check_steps"]
        seen = {}

        def after_step(n):
            with torch.no_grad():
                if n == 1:          # the clipped gradient, from AdamW's mu
                    seen["grad"] = {k: float(m.norm()) / (1 - tr["b1"])
                                    for k, m in zip(opt.names, opt.mu)}
                if n == n_check:
                    seen["change"] = change_norms(net, cfg, ctx.seed)

        def quiet(*_, **__):
            pass

        _, history = cli.train_steps(step, feed, n_check, dev,
                                     after_step=after_step, log=quiet)
        torch.cuda.synchronize(dev) if dev.type == "cuda" else None
        ctx.setup_s = time.perf_counter() - ctx.t_start
        losses = [h["loss"] for h in history]

        # the window
        n_setup = len(feed.rows)
        setup_wait = ctx.spans.seconds.get("data_wait", 0.0)
        tracer = harness.DeviceTrace().start() if ctx.trace else None
        t0 = time.perf_counter()
        feed.t_last, feed.step_s = None, []
        feed.deadline = t0 + ctx.seconds
        _, window = cli.train_steps(step, feed, 1 << 40, dev,
                                    start_step=n_check, log=quiet)
        window_s = feed.t_last - t0
        if tracer is not None:
            ctx.trace_summary = tracer.stop()
        if dev.type == "cuda":
            ctx.memory_peak = torch.cuda.max_memory_allocated(dev)
        rows = feed.rows[n_setup:n_setup + len(window)]
        tokens = sum(sum(s) for s, _ in rows)
        flops = sum(train_flops(d, s, t, tr["trained"]) for s, t in rows)
        attn = sum(train_attn_flops(d, s, t) for s, t in rows)
        ctx.counters.update(
            steps=len(window), window_s=window_s, tokens=tokens,
            flops=flops, attn_flops=attn,
            data_wait_s=ctx.spans.seconds["data_wait"] - setup_wait)
        feed.it.close()                 # stops the prefetch thread
        print(f"window: {len(window)} steps in {window_s:.3f} s, step s "
              f"{[round(x, 3) for x in feed.step_s]}, tiles a step "
              f"{[t for _, t in rows]}, data wait "
              f"{ctx.counters['data_wait_s']:.3f} s", file=sys.stderr)
        del step, program_step, opt, net, batches, feed
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        from bench_port.reference import checks

        check = checks.train(ctx, bank, tok, root, names, losses, seen,
                             n_check)
    return {"check": check, "attempted": len(window) + n_check,
            "failed": 0,
            "metrics": {"train_tokens_per_s": tokens / max(window_s, 1e-9),
                        "setup_s": ctx.setup_s}}


def change_norms(net, cfg: dict, seed: int) -> dict:
    """Each leaf's distance from its first draw, the draw made again."""
    import torch

    params = dict(net.named_parameters())
    out = {}

    def sink(name, t0):
        out[name] = float((params[name].detach() - t0).norm())

    model.draw_weights(model.weight_spec(cfg), seed,
                       next(iter(params.values())).device, torch.float32,
                       sink)
    return out
