"""Traffic driver: MultiSPA questions through the `serve` command's loop.

The timed path is the port's: `__main__.serve_lines` (streaming, the
command's window of lines) over `models/paged_kv.PagedBatcher`, with the
command's request builder (`make_request_builder`: frame files read,
tiled, prompt ids built). The load is a closed loop of `clients`: each
sends its next JSONL line when its previous answer's `done` chunk
arrives; lines stop going out when the window closes, and the program
then serves what it holds. Set-up draws the weights, writes the frame
pool and serves a few warm-up requests of each frame count.

Metrics: `qa_answers_per_s`, the requests answered over the time from
the first send until the program has answered every line it read before
the close (the loop drains a window of lines before it reads the next, so
a count cut at the close would move in whole windows); and
`ttft_p<q>_ms`, the `ttft_quantile` q of the time from send to first
streamed token over every request sent before the close (one still
waiting at the close counts with its age).

Cell parameters: `bank`, `frame_pool`, `clients`, `budgets`, `slots`,
`page_size`, `max_prompt_len`, `max_new_tokens`, `window_lines`,
`ttft_quantile`, `warmup_requests`, `check_requests`.
"""

from __future__ import annotations

import collections
import gc
import json
import os
import sys
import tempfile
import time

from bench_port import frames, harness, mix, model
from bench_port.flops import (
    decode_flops,
    decode_kv_bytes,
    prefill_attn_flops,
    prefill_flops,
)


def request_line(rec: dict) -> str:
    return json.dumps({"id": rec["id"], "text": rec["conversations"][0][
        "value"], "image": rec["image"],
        "max_new_tokens": rec["max_new_tokens"]})


class Loop:
    """The closed loop of clients around `serve_lines`: the lines it
    reads, the `emit` it calls, and what each request saw."""

    def __init__(self, stream, deadline=None):
        self.stream, self.deadline = stream, deadline
        self.pending = collections.deque()
        self.recs, self.sent, self.first, self.done = {}, {}, {}, {}
        self.tokens = collections.defaultdict(list)
        self.errors = {}

    def send(self, now: float) -> None:
        rec = next(self.stream)
        self.recs[rec["id"]] = rec
        self.sent[rec["id"]] = now
        self.pending.append(request_line(rec))

    def lines(self):
        while self.pending and (self.deadline is None
                                or time.perf_counter() < self.deadline):
            yield self.pending.popleft()

    def more(self) -> bool:
        return bool(self.pending)

    def emit(self, obj: dict) -> None:
        now = time.perf_counter()
        rid = obj["id"]
        if "error" in obj:
            self.errors[rid] = obj["error"]
            finished = True
        else:
            new = obj["delta_ids"]
            if new:
                self.first.setdefault(rid, now)
                self.tokens[rid] += new
            finished = obj["done"]
        if finished:
            self.first.setdefault(rid, now)
            self.done[rid] = now
            if self.deadline is not None and now < self.deadline:
                self.send(now)


class Served:
    """The program as the serve command builds it, and the cell's inputs."""

    def __init__(self, ctx, root: str):
        from multi_spatialmllm_tpu_torch import __main__ as cli
        from multi_spatialmllm_tpu_torch.models import mllm as M
        from multi_spatialmllm_tpu_torch.models.paged_kv import (
            PagedBatcher,
            PagedConfig,
        )
        from multi_spatialmllm_tpu_torch.models.preprocess import (
            PreprocessConfig,
            tile_image,
        )

        p, cfg, d = ctx.spec["params"], ctx.cfg, ctx.dims
        self.ctx, self.p, self.root = ctx, p, root
        self.bank = mix.load_bank(p["bank"])
        self.tok = mix.tokenizer(self.bank)
        self.names = frames.write_pool(root, ctx.seed, p["frame_pool"])
        mcfg = model.mllm_config(cfg, "serve", self.tok.img_context_id)
        self.net = M.MultiFrameMLLM(mcfg, device=ctx.device)
        model.load_into(self.net, cfg, ctx.seed)
        self.net.eval()
        per_slot = -(-(p["max_prompt_len"] + p["max_new_tokens"])
                     // p["page_size"])
        self.batcher = PagedBatcher(
            self.net, PagedConfig(
                slots=p["slots"], page_size=p["page_size"],
                num_pages=p["slots"] * per_slot + 1,
                max_prompt_len=p["max_prompt_len"],
                max_new_tokens=p["max_new_tokens"],
                kv_dtype=cfg["serve"]["kv_dtype"]),
            pad_id=self.tok.pad_id, eos_id=self.tok.eos_id)
        pre = PreprocessConfig(tile_size=d["image"], max_tiles=d["max_tiles"],
                               resize_hw=None)
        self.build = cli.make_request_builder(
            mcfg, self.tok, self.batcher,
            lambda rel: tile_image(cli._read_image(os.path.join(root, rel)),
                                   pre))
        self.shapes = {}
        # the batcher's prefill and decode dispatches under spans of
        # their own, so the trace can say what the host was doing
        for name, span in (("_prefill_into", "prefill"),
                           ("_decode", "decode")):
            setattr(self.batcher, name,
                    self._spanned(getattr(self.batcher, name), span))

    def _spanned(self, fn, span):
        def call(*args, **kw):
            with self.ctx.spans(span):
                return fn(*args, **kw)
        return call

    def to_request(self, rec):
        with self.ctx.spans("window_prep"):
            req = self.build(rec)
        self.shapes[rec["id"]] = (len(req[0]), int(req[1].shape[0]))
        return req

    def serve(self, loop: Loop) -> None:
        from multi_spatialmllm_tpu_torch import __main__ as cli

        cli.serve_lines(self.batcher, loop.lines(), self.to_request, self.tok,
                        loop.emit, window=self.p["window_lines"], stream=True,
                        more_buffered=loop.more)

    def records(self, stream: int):
        return mix.records(self.bank, self.ctx.seed, self.names, stream,
                           budgets=self.p["budgets"])

    def warm_up(self) -> None:
        """Requests of the warm-up stream, every frame count."""
        warm = Loop(self.records(stream=1))
        for _ in range(self.p["warmup_requests"]):
            warm.send(0.0)
        self.serve(warm)

    def window(self, seconds: float, trace: bool):
        """The closed loop for `seconds`, then the program's drain ->
        (loop, first send, the close, batcher counters over it all)."""
        stats0 = dict(self.batcher.stats)
        tracer = harness.DeviceTrace().start() if trace else None
        t0 = time.perf_counter()
        loop = Loop(self.records(stream=0), deadline=t0 + seconds)
        for _ in range(self.p["clients"]):
            loop.send(t0)
        self.serve(loop)
        if tracer is not None:
            self.ctx.trace_summary = tracer.stop()
        return loop, t0, t0 + seconds, {
            k: self.batcher.stats[k] - stats0[k] for k in stats0}


def run(ctx) -> dict:
    import torch

    p, dev = ctx.spec["params"], ctx.device
    with tempfile.TemporaryDirectory() as root:
        s = Served(ctx, root)
        s.warm_up()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        ctx.setup_s = time.perf_counter() - ctx.t_start
        prep0 = (ctx.spans.seconds.get("window_prep", 0.0),
                 ctx.spans.counts.get("window_prep", 0))

        loop, t0, t_end, stats = s.window(ctx.seconds, ctx.trace)
        if dev.type == "cuda":
            ctx.memory_peak = torch.cuda.max_memory_allocated(dev)
        answered = [r for r in loop.done if r not in loop.errors]
        span = max(loop.done.values(), default=t_end) - t0
        ttft = [min(loop.first.get(r, t_end), t_end) - t
                for r, t in loop.sent.items()]
        counters = window_counters(ctx.dims, loop, s.shapes)
        counters.update(
            stats=stats, window_s=span, answers=len(answered),
            sent=len(loop.sent),
            prep_s=ctx.spans.seconds.get("window_prep", 0.0) - prep0[0],
            preps=ctx.spans.counts.get("window_prep", 0) - prep0[1])
        ctx.counters.update(counters)
        print(f"window: {len(answered)} answered in {span:.3f} s, "
              f"{sum(t <= t_end for t in loop.done.values())} by the close, "
              f"of {len(loop.sent)} sent; ttft s p50/p80/p90 "
              f"{[round(harness.quantile(ttft, q), 3) for q in (.5, .8, .9)]}"
              f", {stats['decode_dispatches']} decode dispatches "
              f"{stats['decode_seconds']:.3f} s, {stats['prefill_full']} "
              f"prefills {stats['prefill_seconds']:.3f} s, window prep "
              f"{counters['prep_s']:.3f} s", file=sys.stderr)
        handed = set(s.shapes) & set(loop.sent)
        unanswered = [r for r in handed if r not in loop.done]
        bank, tok = s.bank, s.tok
        del s
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        from bench_port.reference import checks

        check = checks.serve(ctx, bank, tok, root, loop)
        check.at_most("unanswered", len(unanswered), 0)
        check.at_most("errors", len(loop.errors), 0)
    return {"check": check, "attempted": len(loop.sent),
            "failed": len(loop.errors) + len(unanswered),
            "metrics": {
                "qa_answers_per_s": len(answered) / span,
                f"ttft_p{round(100 * p['ttft_quantile'])}_ms":
                    1e3 * harness.quantile(ttft, p["ttft_quantile"]),
                "setup_s": ctx.setup_s}}


def window_counters(d: dict, loop: Loop, shapes: dict) -> dict:
    """Required work of the served requests: prefill FLOPs (and their
    attention part), decode FLOPs and the paged-attention bytes of every
    decode step, and the FLOPs of both together (`window_flops`)."""
    out = collections.Counter()
    for rid, (plen, tiles) in shapes.items():
        if rid not in loop.first:
            continue
        out["prefill_flops"] += prefill_flops(d, plen, tiles)
        out["prefill_attn_flops"] += prefill_attn_flops(d, plen, tiles)
        out["prefills"] += 1
    for rid, toks in loop.tokens.items():
        plen = shapes[rid][0]
        for j in range(1, len(toks)):   # token 0 is the prefill's
            pos = plen + j - 1
            out["decode_flops"] += decode_flops(d, pos)
            out["decode_kv_bytes"] += decode_kv_bytes(d, pos)
            out["decode_tokens"] += 1
    out["window_flops"] = out["prefill_flops"] + out["decode_flops"]
    return dict(out)
