"""Command-line interface: `python -m multi_spatialmllm_tpu_torch <command>`.

Commands:

  demo      synthesize scenes and TAPVid records and run the data engine
            end to end: the ScanNet stages and engines, then object movement
  ingest-scannet  export raw ScanNet scans (mesh, segments, aggregation,
            meta) to the reference's instance-data layout + scenes_info.pkl
  ingest-sens  ScanNet `.sens` streams + scans -> scene packs
  pipeline  the ScanNet stages and engines over an existing scene store
  coverage  sharded, resumable object-coverage runs, and --merge
  tapvid    the object-movement engines over TAPVid-3D npz records
  eval      MultiSPA evaluation: checkpoint x eval JSONL -> scored report
  serve     JSONL serving loop (stdin -> stdout) over the paged batcher
  train     SFT on a data-mixture meta JSON (one device; full or LoRA) ->
            rolling torch checkpoints
  import-checkpoint  HF InternVL-2 safetensors -> the port's state dict
  export-checkpoint  the port's state dict or a train save -> HF
            InternVL-2 safetensors shard(s)

The data-engine commands write the trees of the JAX package's commands of
the same names, on `--device` (the card unless the caller asks for the
CPU), with no cv2 on their path; `serve` and `train` read JPEG and PNG
frames without cv2 too (ingest/image.py, models/resize.py), and so does
`eval`.
"""

from __future__ import annotations

import argparse
import glob
import itertools
import json
import os
import sys
import time
from typing import Callable, Iterable

import numpy as np


def log_event(kind: str, **fields) -> None:
    """One human-readable event line on stderr (`[train] kind k=v ...`)."""
    print(f"[train] {kind} " + " ".join(f"{k}={v}" for k, v in
                                        fields.items()), file=sys.stderr)


def _read_image(path: str) -> np.ndarray:
    """RGB uint8 `[H, W, 3]` of a JPEG or PNG file, chosen by its magic
    bytes: `cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)` without
    cv2. Any other format raises."""
    from .ingest.image import COLOR, imread
    from .utils.profiling import span

    with span("msm.image.read"):
        return np.ascontiguousarray(imread(path, COLOR)[..., ::-1])


def make_request_builder(cfg, tokenizer, batcher, tiles_for: Callable):
    """Request line dict -> request tuple for `PagedBatcher`.

    `tiles_for(path)` returns an image's normalized tiles `[n, H, W, 3]`
    (the CLI loads and tiles the file; an in-process caller may hand in
    tiles it made itself)."""
    from .models.runner import build_prompt_ids
    from .models.serving import SamplingParams

    def to_request(rec: dict):
        stacks = [tiles_for(p) for p in rec.get("image", [])]
        tiles = np.concatenate(stacks, axis=0) if stacks else np.zeros(
            (0, cfg.vit.image_size, cfg.vit.image_size, 3), np.float32)
        ids = build_prompt_ids(rec, tokenizer, cfg,
                               [s.shape[0] for s in stacks])
        req = [np.asarray(ids, dtype=np.int32), tiles]
        if any(k in rec for k in ("temperature", "top_p", "seed")):
            if not batcher.config.sampling:
                raise ValueError("pass --sampling to use sampling knobs")
            req.append(SamplingParams(
                temperature=float(rec.get("temperature", 0.0)),
                top_p=float(rec.get("top_p", 1.0)),
                seed=int(rec.get("seed", 0))))
        if "max_new_tokens" in rec:     # per-request budget (<= the cap)
            req.append(int(rec["max_new_tokens"]))
        out = tuple(req)
        batcher._unpack(out)            # front-load enqueue validation
        return out

    return to_request


def serve_lines(batcher, lines: Iterable[str], to_request: Callable,
                tokenizer, emit: Callable, window: int = 64,
                stream: bool = False,
                more_buffered: Callable[[], bool] = lambda: True,
                logprobs: bool = False) -> None:
    """Serve JSONL request lines through `batcher`, calling `emit(obj)`
    with each result object.

    Requests drain in windows of up to `window` lines: the first line of
    a window is awaited, later ones are taken while `more_buffered()`
    says another can be read without blocking. A bad line answers with
    {"id", "error"} and never stops the loop.

    Result:  {"id", "text", "token_ids"} per request, or with `stream`
             {"id", "delta_ids", "delta", "done"} chunks; with `logprobs`
             the final one also carries "logprobs" (rounded to 5 places)."""
    it = iter(lines)
    done = False
    n_line = 0
    while not done:
        win: list = []              # accepted (id, request-tuple) pairs
        while len(win) < window:
            if win and not more_buffered():
                break
            line = next(it, None)
            if line is None:
                done = True
                break
            if not line.strip():
                continue
            n_line += 1
            rid_name = f"line{n_line}"
            try:
                rec = json.loads(line)
                if isinstance(rec, dict) and "id" in rec:
                    rid_name = rec["id"]
                win.append((rid_name, to_request(rec)))
            except Exception as exc:  # answer the line, keep serving
                emit({"id": rid_name,
                      "error": f"{type(exc).__name__}: {exc}"})
        if not win:
            continue
        acc: dict[int, list[int]] = {i: [] for i in range(len(win))}
        texted: dict[int, str] = {i: "" for i in range(len(win))}
        for rid, toks, fin in batcher.generate_stream([r for _, r in win]):
            acc[rid].extend(toks)
            lp = batcher.request_logprobs.get(rid) \
                if logprobs and fin else None
            if stream and (toks or fin):
                # decode the CUMULATIVE ids and emit the text suffix:
                # per-chunk decode would split multi-byte characters
                full = tokenizer.decode(np.asarray(acc[rid], np.int32))
                delta, texted[rid] = full[len(texted[rid]):], full
                out = {"id": win[rid][0],
                       "delta_ids": [int(t) for t in toks],
                       "delta": delta, "done": fin}
            elif fin:
                ids = np.asarray(acc[rid], dtype=np.int32)
                out = {"id": win[rid][0],
                       "token_ids": [int(t) for t in ids],
                       "text": tokenizer.decode(ids)}
            else:
                continue
            if lp is not None:
                out["logprobs"] = [round(x, 5) for x in lp]
            emit(out)


def cmd_serve(args) -> None:
    """JSONL serving loop over the paged continuous batcher: one request
    per stdin line -> result lines on stdout.

    Request line:  {"id": ..., "text": "<image>\\n...", "image": [paths],
                    "max_new_tokens": n, "temperature": t, "top_p": p,
                    "seed": s}   (the knobs need --sampling; omitted or 0
                    temperature is greedy)
    Result line:   {"id": ..., "text": ..., "token_ids": [...]} or, with
                   --stream, {"id", "delta_ids", "delta", "done"} chunks;
                   with --logprobs the final one carries "logprobs".
    """
    from .models.paged_kv import PagedBatcher, PagedConfig
    from .models.preprocess import PreprocessConfig, tile_image
    from .models.tokenizer import load_tokenizer

    cfg = _config(args)
    model = _load_model(cfg, args)
    tok = load_tokenizer(args.tokenizer)
    pre = PreprocessConfig(tile_size=cfg.vit.image_size,
                           max_tiles=args.max_tiles, resize_hw=None)
    batcher = PagedBatcher(
        model,
        PagedConfig(slots=args.slots, page_size=args.page_size,
                    num_pages=args.num_pages,
                    max_prompt_len=args.max_prompt_len,
                    max_new_tokens=args.max_new_tokens,
                    kv_dtype=args.kv_dtype,
                    prefix_cache=args.prefix_cache,
                    prefill_chunk=args.prefill_chunk,
                    vision_cache=args.vision_cache,
                    speculate=args.speculate,
                    sampling=args.sampling,
                    logprobs=args.logprobs),
        pad_id=tok.pad_id, eos_id=tok.eos_id,
        stop_ids=tuple(args.stop_id or ()))

    def tiles_for(path):
        return tile_image(_read_image(os.path.join(args.images_root, path)),
                          pre, batcher.device)

    def more_buffered() -> bool:
        """True when another stdin line can be read without blocking."""
        import select

        try:
            return bool(select.select([sys.stdin], [], [], 0)[0])
        except (OSError, ValueError):
            return True

    serve_lines(batcher, iter(sys.stdin.readline, ""),
                make_request_builder(cfg, tok, batcher, tiles_for), tok,
                lambda obj: print(json.dumps(obj), flush=True),
                window=args.window, stream=args.stream,
                more_buffered=more_buffered, logprobs=args.logprobs)
    print(json.dumps({"served": True, "stats": batcher.stats}),
          file=sys.stderr)


def _config(args):
    """Model config from --config/--vocab-size/--moe-*, with the JAX CLI's
    rules (`_mllm_config`), shared by `serve` and `train`: a checkpoint
    trained with --moe-experts has a routed-FFN param tree, so serving it
    needs the same flag; --moe-kernel applies to the ragged impl only."""
    import dataclasses

    from .models import mllm as M

    cfg = M.CONFIGS[args.config]()
    overrides = {}
    if getattr(args, "vocab_size", 0):
        overrides["vocab_size"] = args.vocab_size
    if getattr(args, "moe_experts", 0):
        overrides["moe_experts"] = args.moe_experts
        # grouped routing only affects training; inference ignores it
        if getattr(args, "moe_group", 0):
            overrides["moe_group"] = args.moe_group
        if getattr(args, "moe_impl", None):
            overrides["moe_impl"] = args.moe_impl
        if getattr(args, "moe_kernel", None):
            if overrides.get("moe_impl", cfg.llm.moe_impl) != "ragged":
                raise SystemExit(
                    "--moe-kernel applies to the ragged impl's grouped "
                    "matmuls only (pass --moe-impl ragged)")
            overrides["moe_kernel"] = args.moe_kernel
    elif (getattr(args, "moe_group", 0) or getattr(args, "moe_impl", None)
          or getattr(args, "moe_kernel", None)):
        raise SystemExit(
            "--moe-group/--moe-impl/--moe-kernel require --moe-experts "
            "(a dense config has no routed FFN; the checkpoint's param "
            "tree would not match)")
    if overrides:
        cfg = dataclasses.replace(
            cfg, llm=dataclasses.replace(cfg.llm, **overrides))
    return cfg


def _load_model(cfg, args):
    """The model of `cfg` on `--device` with the `--checkpoint` weights,
    quantised to int8 (models/quantize.py) with `--quantize-weights`."""
    import torch

    from .models import mllm as M
    from .models.quantize import quantize_model

    device = torch.device(args.device)
    model = M.MultiFrameMLLM(cfg, device=device)
    model.load_state_dict(_load_params(args.checkpoint, device))
    model.eval()
    if args.quantize_weights:
        quantize_model(model)
    return model


def read_campaigns(args) -> list[tuple[str, list[dict]]]:
    """(name, records) of `--eval-jsonl` (one campaign named by the file),
    or of `--eval-root`: one campaign per engine directory holding
    `*.jsonl` files, the `*_orig.jsonl` full pre-subsample dumps skipped;
    each cut to `--limit` records a file."""
    if bool(args.eval_jsonl) == bool(args.eval_root):
        raise SystemExit("pass exactly one of --eval-jsonl / --eval-root")

    def read_jsonl(path):
        with open(path) as f:
            rows = [json.loads(line) for line in f if line.strip()]
        return rows[: args.limit] if args.limit else rows

    if args.eval_jsonl:
        return [(os.path.basename(args.eval_jsonl),
                 read_jsonl(args.eval_jsonl))]
    campaigns = []
    for engine in sorted(os.listdir(args.eval_root)):
        edir = os.path.join(args.eval_root, engine)
        if not os.path.isdir(edir):
            continue
        rows = []
        for fn in sorted(os.listdir(edir)):
            if fn.endswith(".jsonl") and not fn.endswith("_orig.jsonl"):
                rows.extend(read_jsonl(os.path.join(edir, fn)))
        if rows:
            campaigns.append((engine, rows))
    if not campaigns:
        raise SystemExit(f"no eval JSONL under {args.eval_root}")
    return campaigns


def eval_report(model, tok, args):
    """Run the `eval` command's campaigns on `model` -> (report, the
    predictions as the --output file holds them, the batcher or None): a
    single campaign's eval_harness report, or with several the weighted
    aggregate and one report per engine."""
    from .models.data import DataConfig
    from .models.preprocess import PreprocessConfig
    from .models.runner import EvalRunConfig, run_eval

    cfg = model.cfg
    if tok.vocab_size > cfg.llm.vocab_size:
        raise ValueError(f"tokenizer vocab {tok.vocab_size} > model vocab "
                         f"{cfg.llm.vocab_size}")
    campaigns = read_campaigns(args)
    run_cfg = EvalRunConfig(
        max_new_tokens=args.max_new_tokens, mc_logprob=args.mc_logprob,
        speculate=0 if args.paged else args.speculate,
        data=DataConfig(preprocess=PreprocessConfig(
            tile_size=cfg.vit.image_size, max_tiles=args.max_tiles,
            resize_hw=None)))
    batcher = None
    if args.paged:
        from .models.paged_kv import PagedBatcher, PagedConfig

        batcher = PagedBatcher(
            model,
            PagedConfig(slots=args.slots, page_size=args.page_size,
                        num_pages=args.num_pages,
                        max_prompt_len=args.max_prompt_len,
                        max_new_tokens=args.max_new_tokens,
                        kv_dtype=args.kv_dtype,
                        prefix_cache=args.prefix_cache,
                        prefill_chunk=args.prefill_chunk,
                        vision_cache=args.vision_cache,
                        speculate=args.speculate, logprobs=args.logprobs),
            pad_id=tok.pad_id, eos_id=tok.eos_id)

    def loader(path):
        return _read_image(os.path.join(args.images_root, path))

    per_engine, predictions = {}, {}
    for name, samples in campaigns:
        rep = run_eval(model, tok, samples, loader, run_cfg,
                       batch_size=args.batch_size, batcher=batcher)
        predictions[name] = rep.pop("predictions")
        per_engine[name] = rep
    if len(campaigns) == 1:
        name = campaigns[0][0]
        return per_engine[name], predictions[name], batcher
    total = sum(r["count"] for r in per_engine.values())
    hits = sum(r["accuracy"] * r["count"] for r in per_engine.values())
    report = {"accuracy": hits / total if total else 0.0, "count": total,
              "engines": per_engine}
    return report, predictions, batcher


def cmd_eval(args) -> None:
    """MultiSPA evaluation: a checkpoint x eval JSONL (the engines'
    records) x an images directory -> eval_harness report, on `--device`.
    `--paged` serves the campaign through the paged batcher, with the
    prefix cache, int8 kv, chunked prefill, vision cache, speculation and
    logprobs as options; otherwise the batched path decodes
    `--batch-size` rows at a time. Prints the report (with the batcher's
    counters as `serving_stats`); `--output` also gets the predictions."""
    from .models.tokenizer import load_tokenizer

    cfg = _config(args)
    model = _load_model(cfg, args)
    tok = load_tokenizer(args.tokenizer)
    report, preds, batcher = eval_report(model, tok, args)
    if args.output:
        with open(args.output, "w") as f:
            json.dump({**report, "predictions": preds}, f)
    if batcher is not None:
        report["serving_stats"] = batcher.stats
    print(json.dumps(report))


def _load_params(path: str, device):
    """A state dict from a `torch.save`d file, or the params of a train
    save (a step directory or a rolling root with `LATEST`)."""
    import torch

    from .parallel.train import restore_checkpoint

    path = os.path.abspath(path)
    if os.path.isdir(path):
        return restore_checkpoint(path, map_location=device)["params"]
    return torch.load(path, map_location=device, weights_only=True)


def train_steps(step_fn: Callable, batches: Iterable[dict], steps: int,
                device, start_step: int = 0, log_every: int = 10,
                log: Callable = log_event,
                after_step: Callable[[int], None] | None = None,
                world: int = 1):
    """Run `step_fn` (parallel/train.make_train_step) over numpy `batches`
    from step `start_step` until step `steps`, moving each batch to
    `device`. Returns `(summary, history)`: the JAX `train` summary's
    numbers (`steps`, `first_loss`, `last_loss`, and the steady-state
    `steps_per_s` / `tokens_per_s` that leave out the first step and the
    time spent in `after_step`, counting padded tokens as the JAX CLI
    does) and one `{"loss", "grad_norm", "step_s"}` per step taken.
    `after_step(n)` runs after the n-th step (checkpoints). Under data
    parallelism each batch is this process's 1/`world` of the global
    batch's rows, and the tokens counted are the global batch's."""
    import torch

    def to_device(batch):
        return {k: torch.from_numpy(np.asarray(v)).to(
                    device, dtype=torch.long if v.dtype.kind in "iu"
                    else None) for k, v in batch.items()}

    history: list[dict] = []
    steady_t0 = mark = time.perf_counter()
    steady_tokens = steady_steps = 0
    pause_s = 0.0
    for step, batch in enumerate(batches, start=start_step):
        if step >= steps:
            break
        metrics = step_fn(to_device(batch))
        loss, grad_norm = float(metrics["loss"]), float(metrics["grad_norm"])
        now = time.perf_counter()
        history.append({"loss": loss, "grad_norm": grad_norm,
                        "step_s": now - mark})
        if len(history) == 1:            # the first step paid the warm-up
            steady_t0 = now
        else:
            steady_tokens += world * int(np.prod(batch["input_ids"].shape))
            steady_steps += 1
        if step % log_every == 0 or step == steps - 1:
            log("step", step=step, loss=round(loss, 6),
                grad_norm=round(grad_norm, 6),
                step_s=round(history[-1]["step_s"], 4))
        if after_step is not None:
            t0 = time.perf_counter()
            after_step(step + 1)
            pause_s += time.perf_counter() - t0
        mark = time.perf_counter()
    steady_s = (mark - steady_t0 - pause_s) if steady_steps else 0.0
    summary = {
        "steps": len(history),
        "first_loss": history[0]["loss"] if history else None,
        "last_loss": history[-1]["loss"] if history else None,
        "steps_per_s": round(steady_steps / steady_s, 4)
        if steady_steps else None,
        "tokens_per_s": round(steady_tokens / steady_s, 1)
        if steady_steps else None}
    return summary, history


def _launched_world() -> int:
    """The processes this one runs among: its group's size, else the
    launcher's `WORLD_SIZE`, else 1."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE") or 1)


def _check_data_parallel(args) -> None:
    """The mesh `data x model x seq x expert` must fit the processes
    launched: exactly, when `--data-parallel` is given (the JAX CLI takes
    that many of its chips; here each process is one), else the other axes
    must divide them (the data axis takes the rest, as `make_mesh` fills
    it)."""
    world = _launched_world()
    other = args.model_parallel * args.seq_parallel * args.expert_parallel
    n = (args.data_parallel or 1) * other
    if (args.data_parallel and n != world) or world % other:
        shape = (f"{args.data_parallel or 'data'} x {args.model_parallel} "
                 f"model x {args.seq_parallel} seq x "
                 f"{args.expert_parallel} expert")
        raise ValueError(
            f"the mesh ({shape}) does not match the {world} process(es) "
            f"launched: start one process a device, e.g. python -m "
            f"torch.distributed.run --nproc-per-node {n} -m "
            f"multi_spatialmllm_tpu_torch train ...")


def _train_config(args):
    """`_config` for `train`: with `--lora-rank` on the flagship the LLM
    recomputes each layer in the backward (remat), since the whole-depth
    activations do not fit beside the frozen float32 base on one 80 GB
    card."""
    import dataclasses

    cfg = _config(args)
    if args.lora_rank and args.config == "flagship" and not cfg.llm.remat:
        cfg = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm,
                                                               remat=True))
    return cfg


def cmd_train(args) -> None:
    """SFT from the CLI: data-mixture meta JSON x model config -> rolling
    torch checkpoints, on one device (`--device`, the card by default).
    Deterministic mixture streaming (models/mixture.py), padded or packed
    batches, float32 master weights with the config's compute dtype, a
    dense or routed-MoE decoder (`--moe-*`), and the optax-equivalent AdamW
    step (parallel/train.py); `--lora-rank` trains adapters alone over the
    frozen base (parallel/lora.py) and saves merged weights; `--eval-*`
    scores held-out records on the (merged) weights; `--async-save` writes
    checkpoints on a background thread. Prints the JAX CLI's summary
    line.

    The mesh: launched as `n` processes (`python -m torch.distributed.run
    --nproc-per-node n -m multi_spatialmllm_tpu_torch train ...`), the
    command joins their group (NCCL on the card, gloo with `--device cpu`)
    and trains over the mesh the JAX CLI builds from `--data-parallel`
    (the rest of the processes when not given), `--model-parallel` (Megatron
    tensor parallelism), `--seq-parallel` (ring attention), and
    `--expert-parallel` (the MoE's expert tables; einsum impl only), with
    `--fsdp` sharding the large parameters over the data axis
    (parallel/sharding.shard_model). Every process builds the same global
    batches from the mixture and the seed, and keeps its rows of each
    (`parallel/train.local_rows`). Checkpoints hold the whole tensors, as a
    single-device save does, and `--resume` re-shards them. Process 0
    alone logs, saves and prints the summary; on a mesh that shards the
    model every process takes part in the evaluation (process 0 reports
    it), else process 0 evaluates alone; the others wait at a barrier."""
    _check_data_parallel(args)
    cfg = _train_config(args)
    import torch
    import torch.distributed as dist

    from .models import mllm as M
    from .models.data import DataConfig, prefetch_iterator
    from .models.mixture import (
        load_meta,
        mixture_batches,
        mixture_stats,
        validate_mixture,
    )
    from .models.preprocess import PreprocessConfig
    from .models.tokenizer import load_tokenizer
    from .parallel.distributed import initialize_multihost
    from .parallel.mesh import axes_group, make_mesh
    from .parallel.sharding import (
        ROW_AXES,
        model_state,
        optimizer_state,
        shard_model,
        shard_optimizer_state,
    )
    from .parallel.train import (
        AdamW,
        AsyncRollingSaver,
        TrainConfig,
        local_rows,
        make_train_step,
        restore_checkpoint,
        save_checkpoint_rolling,
    )

    tok = load_tokenizer(args.tokenizer)
    if tok.vocab_size > cfg.llm.vocab_size:
        raise ValueError(f"tokenizer vocab {tok.vocab_size} > model vocab "
                         f"{cfg.llm.vocab_size}")
    if tok.img_context_id != cfg.img_context_id:
        raise ValueError(f"IMG_CONTEXT id {tok.img_context_id} != "
                         f"{cfg.img_context_id}")
    if args.resume and args.lora_rank:
        raise ValueError("--resume restores full-finetune opt_state; LoRA "
                         "runs restart")
    if args.save_every and not args.output:
        raise ValueError("--save-every needs --output")
    if args.resume and not args.init_checkpoint:
        raise ValueError("--resume needs --init-checkpoint")

    entries = load_meta(args.meta)
    if args.validate_only:
        log_event("mixture", **mixture_stats(entries))
        report = validate_mixture(entries, image_loader=_read_image,
                                  sample=args.validate_sample,
                                  seed=args.seed)
        print(json.dumps(report))
        if not report["ok"]:
            raise SystemExit(1)
        return
    owns_group = not dist.is_initialized()
    initialize_multihost(device=args.device)
    grouped = dist.is_initialized()
    mesh = make_mesh(n_data=args.data_parallel or None,
                     n_model=args.model_parallel, n_seq=args.seq_parallel,
                     n_expert=args.expert_parallel) if grouped else None
    world, first = (dist.get_world_size(), dist.get_rank() == 0) \
        if grouped else (1, True)
    rows = axes_group(mesh, ROW_AXES)[2]

    def log(kind, **fields):
        if first:
            log_event(kind, **fields)

    def together():
        if grouped:
            dist.barrier()

    log("mixture", **mixture_stats(entries))

    data_cfg = DataConfig(
        max_seq_len=args.seq_len, max_tiles=args.max_tiles,
        preprocess=PreprocessConfig(
            tile_size=cfg.vit.image_size, max_tiles=args.tiles_per_image,
            resize_hw=None))
    batches = mixture_batches(entries, tok, cfg, _read_image,
                              args.batch_size, data_cfg, seed=args.seed,
                              packed=args.packed,
                              shard_index=args.data_shard,
                              num_shards=args.data_num_shards,
                              device=args.device)
    if args.prefetch:
        batches = prefetch_iterator(batches, depth=args.prefetch,
                                    device=args.device)

    device = torch.device(args.device)
    model = M.MultiFrameMLLM(cfg, device=device, param_dtype=torch.float32)
    M.init_random_weights(model, args.seed)
    train_cfg = TrainConfig(learning_rate=args.lr, warmup_steps=args.warmup,
                            total_steps=args.steps)
    start_step = 0
    opt_state = None
    if args.init_checkpoint:
        if args.resume:
            state = restore_checkpoint(os.path.abspath(args.init_checkpoint),
                                       map_location=device)
            model.load_state_dict(state["params"])
            opt_state = state["opt_state"]
            start_step = int(state["step"])
        else:
            model.load_state_dict(_load_params(args.init_checkpoint, device))
        log("restored", path=os.path.abspath(args.init_checkpoint),
            step=start_step)
    lora = lcfg = None
    if args.lora_rank:
        from .models import prng
        from .parallel import lora as L

        lcfg = L.LoRAConfig(rank=args.lora_rank)
        if args.moe_experts:
            # the default targets are the attention weights; routed expert
            # tables are never adapted
            print("note: --lora-rank with --moe-experts adapts the "
                  "ATTENTION kernels only; the routed MoE FFN stays "
                  "frozen (expert tables are not LoRA targets)",
                  file=sys.stderr)
        lora = L.init_lora(model, lcfg, prng.key(args.seed + 1))
    plan = shard_model(model, mesh, fsdp=args.fsdp) if mesh is not None \
        else None
    # every process evaluates a model whose parameters it holds a share of
    sharded = plan is not None and any(plan.shard_axes(n)
                                       for n in plan.layout)
    if lora is not None:
        opt = AdamW(L.lora_named_tensors(lora), train_cfg)
        step_fn = L.make_lora_train_step(model, opt, lcfg, mesh=mesh)
        log("lora", rank=lcfg.rank, trainable=L.lora_param_count(lora))
    else:
        opt = AdamW(list(model.named_parameters()), train_cfg)
        if opt_state is not None:
            opt.load_state_dict(shard_optimizer_state(opt_state, plan))
        step_fn = make_train_step(model, opt, accum_steps=args.accum,
                                  mesh=mesh)

    eval_samples: list = []
    if args.eval_jsonl:
        with open(args.eval_jsonl) as f:
            eval_samples = [json.loads(line) for line in f if line.strip()]
        if args.eval_limit:
            eval_samples = eval_samples[: args.eval_limit]
    eval_done: dict = {}              # step -> accuracy (no repeats)

    def run_eval_now(step):
        from .models.runner import EvalRunConfig, run_eval

        if step in eval_done:
            return eval_done[step]
        from .parallel.lora import merged

        with merged(model, lora, lcfg), torch.no_grad():
            rep = run_eval(
                model, tok, eval_samples,
                lambda p: _read_image(os.path.join(args.eval_images_root,
                                                   p)),
                EvalRunConfig(max_new_tokens=args.eval_max_new_tokens,
                              mc_logprob=args.mc_logprob, data=data_cfg),
                batch_size=min(len(eval_samples), args.batch_size))
        log("eval", step=step, accuracy=round(rep["accuracy"], 4),
            count=rep["count"])
        eval_done[step] = rep["accuracy"]
        return rep["accuracy"]

    saver = AsyncRollingSaver(os.path.abspath(args.output), keep=args.keep) \
        if args.async_save and args.output and first else None

    def save(step):
        # whole tensors (gathered over the mesh by every process)
        if lora is not None:            # merged weights, no optimizer state
            from .parallel.lora import merge_lora

            params, state = merge_lora(model_state(model), lora, lcfg), None
        else:
            params, state = model_state(model), optimizer_state(opt, plan)
        if first:
            write(step, params, state)
        together()

    def write(step, params, state):
        if saver is not None:           # the write overlaps the next steps
            where = saver.save(params, state, step=step)
        else:
            where = save_checkpoint_rolling(os.path.abspath(args.output),
                                            params, state, step=step,
                                            keep=args.keep)
        log("checkpoint", path=where, step=step)

    def evaluate(step):
        acc = run_eval_now(step) if first or sharded else None
        together()
        return acc if first else None

    def after_step(n):
        if args.save_every and n % args.save_every == 0:
            save(n)
        if eval_samples and args.eval_every and n % args.eval_every == 0:
            evaluate(n)

    if start_step:
        # the mixture replays deterministically: skip the trained batches
        for _ in itertools.islice(batches, start_step):
            pass
    if mesh is not None:
        accum = 1 if lora is not None else args.accum
        batches = (local_rows(b, accum, mesh) for b in batches)
    from .utils.profiling import device_trace

    # process 0's steps stand for the others' in the trace
    with device_trace(args.trace_dir if first else None):
        summary, history = train_steps(step_fn, batches, args.steps, device,
                                       start_step=start_step,
                                       log_every=args.log_every, log=log,
                                       after_step=after_step, world=rows)
    if args.output:
        save(start_step + len(history))
        if saver is not None:
            saver.wait()                # the final save is durable
    if eval_samples:
        summary = {**summary, "eval_accuracy": evaluate(
            start_step + len(history))}
    mesh_shape = dict(zip(mesh.mesh_dim_names, mesh.shape)) if grouped \
        else {"data": 1, "model": 1}
    if first:
        print(json.dumps({**summary, "devices": world, "mesh": mesh_shape,
                          "device": str(device)}))
    if owns_group and grouped:
        dist.destroy_process_group()


_DTYPE_NAMES = ("bfloat16", "float32")


def cmd_import_checkpoint(args) -> None:
    """HF InternVL-2 safetensors (a file or a directory of shards) -> the
    port's checkpoint form, a `torch.save`d state dict that `serve`,
    `eval` and `train --init-checkpoint` read. Tensors are read one at a
    time, cast to `--dtype` and converted on `--device`."""
    import torch

    from .models import checkpoint_import as CI

    cfg = _config(args)
    device = torch.device(args.device)
    sd = CI.load_internvl2_checkpoint(args.checkpoint, cfg,
                                      param_dtype=getattr(torch, args.dtype),
                                      device=device)
    out = os.path.abspath(args.output)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    torch.save(sd, out)
    print(json.dumps({"output": args.output,
                      "parameters": sum(t.numel() for t in sd.values()),
                      "dtype": args.dtype}))


def cmd_export_checkpoint(args) -> None:
    """Inverse of import-checkpoint: the port's state dict (or the params
    of a train save) -> HF InternVL-2 safetensors, `model.safetensors` or
    `--shard-gb` shards in the JAX export's key order with
    `model.safetensors.index.json`, so weights trained here load back into
    the reference's InternVL-2 stack (layer scales stay folded)."""
    import torch

    from .models import checkpoint_import as CI

    cfg = _config(args)
    sd = _load_params(args.checkpoint, torch.device(args.device))
    if cfg.llm.moe_experts > 0 or any(".moe." in k for k in sd):
        raise SystemExit(
            "export-checkpoint: routed-MoE checkpoints cannot be "
            "exported — the HF InternVL-2 safetensors layout has no "
            "routed-expert tensors (feed_forward.w{1,2,3} are dense). "
            "Keep MoE checkpoints in orbax form; eval/serve/generate "
            "load them via --moe-experts.")
    dtype = getattr(torch, args.dtype)
    state = {k: v.to(dtype) for k, v in
             CI.export_state_dict(sd, cfg).items()}
    names = CI.write_sharded(state, args.output, int(args.shard_gb * 1e9))
    print(json.dumps({"output": args.output, "tensors": len(state),
                      "shards": len(names), "dtype": args.dtype}))


def cmd_demo(args) -> None:
    """Synthetic scenes and two synthetic TAPVid records -> `run_all` on
    `--device`; prints each engine's sample counts (train + val)."""
    from .core.scene import SceneStore
    from .core.synthetic import make_scene, make_tapvid_npz
    from .pipeline import PipelineConfig, SpatialEnginePipeline

    scenes = [
        make_scene(scene_id=f"demo{i:04d}_00", seed=args.seed + i,
                   n_images=args.images_per_scene,
                   n_background=args.points_per_scene)
        for i in range(args.scenes)
    ]
    store = SceneStore.write(scenes, os.path.join(args.output, "scenes"))
    pipe = SpatialEnginePipeline(
        store, args.output,
        PipelineConfig(overlap_min=0.1, overlap_max=100.0, interval=5.0),
        device=args.device)
    tapvid = {f"demo_seq{i}": make_tapvid_npz(seed=args.seed + 50 + i)
              for i in range(2)}
    results = pipe.run_all(tapvid_records=tapvid)

    def count(v):
        if isinstance(v, dict):
            return sum(count(x) for x in v.values())
        return v.n_train + v.n_val

    summary = {
        engine: {k: count(v) for k, v in outs.items()}
        if isinstance(outs, dict) else outs
        for engine, outs in results.items()
    }
    print(json.dumps(summary, indent=2, default=str))


def cmd_ingest_scannet(args) -> None:
    """Raw ScanNet scans (`<scans>/scene*/`) -> the reference's
    instance-data layout under `--output` and its `scenes_info.pkl`."""
    from .ingest.scannet_export import batch_export

    scan_dirs = sorted(glob.glob(os.path.join(args.scans, "scene*")))
    if args.limit:
        scan_dirs = scan_dirs[: args.limit]
    info = batch_export(scan_dirs, args.output,
                        label_map_path=args.label_map,
                        info_pkl_path=os.path.join(
                            args.output, "scenes_info.pkl"))
    print(f"exported {len(info)} scans to {args.output}")


def cmd_ingest_sens(args) -> None:
    """`<scans>/<scan>/<scan>.sens` plus the scan's mesh and annotations ->
    one scene pack `<output>/<scan>.npz` each, every `--frame-skip`-th
    frame kept (depth inflated by the native library)."""
    from .ingest.posed_images import scene_from_sens
    from .ingest.scannet_export import export_scene_arrays

    os.makedirs(args.output, exist_ok=True)
    sens_files = sorted(glob.glob(os.path.join(args.scans, "*", "*.sens")))
    if args.limit:
        sens_files = sens_files[: args.limit]
    count = 0
    for sens_path in sens_files:
        scan = os.path.basename(os.path.dirname(sens_path))
        scan_dir = os.path.dirname(sens_path)
        arrays = export_scene_arrays(
            os.path.join(scan_dir, f"{scan}_vh_clean_2.ply"),
            os.path.join(scan_dir, f"{scan}.aggregation.json"),
            os.path.join(scan_dir, f"{scan}_vh_clean_2.0.010000.segs.json"),
            os.path.join(scan_dir, f"{scan}.txt"))
        scene = scene_from_sens(sens_path, scan, arrays,
                                frame_skip=args.frame_skip)
        scene.save_npz(os.path.join(args.output, f"{scan}.npz"))
        count += 1
    print(f"built {count} scene packs in {args.output}")


def cmd_coverage(args) -> None:
    """Resumable sharded coverage runs (find_object_coverage.sh:24-48
    parity): each invocation takes its round-robin slice of the store's
    scenes, runs object visibility (M3) and coverage (M4) on `--device`
    and writes per-dimension shard pickles; `--merge` combines the shards
    into the reference's merged_{split}_object_coverage_{dim}.pkl files."""
    from .core.io import dump_pickle, load_pickle
    from .core.scene import SceneStore
    from .parallel.distributed import host_shard
    from .stages.coverage import build_object_coverage, merge_coverage_shards
    from .stages.object_visibility import build_object_visibility
    from .utils.profiling import device_trace

    os.makedirs(args.output, exist_ok=True)
    dims = ("height", "length", "width")
    if args.merge:
        for dim in dims:
            shards = sorted(glob.glob(os.path.join(
                args.output, f"{args.split}_object_coverage_{dim}_shard*.pkl")))
            merged = merge_coverage_shards(load_pickle(p) for p in shards)
            out = os.path.join(
                args.output,
                f"merged_{args.split}_object_coverage_{dim}.pkl")
            dump_pickle(merged, out)
            print(json.dumps({"dim": dim, "shards": len(shards),
                              "scenes": len(merged), "output": out}))
        return

    store = SceneStore(args.scenes)
    scene_ids = host_shard(store.scene_ids(), args.shard_index,
                           args.num_shards)
    shard_tag = f"shard{args.shard_index:03d}of{args.num_shards:03d}"
    paths = {dim: os.path.join(
        args.output, f"{args.split}_object_coverage_{dim}_{shard_tag}.pkl")
        for dim in dims}
    if all(os.path.exists(p) for p in paths.values()) and not args.force:
        print(json.dumps({"shard": shard_tag, "status": "already done"}))
        return
    scenes = [store.get(sid) for sid in scene_ids]
    with device_trace(args.trace_dir):
        ov = build_object_visibility(scenes, device=args.device)
        h, l, w = build_object_coverage(scenes, ov, seed=args.seed,
                                        device=args.device)
    for dim, result in zip(dims, (h, l, w)):
        dump_pickle(result, paths[dim])
    print(json.dumps({"shard": shard_tag, "scenes": len(scenes),
                      "outputs": list(paths.values())}))


def cmd_pipeline(args) -> None:
    """`run_all` over an existing scene store on `--device`; `--trace-dir`
    wraps the L3 stages (visibility, frame relations) in a torch.profiler
    trace, as the JAX command wraps them in a jax.profiler trace."""
    from .core.scene import SceneStore
    from .pipeline import PipelineConfig, SpatialEnginePipeline
    from .utils.profiling import device_trace

    store = SceneStore(args.scenes)
    pipe = SpatialEnginePipeline(store, args.output, PipelineConfig(),
                                 device=args.device)
    with device_trace(args.trace_dir):
        pipe.visibility()
        pipe.frame_relations()
    results = pipe.run_all()
    print(json.dumps({k: str(v) for k, v in results.items()}, indent=2))


def cmd_tapvid(args) -> None:
    """Both object-movement question types over one TAPVid-3D split
    (`<data>/<sub-dataset>/<scene_id>.npz`), frames under `<output>/images`,
    M5 on `--device`."""
    from .engines import object_movement as OM
    from .ingest.tapvid import load_split_records

    records = load_split_records(args.data, args.meta, args.sub_dataset,
                                 args.split)
    for qtype in OM.QUESTION_TYPES:
        cfg = OM.ObjectMovementConfig(question_type=qtype,
                                      dot_variant=args.dot)
        out = OM.generate(
            records,
            os.path.join(args.output,
                         f"{args.sub_dataset}_{qtype}_{args.split}.jsonl"),
            cfg, img_output_dir=os.path.join(args.output, "images"),
            eval_mode=args.split == "val", device=args.device)
        print(f"{qtype}: {out.n_train + out.n_val} samples")


def _add_moe_flags(p, group: bool) -> None:
    """The routed-MoE flags of the JAX CLI (`--moe-group`, GShard groups,
    matters to training only)."""
    p.add_argument("--moe-experts", type=int, default=0,
                   help="routed-MoE FFN with this many experts (0: dense)")
    if group:
        p.add_argument("--moe-group", type=int, default=0,
                       help="einsum impl: route training rows in groups "
                            "of this many tokens")
    p.add_argument("--moe-impl", choices=("einsum", "ragged"), default=None)
    p.add_argument("--moe-kernel", choices=("xla", "pallas"), default=None,
                   help="ragged impl's grouped products: pallas = the "
                        "hand-written kernels")


def build_parser() -> argparse.ArgumentParser:
    """The command-line parser: one subcommand a command, each with its
    handler as `fn`."""
    parser = argparse.ArgumentParser(prog="multi_spatialmllm_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("demo",
                       help="synthetic scenes and TAPVid records through "
                            "the data engine")
    p.add_argument("--output", default="./msm_demo")
    p.add_argument("--scenes", type=int, default=3)
    p.add_argument("--images-per-scene", type=int, default=16)
    p.add_argument("--points-per-scene", type=int, default=6000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.set_defaults(fn=cmd_demo)

    p = sub.add_parser("ingest-scannet", help="export raw ScanNet scans")
    p.add_argument("--scans", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--label-map", default=None)
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="accepted for symmetry: the export is host work")
    p.set_defaults(fn=cmd_ingest_scannet)

    p = sub.add_parser("ingest-sens", help=".sens -> scene packs")
    p.add_argument("--scans", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--frame-skip", type=int, default=5)
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="accepted for symmetry: the ingest is host work")
    p.set_defaults(fn=cmd_ingest_sens)

    p = sub.add_parser("pipeline",
                       help="the data engine's ScanNet engines over a "
                            "scene store")
    p.add_argument("--scenes", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--trace-dir", default=None,
                   help="torch.profiler trace dir for the L3 stages")
    p.add_argument("--device", default="cuda")
    p.set_defaults(fn=cmd_pipeline)

    p = sub.add_parser("coverage",
                       help="sharded object-coverage runs + merge")
    p.add_argument("--scenes", help="scene store (shard mode)")
    p.add_argument("--output", required=True)
    p.add_argument("--split", default="train")
    p.add_argument("--shard-index", type=int, default=0)
    p.add_argument("--num-shards", type=int, default=1)
    p.add_argument("--merge", action="store_true",
                   help="merge existing shard pkls instead of computing")
    p.add_argument("--force", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--trace-dir", default=None,
                   help="torch.profiler trace dir for M3/M4")
    p.add_argument("--device", default="cuda")
    p.set_defaults(fn=cmd_coverage)

    p = sub.add_parser("tapvid", help="object-movement engines over npz")
    p.add_argument("--data", required=True)
    p.add_argument("--meta", default=None,
                   help="TAPVid-3D meta_data dir (default: the vendored "
                        "split lists in data/tapvid3d_meta)")
    p.add_argument("--sub-dataset", default="adt")
    p.add_argument("--split", default="train")
    p.add_argument("--dot", action="store_true")
    p.add_argument("--output", required=True)
    p.add_argument("--device", default="cuda")
    p.set_defaults(fn=cmd_tapvid)

    p = sub.add_parser("eval",
                       help="MultiSPA eval: checkpoint x JSONL -> scores")
    p.add_argument("--checkpoint", required=True,
                   help="torch.save'd state dict of MultiFrameMLLM, or a "
                        "train save (step dir or rolling root)")
    p.add_argument("--config", choices=("flagship", "bench", "tiny"),
                   default="flagship")
    p.add_argument("--device", default="cuda")
    p.add_argument("--tokenizer", default=None,
                   help="HF tokenizer.json (default: builtin word-level)")
    p.add_argument("--vocab-size", type=int, default=0,
                   help="override the config's vocab (0 = keep; must "
                        "cover the tokenizer)")
    _add_moe_flags(p, group=False)
    p.add_argument("--eval-jsonl", default=None,
                   help="one engine evaluation_data JSONL")
    p.add_argument("--eval-root", default=None,
                   help="qa/evaluation_data directory: every engine's "
                        "*.jsonl evaluated (skipping *_orig.jsonl), "
                        "per-engine + aggregate report")
    p.add_argument("--images-root", default=".")
    p.add_argument("--output", default=None, help="report+predictions json")
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--max-new-tokens", type=int, default=24)
    p.add_argument("--max-tiles", type=int, default=6)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--speculate", type=int, default=0)
    p.add_argument("--paged", action="store_true",
                   help="serve through the paged continuous batcher")
    p.add_argument("--slots", type=int, default=8)
    p.add_argument("--page-size", type=int, default=64)
    p.add_argument("--num-pages", type=int, default=128)
    p.add_argument("--max-prompt-len", type=int, default=2048)
    p.add_argument("--mc-logprob", action="store_true",
                   help="score multiple-choice records by candidate "
                        "logprob instead of free decoding")
    p.add_argument("--quantize-weights", action="store_true",
                   help="weight-only int8 (models/quantize.py)")
    p.add_argument("--kv-dtype", choices=("native", "int8"),
                   default="native")
    p.add_argument("--prefix-cache", action="store_true")
    p.add_argument("--prefill-chunk", type=int, default=0)
    p.add_argument("--vision-cache", type=int, default=0)
    p.add_argument("--logprobs", action="store_true",
                   help="report per-sample mean token logprob "
                        "(report['confidences']); paged only")
    p.set_defaults(fn=cmd_eval)

    p = sub.add_parser("serve",
                       help="JSONL serving loop (stdin -> stdout) over "
                            "the paged batcher")
    p.add_argument("--checkpoint", required=True,
                   help="torch.save'd state dict of MultiFrameMLLM, or a "
                        "train save (step dir or rolling root)")
    p.add_argument("--config", choices=("flagship", "bench", "tiny"),
                   default="flagship")
    p.add_argument("--device", default="cuda")
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--vocab-size", type=int, default=0)
    p.add_argument("--images-root", default=".")
    p.add_argument("--max-tiles", type=int, default=6,
                   help="dynamic-tiling cap per image")
    p.add_argument("--window", type=int, default=64,
                   help="max requests drained per serving window")
    p.add_argument("--stream", action="store_true",
                   help="emit incremental token chunks per request")
    p.add_argument("--sampling", action="store_true",
                   help="honor temperature/top_p/seed request fields")
    p.add_argument("--max-new-tokens", type=int, default=64)
    p.add_argument("--slots", type=int, default=8)
    p.add_argument("--page-size", type=int, default=64)
    p.add_argument("--num-pages", type=int, default=256)
    p.add_argument("--max-prompt-len", type=int, default=2048)
    p.add_argument("--stop-id", type=int, action="append",
                   help="extra stop token id (repeatable; eos always "
                        "stops)")
    p.add_argument("--kv-dtype", choices=("native", "int8"),
                   default="native",
                   help="kv page pools in the model dtype, or int8 with "
                        "per-row scales")
    _add_moe_flags(p, group=False)
    p.add_argument("--prefix-cache", action="store_true")
    p.add_argument("--prefill-chunk", type=int, default=0)
    p.add_argument("--vision-cache", type=int, default=0)
    p.add_argument("--speculate", type=int, default=0)
    p.add_argument("--quantize-weights", action="store_true",
                   help="weight-only int8 (models/quantize.py)")
    p.add_argument("--logprobs", action="store_true",
                   help="attach per-token logprobs to each result")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("import-checkpoint",
                       help="HF InternVL-2 safetensors -> the port's "
                            "state dict")
    p.add_argument("--checkpoint", required=True,
                   help=".safetensors file or directory of shards")
    p.add_argument("--output", required=True,
                   help="torch.save'd state dict to write")
    p.add_argument("--config", choices=("flagship", "tiny"),
                   default="flagship")
    p.add_argument("--vocab-size", type=int, default=0)
    p.add_argument("--dtype", choices=_DTYPE_NAMES, default="bfloat16")
    p.add_argument("--device", default="cuda")
    p.set_defaults(fn=cmd_import_checkpoint)

    p = sub.add_parser("export-checkpoint",
                       help="the port's state dict -> HF InternVL-2 "
                            "safetensors")
    p.add_argument("--checkpoint", required=True,
                   help="torch.save'd state dict (import-checkpoint "
                        "output) or a train save")
    p.add_argument("--output", required=True,
                   help="directory for *.safetensors (+ index when "
                        "sharded)")
    p.add_argument("--config", choices=("flagship", "bench", "tiny"),
                   default="flagship")
    p.add_argument("--vocab-size", type=int, default=0)
    # no --moe-experts: the HF InternVL-2 layout has no routed-expert
    # tensors, and an MoE state dict is refused
    p.add_argument("--dtype", choices=_DTYPE_NAMES, default="bfloat16")
    p.add_argument("--shard-gb", type=float, default=4.0,
                   help="max shard size in GB (HF-style index written "
                        "when more than one shard)")
    p.add_argument("--device", default="cuda")
    p.set_defaults(fn=cmd_export_checkpoint)

    p = sub.add_parser("train",
                       help="SFT on a data-mixture meta JSON -> rolling "
                            "torch checkpoints (one device)")
    p.add_argument("--meta", required=True,
                   help="InternVL-style mixture meta JSON")
    p.add_argument("--config", choices=("flagship", "bench", "tiny"),
                   default="flagship")
    p.add_argument("--device", default="cuda")
    p.add_argument("--tokenizer", default=None,
                   help="HF tokenizer.json (default: builtin word-level)")
    p.add_argument("--vocab-size", type=int, default=0)
    p.add_argument("--init-checkpoint", default=None,
                   help="params to start from: a torch.save'd state dict "
                        "or a previous train save")
    p.add_argument("--resume", action="store_true",
                   help="also restore the optimizer state and step from "
                        "--init-checkpoint (a train save)")
    p.add_argument("--output", default=None,
                   help="checkpoint root: rolling step_N dirs + LATEST "
                        "pointer (crash-safe; restore resolves it)")
    p.add_argument("--save-every", type=int, default=0)
    p.add_argument("--keep", type=int, default=2,
                   help="rolling checkpoints retained under --output")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--seq-len", type=int, default=4096)
    p.add_argument("--max-tiles", type=int, default=14,
                   help="tile budget per sample across all frames")
    p.add_argument("--tiles-per-image", type=int, default=6,
                   help="dynamic-tiling cap per frame")
    p.add_argument("--packed", action="store_true",
                   help="sequence-packed rows (segment_ids/positions)")
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--warmup", type=int, default=100)
    p.add_argument("--accum", type=int, default=1,
                   help="gradient-accumulation microbatches")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--prefetch", type=int, default=2,
                   help="batches assembled ahead in a producer thread "
                        "(0 = synchronous)")
    p.add_argument("--validate-only", action="store_true",
                   help="schema-check every record + open sampled images, "
                        "print the report, and exit (nonzero on issues)")
    p.add_argument("--validate-sample", type=int, default=200)
    p.add_argument("--data-shard", type=int, default=0)
    p.add_argument("--data-num-shards", type=int, default=1)
    _add_moe_flags(p, group=True)
    p.add_argument("--lora-rank", type=int, default=0,
                   help="adapter-only training (0 = full finetune); saves "
                        "MERGED params; on the flagship the LLM recomputes "
                        "each layer in the backward (remat)")
    p.add_argument("--async-save", action="store_true",
                   help="overlap checkpoint writes with training (LATEST "
                        "flips only after a write finishes)")
    p.add_argument("--trace-dir", default=None,
                   help="torch.profiler trace dir for the training steps")
    p.add_argument("--eval-jsonl", default=None,
                   help="held-out eval records: scored after training and "
                        "every --eval-every steps (accuracy in the log and "
                        "summary)")
    p.add_argument("--eval-every", type=int, default=0)
    p.add_argument("--eval-images-root", default=".")
    p.add_argument("--eval-limit", type=int, default=0)
    p.add_argument("--eval-max-new-tokens", type=int, default=24)
    p.add_argument("--mc-logprob", action="store_true",
                   help="score MC eval records by candidate logprob")
    # the mesh (one process a device, launched by torch.distributed.run)
    p.add_argument("--data-parallel", type=int, default=0,
                   help="data axis (0: the processes the other axes leave)")
    p.add_argument("--model-parallel", type=int, default=1,
                   help="tensor-parallel (Megatron) axis")
    p.add_argument("--seq-parallel", type=int, default=1,
                   help="sequence axis (ring attention)")
    p.add_argument("--expert-parallel", type=int, default=1,
                   help="expert axis (MoE tables; --moe-impl einsum)")
    p.add_argument("--fsdp", action="store_true",
                   help="also shard large parameters over the data axis")
    p.set_defaults(fn=cmd_train)
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
