"""MultiSPA evaluation runner: model x eval JSONL -> predictions + scores.
Port of multi_spatialmllm_tpu/models/runner.py.

Reads the eval records the engines write (`text`, image list, gt_value),
builds prompts with the vision tokens expanded, greedy-decodes the answers
(one prompt at a time, in batches with per-row prompt lengths, with
prompt-lookup speculation, or through a continuous or paged batcher), or
scores multiple-choice records by each option's teacher-forced
log-probability, and scores everything with models/eval_harness.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable

import numpy as np
import torch

from .data import DataConfig
from .eval_harness import ScoreConfig, evaluate
from .generate import (
    greedy_generate_batched,
    model_device,
    pad_to_bucket,
    speculative_generate,
)
from .mllm import MLLMConfig, MultiFrameMLLM
from .preprocess import tile_image
from .tokenizer import ASSISTANT, HUMAN, IMG_CONTEXT, IMG_END, IMG_START


@dataclasses.dataclass
class EvalRunConfig:
    max_new_tokens: int = 24
    length_bucket: int = 128
    speculate: int = 0      # >0: prompt-lookup speculation, greedy-exact
    mc_logprob: bool = False  # score multiple-choice records by option
    #   log-probability instead of decoding
    data: DataConfig = dataclasses.field(default_factory=DataConfig)


def build_prompt_ids(sample: dict, tokenizer, model_cfg: MLLMConfig,
                     tiles_per_image: list[int]) -> list[int]:
    """Eval prompt: human turn with vision blocks + assistant cue."""
    text = sample["text"]
    img_idx = 0
    while "<image>" in text:
        n_ctx = model_cfg.tokens_per_tile * tiles_per_image[img_idx]
        text = text.replace(
            "<image>", IMG_START + IMG_CONTEXT * n_ctx + IMG_END, 1)
        img_idx += 1
    return [tokenizer.bos_id] + tokenizer.encode(HUMAN + text + ASSISTANT)


def _tiles(sample: dict, image_loader: Callable, config: EvalRunConfig,
           device):
    """The sample's tiles `[n, H, W, 3]` for a model on `device` and the
    tile count per image."""
    stacks = [tile_image(image_loader(p), config.data.preprocess, device)
              for p in sample["image"]]
    return np.concatenate(stacks, axis=0), [s.shape[0] for s in stacks]


def _decode_batched(model, prompt, tiles, lens, eos_id,
                    config: EvalRunConfig) -> np.ndarray:
    """Greedy decode, through speculation when asked (same tokens)."""
    if config.speculate > 0:
        out = speculative_generate(
            model, prompt, tiles, max_new_tokens=config.max_new_tokens,
            eos_id=eos_id, prompt_lens=lens, n_draft=config.speculate)
    else:
        out = greedy_generate_batched(
            model, prompt, tiles, lens,
            max_new_tokens=config.max_new_tokens, eos_id=eos_id)
    return out.cpu().numpy()


def _decode_row(gen: np.ndarray, eos_id: int) -> np.ndarray:
    if eos_id in gen:
        gen = gen[: int(np.where(gen == eos_id)[0][0])]
    return gen


def predict_sample(model: MultiFrameMLLM, tokenizer, sample: dict,
                   image_loader: Callable[[str], np.ndarray],
                   config: EvalRunConfig) -> str:
    """One record's decoded answer."""
    tiles, per_image = _tiles(sample, image_loader, config,
                               model_device(model))
    ids = build_prompt_ids(sample, tokenizer, model.cfg, per_image)
    prompt = pad_to_bucket(np.asarray([ids], dtype=np.int32),
                           config.length_bucket, tokenizer.pad_id)
    out = _decode_batched(model, prompt, tiles[None],
                          np.asarray([len(ids)]), tokenizer.eos_id, config)
    return tokenizer.decode(_decode_row(out[0], tokenizer.eos_id))


def predict_batch(model: MultiFrameMLLM, tokenizer, samples: list[dict],
                  image_loader: Callable[[str], np.ndarray],
                  config: EvalRunConfig) -> list[str]:
    """Batched greedy decoding with per-row prompt lengths: rows grouped
    by tile-stack shape and length bucket, one prefill and decode a group;
    each answer equals `predict_sample`'s."""
    prepped = []
    for s in samples:
        tiles, per_image = _tiles(s, image_loader, config,
                                  model_device(model))
        prepped.append((tiles, build_prompt_ids(s, tokenizer, model.cfg,
                                                per_image)))
    predictions: list[str | None] = [None] * len(samples)
    groups: dict[tuple, list[int]] = {}
    for i, (tiles, ids) in enumerate(prepped):
        bucket_len = ((len(ids) + config.length_bucket - 1)
                      // config.length_bucket) * config.length_bucket
        groups.setdefault((tiles.shape, bucket_len), []).append(i)
    for (_, bucket_len), rows in groups.items():
        lens = np.asarray([len(prepped[i][1]) for i in rows])
        prompt = np.full((len(rows), bucket_len), tokenizer.pad_id,
                         dtype=np.int32)
        for r, i in enumerate(rows):
            prompt[r, : lens[r]] = prepped[i][1]
        tiles = np.stack([prepped[i][0] for i in rows])
        out = _decode_batched(model, prompt, tiles, lens, tokenizer.eos_id,
                              config)
        for r, i in enumerate(rows):
            predictions[i] = tokenizer.decode(
                _decode_row(out[r], tokenizer.eos_id))
    return predictions


def mc_candidates(sample: dict) -> list[str] | None:
    """Candidate answers of a multiple-choice record: its own "options"
    when present, else the letter bank of its question type (the MC
    engines' answer format; gt_value is the correct letter). None for
    other records."""
    if "options" in sample:
        opts = [str(o) for o in sample["options"]]
        return opts or None          # empty options list -> not MC
    qt = sample.get("question_type", "")
    if qt == "visual_correspondence_multiple_choice":
        return ["A", "B", "C", "D"]
    if qt == "depth_comparison_annotated":
        return ["A", "B"]
    return None


@torch.no_grad()
def score_candidates(model: MultiFrameMLLM, tokenizer, sample: dict,
                     candidates: list[str],
                     image_loader: Callable[[str], np.ndarray],
                     config: EvalRunConfig) -> np.ndarray:
    """Teacher-forced sum log-probability (float32) of each candidate
    continuation after the sample's prompt: one `[n_candidates, T]`
    forward (flash attention, no cache), the ViT run once over the shared
    tiles and its features spliced into every row."""
    tiles, per_image = _tiles(sample, image_loader, config,
                               model_device(model))
    ids = build_prompt_ids(sample, tokenizer, model.cfg, per_image)
    cand_ids = [tokenizer.encode(c) for c in candidates]
    if not all(cand_ids):
        raise ValueError(f"a candidate encodes to no token: {candidates}")
    k = max(len(ci) for ci in cand_ids)
    n = len(candidates)
    bucket = config.length_bucket
    t = ((len(ids) + k + bucket - 1) // bucket) * bucket
    rows = np.full((n, t), tokenizer.pad_id, dtype=np.int64)
    cand_tok = np.zeros((n, k), dtype=np.int64)
    cand_mask = np.zeros((n, k), dtype=np.float32)
    for r, ci in enumerate(cand_ids):
        rows[r, : len(ids)] = ids
        rows[r, len(ids): len(ids) + len(ci)] = ci
        cand_tok[r, : len(ci)] = ci
        cand_mask[r, : len(ci)] = 1.0
    dev = model_device(model)
    vis = model.encode_tiles(torch.as_tensor(tiles, device=dev))
    x = model.splice(torch.as_tensor(rows, device=dev),
                     vis.reshape(1, -1, vis.shape[-1]))
    positions = torch.arange(t, device=dev).expand(n, t)
    logits, _ = model.llm(x, positions, inference=False)
    logp = torch.log_softmax(logits.float(), dim=-1)
    pos = len(ids) - 1 + torch.arange(k, device=dev)
    tok = torch.gather(logp[:, pos], 2,
                       torch.as_tensor(cand_tok, device=dev)[..., None])
    mask = torch.as_tensor(cand_mask, device=dev)
    return (tok[..., 0] * mask).sum(dim=1).cpu().numpy()


def predict_with_batcher(batcher, tokenizer, samples: list[dict],
                         image_loader: Callable[[str], np.ndarray],
                         config: EvalRunConfig):
    """Serve an eval campaign through a continuous or paged batcher (its
    own config governs max_new_tokens and decoding). Returns (texts,
    confidences): per sample the mean token logprob of its answer when the
    batcher records logprobs (None for an empty answer), else None."""
    if batcher.eos_id != tokenizer.eos_id:
        raise ValueError(f"the batcher stops at {batcher.eos_id}, the "
                         f"tokenizer's eos is {tokenizer.eos_id}")
    requests = []
    for s in samples:
        tiles, per_image = _tiles(s, image_loader, config, batcher.device)
        ids = build_prompt_ids(s, tokenizer, batcher.model.cfg, per_image)
        requests.append((np.asarray(ids, dtype=np.int32), tiles))
    outs = batcher.generate_all(requests)     # stop-cut, request order
    confs = None
    if getattr(batcher.config, "logprobs", False):
        lps = batcher.request_logprobs
        confs = [float(np.mean(lps[rid])) if lps.get(rid) else None
                 for rid in range(len(requests))]
    return [tokenizer.decode(np.asarray(o)) for o in outs], confs


def run_eval(model: MultiFrameMLLM, tokenizer, samples: Iterable[dict],
             image_loader: Callable[[str], np.ndarray],
             config: EvalRunConfig | None = None,
             score_config: ScoreConfig | None = None, batch_size: int = 1,
             batcher=None) -> dict:
    """Decode (or, with `mc_logprob`, score the options of) every sample
    and return eval_harness's aggregates with the raw predictions under
    "predictions". `batch_size > 1` decodes in batches; `batcher` serves
    the decoded records through a batcher instead. A batcher recording
    logprobs adds "confidences" (per sample, None for scored records and
    empty answers) and their mean, "mean_token_logprob"."""
    config = config or EvalRunConfig()
    samples = list(samples)
    batcher_confs: list | None = None

    def decode_all(subset: list[dict]) -> list[str]:
        nonlocal batcher_confs
        if not subset:
            return []
        if batcher is not None:
            texts, batcher_confs = predict_with_batcher(
                batcher, tokenizer, subset, image_loader, config)
            return texts
        if batch_size <= 1:
            return [predict_sample(model, tokenizer, s, image_loader,
                                   config) for s in subset]
        out: list[str] = []
        for lo in range(0, len(subset), batch_size):
            out.extend(predict_batch(model, tokenizer,
                                     subset[lo: lo + batch_size],
                                     image_loader, config))
        return out

    mc_set = ({i for i, s in enumerate(samples)
               if mc_candidates(s) is not None}
              if config.mc_logprob else set())
    rest_pred = iter(decode_all(
        [s for i, s in enumerate(samples) if i not in mc_set]))
    predictions = []
    for i, s in enumerate(samples):
        if i in mc_set:
            cands = mc_candidates(s)
            scores = score_candidates(model, tokenizer, s, cands,
                                      image_loader, config)
            predictions.append(cands[int(np.argmax(scores))])
        else:
            predictions.append(next(rest_pred))
    report = evaluate(samples, predictions, score_config)
    report["predictions"] = predictions
    if batcher_confs is not None:
        conf_iter = iter(batcher_confs)
        confidences = [None if i in mc_set else next(conf_iter)
                       for i in range(len(samples))]
        known = [c for c in confidences if c is not None]
        report["confidences"] = confidences
        report["mean_token_logprob"] = (
            float(np.mean(known)) if known else None)
    return report
