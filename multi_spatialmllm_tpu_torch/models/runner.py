"""Eval/serving prompt construction (host side)."""

from __future__ import annotations

from .mllm import MLLMConfig
from .tokenizer import ASSISTANT, HUMAN, IMG_CONTEXT, IMG_END, IMG_START


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
