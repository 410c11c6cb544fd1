"""Shared engine machinery: sample schema, eval conversion, writers.

Every reference engine emits InternVL-format multi-image conversation
records and derives eval records by lifting the first human turn into
`text` (`convert_train_sample_to_eval_sample`, e.g.
camera_movement_engine_train_val.py:247-269). This module centralizes that
shape so all engines stay byte-compatible.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np

from ..core.io import write_jsonl

# Keys every train sample must carry (schema parity with e.g.
# camera_movement_engine_train_val.py:234-243).
TRAIN_REQUIRED_KEYS = {
    "id", "image", "conversations", "height_list", "width_list",
    "question_type", "gt_value",
}
EVAL_REQUIRED_KEYS = {
    "id", "image", "text", "height_list", "width_list",
    "question_type", "gt_value",
}


def make_conversation(human: str, gpt: str) -> list[dict]:
    return [
        {"from": "human", "value": human},
        {"from": "gpt", "value": gpt},
    ]


def to_eval_sample(train_sample: dict, keep_conversations: bool = False) -> dict:
    """Lift conversations[0] into `text`.

    Reference parity: camera-movement/object-perception/correspondence
    engines pop `conversations` (camera_movement_engine_train_val.py:266),
    while the four depth engines and object movement keep it
    (depth_estimation_coor_engine.py:289-292,
    single_object_movement_engine_dot.py:655-658) — pass
    keep_conversations=True for those."""
    sample = dict(train_sample)
    if keep_conversations:
        conversation = sample["conversations"]
    else:
        conversation = sample.pop("conversations")
    sample["text"] = conversation[0]["value"]
    return sample


def validate_train_sample(sample: dict) -> list[str]:
    """Schema check; returns a list of problems (empty = valid)."""
    problems = []
    missing = TRAIN_REQUIRED_KEYS - sample.keys()
    if missing:
        problems.append(f"missing keys: {sorted(missing)}")
        return problems
    conv = sample["conversations"]
    if not (isinstance(conv, list) and len(conv) >= 2):
        problems.append("conversations must have >= 2 turns")
    else:
        if conv[0].get("from") != "human" or conv[1].get("from") != "gpt":
            problems.append("conversation roles must alternate human/gpt")
        n_imgs = sum(
            turn["value"].count("<image>") for turn in conv
            if turn.get("from") == "human"
        )
        if n_imgs != len(sample["image"]):
            problems.append(
                f"<image> placeholders ({n_imgs}) != images ({len(sample['image'])})"
            )
    if len(sample["height_list"]) != len(sample["image"]):
        problems.append("height_list length mismatch")
    if len(sample["width_list"]) != len(sample["image"]):
        problems.append("width_list length mismatch")
    return problems


def validate_eval_sample(sample: dict) -> list[str]:
    missing = EVAL_REQUIRED_KEYS - sample.keys()
    return [f"missing keys: {sorted(missing)}"] if missing else []


def shuffle_and_write(
    samples: list[dict], path: str, rng: np.random.Generator
) -> int:
    """Reference flow: shuffle then write one JSON per line
    (e.g. camera_movement_engine_train_val.py:303-308)."""
    order = rng.permutation(len(samples))
    return write_jsonl((samples[i] for i in order), path)


def subsample(samples: list, max_samples: int, rng: np.random.Generator) -> list:
    """`random.sample` semantics: keep all if under the cap."""
    if max_samples is None or max_samples < 0 or len(samples) <= max_samples:
        return samples
    idx = rng.choice(len(samples), size=max_samples, replace=False)
    return [samples[i] for i in idx]


def choice(rng: np.random.Generator, seq: Sequence[Any]) -> Any:
    return seq[int(rng.integers(len(seq)))]


def normalized_coord(value: float, extent: int) -> int:
    """Pixel -> 0-1000 normalized coordinate with banker's rounding
    (reference: `round(px / W * 1000)`, depth_estimation_coor_engine.py
    :216-217). Python round() is round-half-to-even, identical to
    np.round on scalars and ~8x faster in the per-row engine loops."""
    return round(float(value) / extent * 1000)


def mm(value_m: float) -> int:
    """Meters -> rounded millimeters (`round(d * 1000)`)."""
    return round(float(value_m) * 1000)


@dataclasses.dataclass
class EngineOutputs:
    """Bookkeeping returned by every engine run."""

    train_path: str | None = None
    val_path: str | None = None
    n_train: int = 0
    n_val: int = 0
    n_skipped: int = 0
