"""MultiSPA evaluation harness: score model answers against eval JSONL.

The reference provides no scorer in-repo (model eval is delegated with the
training stack, README.md:194-200); this implements the MultiSPA metric
conventions implied by the data: numeric answers scored by relative-error
tolerance, multiple-choice by letter match, qualitative directions by word
match, vectors per-component. Answers are extracted from free-form model
text the same way the data embeds them (backtick-quoted values in the
assistant turns, e.g. "`1150`", "`[ 10 , -5 , 3 ]`", "`left`", "`A`").
"""

from __future__ import annotations

import dataclasses
import re
from typing import Iterable

import numpy as np

DIRECTION_WORDS = {
    "left", "right", "up", "down", "forward", "backward",
}
LETTERS = {"A", "B", "C", "D"}

_BACKTICK = re.compile(r"`([^`]*)`")
_NUMBER = re.compile(r"-?\d+(?:\.\d+)?")


def extract_answer(text: str):
    """Best-effort extraction of the answer payload from model output.

    Priority: last backtick-quoted span; else last bracketed triple; else
    last number; else a direction word; else a bare letter.
    Returns one of: float, [float, float, ...], str, or None.
    """
    spans = _BACKTICK.findall(text)
    candidates = spans[::-1] if spans else [text]
    for cand in candidates:
        cand = cand.strip()
        if cand in LETTERS:
            return cand
        low = cand.lower()
        if low in DIRECTION_WORDS:
            return low
        nums = _NUMBER.findall(cand)
        if "[" in cand and len(nums) >= 2:
            return [float(v) for v in nums]
        if len(nums) == 1 and cand == nums[0]:
            return float(nums[0])
    # fall back to scanning the full text
    low_words = set(re.findall(r"[a-z]+", text.lower()))
    hit = low_words & DIRECTION_WORDS
    if len(hit) == 1:
        return next(iter(hit))
    nums = _NUMBER.findall(text)
    if "[" in text and len(nums) >= 3:
        return [float(v) for v in nums[-3:]]
    if nums:
        return float(nums[-1])
    letters = [w for w in re.findall(r"\b[A-D]\b", text)]
    if letters:
        return letters[-1]
    return None


@dataclasses.dataclass
class ScoreConfig:
    # |pred - gt| <= rel_tol * |gt| counts as correct for numeric answers
    # (plus an absolute floor for near-zero ground truths).
    #
    # These defaults (10% relative, 10 mm floor) are THIS REPO'S scoring
    # convention, not values from the Multi-SpatialMLLM paper — the
    # paper reports accuracy per benchmark with its own per-task
    # protocols; override per evaluation when reproducing a published
    # number.
    rel_tol: float = 0.10
    abs_floor: float = 10.0  # mm


def question_kind(question_type: str) -> str:
    qt = question_type
    if qt in ("x_movement", "y_movement", "z_movement", "yaw_movement",
              "pitch_movement"):
        return "direction"
    if qt in ("depth_comparison_annotated",
              "visual_correspondence_multiple_choice"):
        return "letter"
    if qt in ("displacement_vector", "tapvid3d_displacement_vector",
              "depth_comparison_coordinate",
              "visual_correspondence_coor_2_coor"):
        return "vector"
    return "numeric"  # distances, angles, depths, dimensions


def score_sample(sample: dict, prediction, config: ScoreConfig | None = None
                 ) -> bool:
    """True if `prediction` (raw text or already-extracted value) matches
    the sample's gt_value under its question type's metric."""
    config = config or ScoreConfig()
    if isinstance(prediction, str):
        prediction = extract_answer(prediction)
    if prediction is None:
        return False
    gt = sample["gt_value"]
    kind = question_kind(sample["question_type"])
    if kind == "direction":
        return isinstance(prediction, str) and prediction.lower() == str(gt).lower()
    if kind == "letter":
        return isinstance(prediction, str) and prediction.upper() == str(gt).upper()
    if kind == "vector":
        if not isinstance(prediction, (list, tuple)):
            return False
        gt_arr = np.asarray(gt, dtype=np.float64)
        pred = np.asarray(prediction, dtype=np.float64)
        if pred.shape != gt_arr.shape:
            return False
        # Displacement-vector gt_value is stored in METERS (engine record
        # parity: camera_movement.py emits the raw disp floats,
        # object_movement.py ":393 vector stored in meters") while the
        # answer templates always phrase the vector in integer mm — so the
        # gt is rescaled unconditionally for these two question types.
        if sample["question_type"] in ("displacement_vector",
                                       "tapvid3d_displacement_vector"):
            gt_arr = gt_arr * 1000.0
        tol = np.maximum(config.rel_tol * np.abs(gt_arr), config.abs_floor)
        return bool(np.all(np.abs(pred - gt_arr) <= tol))
    # numeric
    if isinstance(prediction, (list, tuple)):
        return False
    try:
        pred = float(prediction)
        gt_val = float(gt)
    except (TypeError, ValueError):
        return False
    tol = max(config.rel_tol * abs(gt_val), config.abs_floor)
    return abs(pred - gt_val) <= tol


def evaluate(samples: Iterable[dict], predictions: Iterable,
             config: ScoreConfig | None = None) -> dict:
    """Aggregate accuracy overall and per question_type."""
    config = config or ScoreConfig()
    per_type: dict[str, list[bool]] = {}
    for sample, pred in zip(samples, predictions):
        ok = score_sample(sample, pred, config)
        per_type.setdefault(sample["question_type"], []).append(ok)
    all_results = [r for v in per_type.values() for r in v]
    return {
        "accuracy": float(np.mean(all_results)) if all_results else 0.0,
        "count": len(all_results),
        "per_type": {
            k: {"accuracy": float(np.mean(v)), "count": len(v)}
            for k, v in sorted(per_type.items())
        },
    }
