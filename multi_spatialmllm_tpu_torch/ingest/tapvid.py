"""TAPVid-3D ingestion (L1, object-movement source data).

The reference consumes official npz files directly
(single_object_movement_engine_coord.py:415-444) and ships split lists
under `data/tapvid3d_dataset/meta_data/{adt,pstudio}/{train,val}.txt`
(SURVEY.md §2 #25: adt 1,647/309, pstudio 131/25 scenes). This module
loads/validates those records and split lists.
"""

from __future__ import annotations

import os

import numpy as np

REQUIRED_KEYS = ("images_jpeg_bytes", "fx_fy_cx_cy", "tracks_XYZ",
                 "visibility")
SUB_DATASETS = ("adt", "pstudio")

# The split-id lists themselves are VENDORED as data (they originate
# from the public TAPVid-3D benchmark release; see
# data/tapvid3d_meta/README.md for provenance) so the repo is
# self-contained — a user-supplied meta_data dir still works.
VENDORED_META_DIR = os.path.normpath(os.path.join(
    os.path.dirname(__file__), "..", "..", "data", "tapvid3d_meta"))

# (sub_dataset, split) -> expected scene count (SURVEY.md §2 #25)
EXPECTED_SPLIT_COUNTS = {("adt", "train"): 1647, ("adt", "val"): 309,
                         ("pstudio", "train"): 131, ("pstudio", "val"): 25}


def load_split_list(meta_data_dir: str | None, sub_dataset: str,
                    split: str) -> list[str]:
    """Scene-id list from `{meta}/{sub}/{split}.txt` (one id per line).

    `meta_data_dir=None` uses the vendored lists; vendored loads are
    count-validated against the reference's published split sizes."""
    vendored = meta_data_dir is None
    if vendored:
        meta_data_dir = VENDORED_META_DIR
    path = os.path.join(meta_data_dir, sub_dataset, f"{split}.txt")
    with open(path) as f:
        ids = [line.strip() for line in f if line.strip()]
    if vendored:
        want = EXPECTED_SPLIT_COUNTS[(sub_dataset, split)]
        if len(ids) != want:  # survives python -O, unlike assert
            raise ValueError(
                f"vendored {sub_dataset}/{split}.txt has {len(ids)} "
                f"ids, expected {want} — corrupted checkout?")
    return ids


def load_record(npz_path: str) -> dict:
    """One TAPVid-3D record as a dict; validates the schema and fills an
    identity `extrinsics_w2c` when absent (the reference treats missing
    extrinsics as camera-frame == world-frame, engine :452-454)."""
    z = np.load(npz_path, allow_pickle=True)
    record = {k: z[k] for k in z.files}
    validate_record(record, npz_path)
    n_frames = record["tracks_XYZ"].shape[0]
    if "extrinsics_w2c" not in record or record["extrinsics_w2c"] is None:
        record["extrinsics_w2c"] = np.tile(np.eye(4), (n_frames, 1, 1))
    return record


def validate_record(record: dict, name: str = "<record>") -> None:
    missing = [k for k in REQUIRED_KEYS if k not in record]
    if missing:
        raise ValueError(f"{name}: missing keys {missing}")
    n_frames, n_points, three = record["tracks_XYZ"].shape
    if three != 3:
        raise ValueError(f"{name}: tracks_XYZ last dim != 3")
    if record["visibility"].shape != (n_frames, n_points):
        raise ValueError(f"{name}: visibility shape mismatch")
    if record["fx_fy_cx_cy"].shape != (4,):
        raise ValueError(f"{name}: fx_fy_cx_cy must be (4,)")
    if len(record["images_jpeg_bytes"]) != n_frames:
        raise ValueError(f"{name}: frame count mismatch")
    if "extrinsics_w2c" in record and record["extrinsics_w2c"] is not None:
        if record["extrinsics_w2c"].shape != (n_frames, 4, 4):
            raise ValueError(f"{name}: extrinsics_w2c shape mismatch")


def load_split_records(base_dir: str, meta_data_dir: str | None,
                       sub_dataset: str, split: str) -> dict[str, dict]:
    """{scene_id: record} for one sub-dataset split."""
    out = {}
    for scene_id in load_split_list(meta_data_dir, sub_dataset, split):
        out[scene_id] = load_record(
            os.path.join(base_dir, sub_dataset, f"{scene_id}.npz"))
    return out
