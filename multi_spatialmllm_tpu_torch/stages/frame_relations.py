"""Stage: pairwise frame relations (overlap / distance / yaw / pitch), the
port of multi_spatialmllm_tpu/stages/frame_relations.py.

Each scene's pair block is computed on the device: the packed visibility
matrix is uploaded and unpacked there, intersections are one f32 product
`V @ V^T` (TF32 off), unions come by inclusion-exclusion, and the
yaw/pitch/distance difference matrices are broadcast subtractions
(core/geometry.pairwise_frame_relations).

The relation table is a dict of numpy columns `scene_id, image_id1,
image_id2, overlap, distance, yaw, pitch` (the JAX stage's DataFrame
columns, in order; strings as object arrays): the camera-movement engine
reads it as it reads the DataFrame. Pairs are the upper triangle (i < j)
over valid-pose images in sorted id order. The parquet file and its
`_nonzero` companion are written through pandas and pyarrow, imported at
the write, as the JAX stage writes them; `parquet_unavailable()` says
whether this host can.

Not ported yet (ROADMAP.md, queue 1): `project_scenes_pipelined` and the
scene-parallel multi-device stage.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from ..core import geometry as G
from ..core.io import WarningSink, write_parquet
from ..core.scene import Scene
from .visibility import compute_scene_visibility

COLUMNS = ("scene_id", "image_id1", "image_id2", "overlap", "distance",
           "yaw", "pitch")


def _unpack_bits(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Device-side inverse of numpy.packbits(axis=-1) (big-endian bit
    order), sliced back to `n` columns."""
    shifts = torch.arange(7, -1, -1, dtype=packed.dtype, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], -1)[..., :n].to(torch.bool)


def _relations(packed: np.ndarray, extrinsics: np.ndarray,
               image_valid: np.ndarray, n: int, device):
    """Upload a packed `[..., I, n/8]` visibility block and its poses, run
    the relations on `device` and fetch `{relation: [..., I, I]}`."""
    dev = torch.device(device)
    vis = _unpack_bits(torch.from_numpy(packed).to(dev), n)
    rel = G.pairwise_frame_relations(
        vis, torch.from_numpy(extrinsics).to(dev),
        torch.from_numpy(image_valid).to(dev))
    return {k: v.cpu().numpy() for k, v in rel.items()}


def compute_scene_relations(
    scene: Scene,
    vis: np.ndarray | None = None,
    dtype=np.float64,
    device="cuda",
) -> dict[str, np.ndarray]:
    """`[I, I]` relation matrices for one scene (rows/cols =
    scene.image_ids), computed on `device`."""
    if vis is None:
        vis = compute_scene_visibility(scene, dtype, device=device)
    ext, _, ivalid = scene.padded_images(dtype)
    i_pad = ext.shape[0]
    vis_pad = np.zeros((i_pad, vis.shape[1]), dtype=bool)
    vis_pad[: vis.shape[0]] = vis
    rel = _relations(np.packbits(vis_pad, axis=1), ext, ivalid,
                     vis.shape[1], device)
    n = scene.num_images
    return {k: v[:n, :n] for k, v in rel.items()}


def scene_relation_records(
    scene: Scene,
    rel: dict[str, np.ndarray],
    warning_sink: WarningSink | None = None,
) -> dict[str, np.ndarray]:
    """Flatten matrices to the reference's row schema (valid pairs, i < j)."""
    valid = scene.valid_image_mask()
    idx = np.where(valid)[0]
    ids = np.asarray(scene.image_ids)
    a, b = np.triu_indices(len(idx), k=1)
    ia, ib = idx[a], idx[b]
    overlap = rel["overlap"][ia, ib]
    distance = rel["distance"][ia, ib]
    yaw = rel["yaw"][ia, ib]
    pitch = rel["pitch"][ia, ib]
    if warning_sink is not None:
        bad = ~(
            np.isfinite(overlap) & np.isfinite(distance)
            & np.isfinite(yaw) & np.isfinite(pitch)
        )
        for k in np.where(bad)[0]:
            warning_sink(
                f"{scene.scene_id}: ({ids[ia[k]]}, {ids[ib[k]]}) has something "
                f"wrong {[overlap[k], distance[k], yaw[k], pitch[k]]}."
            )
    return {
        "scene_id": np.full(len(a), scene.scene_id, dtype=object),
        "image_id1": ids[ia],
        "image_id2": ids[ib],
        "overlap": overlap,
        "distance": distance,
        "yaw": yaw,
        "pitch": pitch,
    }


def _batched_scene_relations(
    scenes: "list[Scene]",
    visibility: dict,
    dtype,
    batch_size: int = 10,
    device="cuda",
) -> "dict[str, dict[str, np.ndarray]]":
    """Relations for many scenes, `batch_size` scenes of one padded shape
    per dispatch (the grouping of compute_visibility_batch)."""
    groups: dict[tuple, list[Scene]] = {}
    for scene in scenes:
        ext, _, _ = scene.padded_images(dtype)
        vis = visibility[scene.scene_id]
        n_pad = ((max(vis.shape[1], 1) + 127) // 128) * 128
        groups.setdefault((ext.shape[0], n_pad), []).append(scene)

    out: dict[str, dict[str, np.ndarray]] = {}
    for (i_pad, n_pad), members in groups.items():
        for lo in range(0, len(members), batch_size):
            chunk = members[lo: lo + batch_size]
            s = len(chunk)
            vis_pad = np.zeros((s, i_pad, n_pad), dtype=bool)
            exts = np.tile(np.eye(4, dtype=dtype), (s, i_pad, 1, 1))
            ivalid = np.zeros((s, i_pad), dtype=bool)
            for j, scene in enumerate(chunk):
                v = visibility[scene.scene_id]
                vis_pad[j, : v.shape[0], : v.shape[1]] = v
                exts[j], _, ivalid[j] = scene.padded_images(dtype)
            rel = _relations(np.packbits(vis_pad, axis=2), exts, ivalid,
                             n_pad, device)
            for j, scene in enumerate(chunk):
                n = scene.num_images
                out[scene.scene_id] = {
                    k: v[j, :n, :n] for k, v in rel.items()}
    return out


def parquet_unavailable() -> str | None:
    """None when pandas and pyarrow import here (the parquet writer's
    needs), else why not."""
    try:
        import pandas  # noqa: F401
        import pyarrow  # noqa: F401
    except ImportError as e:
        return str(e)
    return None


def build_frame_relations(
    scenes: Iterable[Scene],
    output_parquet: str | None = None,
    warning_path: str | None = None,
    dtype=np.float64,
    visibility: "dict[str, np.ndarray] | None" = None,
    device="cuda",
) -> dict[str, np.ndarray]:
    """Run the stage over scenes on `device`; returns the relation table.

    Writes `output_parquet` and the `_nonzero` companion when a path is
    given (nonzero keeps `overlap != 0`). With precomputed `visibility`,
    scenes dispatch in shape-grouped batches.
    """
    sink = WarningSink(warning_path)
    scenes = list(scenes)
    if visibility is not None and all(
            s.scene_id in visibility for s in scenes):
        rels = _batched_scene_relations(scenes, visibility, dtype,
                                        device=device)
        records = [scene_relation_records(scene, rels[scene.scene_id], sink)
                   for scene in scenes]
    else:
        records = []
        for scene in scenes:
            vis = (None if visibility is None
                   else visibility.get(scene.scene_id))
            rel = compute_scene_relations(scene, vis=vis, dtype=dtype,
                                          device=device)
            records.append(scene_relation_records(scene, rel, sink))
    if output_parquet:
        _write_parquet(records, output_parquet)
    return _relations_table(records)


def _relations_table(records: list) -> dict[str, np.ndarray]:
    """The per-scene records concatenated: string columns as object
    arrays, float columns in the stage's dtype."""
    if not records:
        return {c: np.zeros(0, dtype=object if c in COLUMNS[:3]
                            else np.float64) for c in COLUMNS}
    table = {c: np.concatenate([r[c] for r in records]) for c in COLUMNS}
    for c in COLUMNS[:3]:
        table[c] = table[c].astype(object)
    return table


def _write_parquet(records: list, output_parquet: str) -> None:
    """The JAX stage's files, built the same way: one DataFrame a scene,
    concatenated, and the `overlap != 0` rows beside."""
    import pandas as pd

    df = (
        pd.concat([pd.DataFrame(r) for r in records], ignore_index=True)
        if records
        else pd.DataFrame(columns=list(COLUMNS))
    )
    write_parquet(df, output_parquet)
    nonzero = df[df["overlap"] != 0.0]
    write_parquet(
        nonzero, output_parquet.replace(".parquet", "_nonzero.parquet")
    )
