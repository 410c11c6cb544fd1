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

`project_scenes_pipelined` runs the hybrid visibility and the relations of
many scenes as a software pipeline: scene k+1's upload and device work are
queued before the host finalizes scene k.

`compute_relations_multichip` runs the relations scene-parallel over a
mesh's data axis: each process runs its share of each chunk of scenes
through the batched device program, and the processes exchange the
`[I, I]` relation matrices so that every one returns every scene's.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from ..core import geometry as G
from ..core.io import WarningSink, write_parquet
from ..core.scene import Scene
from .visibility import (
    _fetch_async,
    _hybrid_dispatch,
    _hybrid_finalize,
    _ready,
    _upload,
    compute_scene_visibility,
    exchange,
    iter_packed_scene_batches,
)

COLUMNS = ("scene_id", "image_id1", "image_id2", "overlap", "distance",
           "yaw", "pitch")


def _unpack_bits(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Device-side inverse of numpy.packbits(axis=-1) (big-endian bit
    order), sliced back to `n` columns."""
    shifts = torch.arange(7, -1, -1, dtype=packed.dtype, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], -1)[..., :n].to(torch.bool)


def _relations_dispatch(packed: np.ndarray, extrinsics: np.ndarray,
                        image_valid: np.ndarray, n: int, device,
                        stream=None):
    """Upload a packed `[..., I, n/8]` visibility block and its poses
    (through `stream`, see visibility._upload), queue the relations on
    `device` and their copies to the host; returns what `_relations_fetch`
    reads."""
    dev = torch.device(device)
    packed_d, ext_d, iv_d = _upload([packed, extrinsics, image_valid], dev,
                                    stream)
    rel = G.pairwise_frame_relations(_unpack_bits(packed_d, n), ext_d, iv_d)
    return {k: _fetch_async(v) for k, v in rel.items()}, _ready(dev)


def _relations_fetch(pending) -> dict[str, np.ndarray]:
    """`{relation: [..., I, I]}` of a `_relations_dispatch`, once there."""
    rel, ready = pending
    if ready is not None:
        ready.synchronize()
    return {k: v.numpy() for k, v in rel.items()}


def _relations(packed: np.ndarray, extrinsics: np.ndarray,
               image_valid: np.ndarray, n: int, device):
    """Run the relations of a packed visibility block on `device` and
    fetch `{relation: [..., I, I]}`."""
    return _relations_fetch(_relations_dispatch(packed, extrinsics,
                                                image_valid, n, device))


def compute_relations_multichip(
    scenes: "list[Scene]",
    mesh,
    visibility: "dict[str, np.ndarray]",
    dtype=np.float64,
    per_device_batch: int = 4,
    device="cuda",
) -> "dict[str, dict[str, np.ndarray]]":
    """Scene-parallel frame relations over the mesh's data axis; returns
    `{scene_id: {relation: [I, I]}}` for every scene on every process,
    equal to `compute_scene_relations` scene by scene. Each process runs
    its share of each padded-shape chunk
    (`visibility.iter_packed_scene_batches`) on `device` in one dispatch,
    then the processes exchange the matrices (one `all_gather_object` a
    chunk)."""
    group = mesh.get_group(mesh.mesh_dim_names[0])
    out: dict[str, dict[str, np.ndarray]] = {}
    for i_pad, n_pad, mine, packed in iter_packed_scene_batches(
            scenes, mesh, visibility, per_device_batch):
        local = {}
        if mine:
            exts = np.empty((len(mine), i_pad, 4, 4), dtype=dtype)
            ivalid = np.empty((len(mine), i_pad), dtype=bool)
            for j, scene in enumerate(mine):
                exts[j], _, ivalid[j] = scene.padded_images(dtype)
            rel = _relations(packed, exts, ivalid, n_pad, device)
            for j, scene in enumerate(mine):
                n = scene.num_images
                local[scene.scene_id] = {k: v[j, :n, :n]
                                         for k, v in rel.items()}
        out.update(exchange(local, group))
    return out


def _dispatch_scene_relations(scene: Scene, vis: np.ndarray, dtype, device,
                              stream=None):
    """Queue one scene's relations; shared by `compute_scene_relations`
    and `project_scenes_pipelined`, so the two cannot drift (padding,
    bit packing)."""
    ext, _, ivalid = scene.padded_images(dtype)
    i_pad = ext.shape[0]
    vis_pad = np.zeros((i_pad, vis.shape[1]), dtype=bool)
    vis_pad[: vis.shape[0]] = vis
    return _relations_dispatch(np.packbits(vis_pad, axis=1), ext, ivalid,
                               vis.shape[1], device, stream)


def _scene_relations_fetch(scene: Scene, pending) -> dict[str, np.ndarray]:
    n = scene.num_images
    return {k: v[:n, :n] for k, v in _relations_fetch(pending).items()}


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
    return _scene_relations_fetch(
        scene, _dispatch_scene_relations(scene, vis, dtype, device))


def project_scenes_pipelined(scenes: "list[Scene]", dtype=np.float32,
                             with_relations: bool = True, device="cuda"):
    """Hybrid visibility and frame relations over many scenes as a
    software pipeline; yields `(scene, vis, rel)` in input order (`rel`
    None when `with_relations` is False), equal to the sequential loop of
    `compute_scene_visibility_hybrid` and `compute_scene_relations`.

    Scene k+1's upload and hybrid chunks are queued before scene k is
    finalized, so the host's fetch and float64 fix-up of scene k overlap
    the device's work on scene k+1; a scene's relations are queued after
    its finalize and fetched one scene later, after the next scene's
    chunks. On a CUDA device the uploads go through pinned memory on a
    side stream that the compute stream waits for by an event, and every
    fetch is a non-blocking copy into pinned memory behind an event, so
    the host never waits on the stream to queue more. On the CPU the same
    code runs in sequence."""
    dev = torch.device(device)
    stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    hyb_pending = None   # (scene, hybrid handles)
    rel_pending = None   # (scene, vis, queued relations)
    for scene in [*scenes, None]:      # None: drain the pipeline
        dispatched = None if scene is None else (
            scene, _hybrid_dispatch(scene, device=dev, stream=stream))
        if hyb_pending is not None:
            s0, h0 = hyb_pending
            vis0 = _hybrid_finalize(s0, h0)
            if not with_relations:
                yield s0, vis0, None
            else:
                if rel_pending is not None:
                    s1, v1, r1 = rel_pending
                    yield s1, v1, _scene_relations_fetch(s1, r1)
                rel_pending = (s0, vis0, _dispatch_scene_relations(
                    s0, vis0, dtype, dev, stream))
        hyb_pending = dispatched
    if rel_pending is not None:
        s1, v1, r1 = rel_pending
        yield s1, v1, _scene_relations_fetch(s1, r1)


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
