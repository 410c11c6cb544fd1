"""Stage: minimal image-combination coverage search, the port of
multi_spatialmllm_tpu/stages/coverage.py.

TPU-native replacement for
`spatial_engine/object_perception/single_object_coverage_finder.py` — the
hardest algorithm in the reference (SURVEY.md §7). Hybrid design:

  * Device: per (object, image, axis) min/max coordinate of the visible
    object points — segment reductions over the `[I, N]` visibility matrix,
    one fused program per scene.
  * Host: the breadth-first minimal-set search. Because the coverage of a
    union of images along one axis is just `max(per-image max) - min(
    per-image min)`, the BFS operates on scalar intervals and Python-int
    bitmasks instead of the reference's `[N]`-long boolean masks
    (single_object_coverage_finder.py:97-126) — asymptotically smaller
    state with identical results.

Search semantics parity (single_object_coverage_finder.py:76-220):
tolerance ±10% of target (:38), at most `max_images=5` per combination
(:85), cap of 25 candidate images via random sample (:117-119), suffix
cumulative-union early pruning (:121-126, :183-186 — including the
reference's overshoot behavior where the *full* suffix union must itself
satisfy the ±tolerance window), superset-of-minimal pruning (:131-140),
expansion only by first-layer singletons with larger index (:198-210), and
a 5000-combination cap per level via random sample (:212-214).

The interval precompute runs as torch ops on the device.
`coverage_intervals_multichip` runs it scene-parallel over a mesh's data
axis: each process computes its share of each chunk of scenes, and the
processes exchange the `(mins, maxs, counts)` arrays so that every one
holds every scene's; `build_object_coverage(mesh=...)` then runs the host
search on them, with results equal to the single-device run.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np
import torch

from ..core.io import dump_pickle
from ..core.rng import stream
from ..core.scene import Scene
from .frame_relations import _unpack_bits
from .visibility import compute_scene_visibility, scene_parallel_map

TOLERANCE = 0.1
MAX_IMAGES = 5
MAX_CANDIDATE_IMAGES = 25
MAX_LEVEL_COMBINATIONS = 5000


def _interval_fn(packed: torch.Tensor, instance_ids: torch.Tensor,
                 coords: torch.Tensor, n: int, num_segments: int):
    """For each image and axis: per-object min/max over visible points.

    `packed` = numpy.packbits(vis, axis=1) (big-endian bit order),
    unpacked on the device. An invisible point contributes +inf to the
    minimum and -inf to the maximum, as in the JAX program, into
    destinations filled with +-inf (`include_self=True`), so an empty
    segment is +-inf; an id outside [0, num_segments) is dropped, as
    `jax.ops.segment_min` drops it. Counts are int32."""
    vis = _unpack_bits(packed, n)
    i = vis.shape[0]
    dev = coords.device
    ids = instance_ids.to(torch.int64)
    # out-of-range ids land in one extra segment, cut off below
    ids = torch.where((ids >= 0) & (ids < num_segments), ids, num_segments)
    big = torch.tensor(torch.inf, dtype=coords.dtype, device=dev)
    c = coords.t()[None]                              # [1, 3, N]
    v = vis[:, None, :]                               # [I, 1, N]
    index = ids.expand(i, 3, -1)
    shape = (i, 3, num_segments + 1)
    mins = torch.full(shape, torch.inf, dtype=coords.dtype, device=dev)
    mins.scatter_reduce_(2, index, torch.where(v, c, big), "amin",
                         include_self=True)
    maxs = torch.full(shape, -torch.inf, dtype=coords.dtype, device=dev)
    maxs.scatter_reduce_(2, index, torch.where(v, c, -big), "amax",
                         include_self=True)
    cnt = torch.zeros((i, num_segments + 1), dtype=torch.int32, device=dev)
    cnt.scatter_add_(1, ids.expand(i, -1), vis.to(torch.int32))
    return (mins[..., :num_segments], maxs[..., :num_segments],
            cnt[:, :num_segments])


def object_coverage_intervals(scene: Scene, vis: np.ndarray, device="cuda"):
    """Device precompute on `device`.

    Returns (mins, maxs, counts):
      mins/maxs: `[I, 3, O+1]` float64 per-image per-axis extrema of
        visible points per instance segment (segment 0 = unannotated),
        +-inf when empty;
      counts: `[I, O+1]` int32 visible-point counts.
    """
    dev = torch.device(device)
    packed = np.packbits(np.ascontiguousarray(vis), axis=1)
    out = _interval_fn(
        torch.from_numpy(packed).to(dev),
        torch.from_numpy(scene.instance_ids.astype(np.int32)).to(dev),
        torch.from_numpy(np.ascontiguousarray(
            scene.points_aligned[:, :3], dtype=np.float64)).to(dev),
        vis.shape[1], scene.num_objects + 1)
    return tuple(t.cpu().numpy() for t in out)


def coverage_intervals_multichip(
    scenes: "list[Scene]",
    mesh,
    visibility: "dict[str, np.ndarray]",
    per_device_batch: int = 4,
    device="cuda",
) -> dict:
    """Scene-parallel device precompute for the coverage search over the
    mesh's data axis: `{scene_id: (mins, maxs, counts)}` for every scene
    on every process, equal to `object_coverage_intervals` scene by scene.
    Each process runs `object_coverage_intervals` on `device` for its
    share of each padded-shape chunk and the processes exchange the arrays
    (`visibility.scene_parallel_map`). `{}` for no scenes."""
    return scene_parallel_map(
        scenes, mesh, per_device_batch,
        lambda s: object_coverage_intervals(s, visibility[s.scene_id],
                                            device))


def _covers(lo: float, hi: float, target: float, tolerance: float) -> bool:
    """covers_dimension parity (single_object_coverage_finder.py:68-74)."""
    if not (lo <= hi):  # empty union
        return False
    return abs((hi - lo) - target) <= tolerance * target


def find_minimal_combinations(
    image_ids: Sequence[str],
    lows: np.ndarray,
    highs: np.ndarray,
    target: float,
    rng: np.random.Generator,
    tolerance: float = TOLERANCE,
    max_images: int = MAX_IMAGES,
) -> dict[int, list[tuple]]:
    """BFS over image combinations; returns {k: [image-id tuples of size k]}.

    `lows[i]`/`highs[i]` are image i's coordinate extrema over the object's
    visible points along the chosen axis (+inf/-inf when it sees none).
    """
    valid = list(range(len(image_ids)))
    if len(valid) > MAX_CANDIDATE_IMAGES:
        # reference: random.sample of the image list (:117-119)
        valid = sorted(rng.choice(len(image_ids), MAX_CANDIDATE_IMAGES,
                                  replace=False).tolist())
    n = len(valid)
    lo = np.asarray([lows[i] for i in valid], dtype=np.float64)
    hi = np.asarray([highs[i] for i in valid], dtype=np.float64)

    # Suffix cumulative union intervals (:121-126).
    suf_lo = np.minimum.accumulate(lo[::-1])[::-1]
    suf_hi = np.maximum.accumulate(hi[::-1])[::-1]

    minimal_masks: list[int] = []
    minimal_solutions: dict[int, list[tuple]] = {}
    first_layer: list[tuple] = []  # (idx, lo, hi, bit)

    # level k=1
    current = [((i,), lo[i], hi[i], i, 1 << i) for i in range(n)]
    k = 1
    while k <= max_images and current:
        to_expand = []
        new_minimal = []
        for comb, ulo, uhi, last, bits in current:
            if any((m & bits) == m for m in minimal_masks):
                continue
            if _covers(ulo, uhi, target, tolerance):
                new_minimal.append(bits)
                minimal_solutions.setdefault(k, []).append(
                    tuple(image_ids[valid[i]] for i in comb)
                )
            else:
                if last < n - 1:
                    plo = min(suf_lo[last], ulo)
                    phi = max(suf_hi[last], uhi)
                    if not _covers(plo, phi, target, tolerance):
                        # reference's full-suffix prune (:183-186)
                        continue
                to_expand.append((comb, ulo, uhi, last, bits))
                if k == 1:
                    first_layer.append((comb[0], ulo, uhi, bits))
        minimal_masks.extend(new_minimal)

        next_level = []
        if k < max_images:
            for comb, ulo, uhi, last, bits in to_expand:
                for idx, slo, shi, sbit in first_layer:
                    if idx > last:
                        next_level.append(
                            (comb + (idx,), min(ulo, slo), max(uhi, shi),
                             idx, bits | sbit)
                        )
        if len(next_level) > MAX_LEVEL_COMBINATIONS:
            pick = rng.choice(len(next_level), MAX_LEVEL_COMBINATIONS,
                              replace=False)
            next_level = [next_level[int(i)] for i in pick]
        current = next_level
        k += 1
    return minimal_solutions


def process_object_coverage(
    scene: Scene,
    object_id: int,
    visible_images: Sequence[str],
    mins: np.ndarray,
    maxs: np.ndarray,
    rng: np.random.Generator,
    tolerance: float = TOLERANCE,
) -> dict[str, dict[int, list[tuple]]]:
    """Minimal combinations for height/length/width of one object.

    Axis selection parity: height axis=2; width/length axes from the
    aligned bbox (process_object, single_object_coverage_finder.py:245-253).
    """
    seg = object_id + 1
    rows = [scene.image_index(img) for img in visible_images]

    def run(axis: int, target: float):
        lows = mins[rows, axis, seg]
        highs = maxs[rows, axis, seg]
        return find_minimal_combinations(
            list(visible_images), lows, highs, target, rng, tolerance)

    width_axis = scene.object_width_axis(object_id)
    length_axis = 1 if width_axis == 0 else 0
    return {
        "height": run(2, scene.object_height(object_id)),
        "length": run(length_axis, scene.object_length(object_id)),
        "width": run(width_axis, scene.object_width(object_id)),
    }


def build_object_coverage(
    scenes: Iterable[Scene],
    object_visibility: dict,
    output_dir: str | None = None,
    split_name: str = "train",
    visibility: "dict[str, np.ndarray] | None" = None,
    seed: int = 0,
    tolerance: float = TOLERANCE,
    device="cuda",
    mesh=None,
):
    """Run the coverage stage; returns (height, length, width) dicts with
    the reference's nested schema
    `{scene_id: {object_id: {k: [image-tuples]}}}` and optionally writes the
    three pkls (process_split_objects, single_object_coverage_finder.py
    :287-338). The interval precompute runs on `device`; with `mesh`, it
    runs scene-parallel over the mesh's data axis
    (`coverage_intervals_multichip`), every process searches every scene,
    results are identical, and only the axis's first process writes the
    pkls."""
    scenes = list(scenes)
    multichip = None
    if mesh is not None:
        vis_all = {}
        for scene in scenes:
            if scene.scene_id not in object_visibility:
                continue
            v = None if visibility is None else visibility.get(
                scene.scene_id)
            vis_all[scene.scene_id] = (
                compute_scene_visibility(scene, device=device) if v is None
                else v)
        multichip = coverage_intervals_multichip(
            [s for s in scenes if s.scene_id in vis_all], mesh, vis_all,
            device=device)
        if mesh.get_local_rank(mesh.mesh_dim_names[0]) != 0:
            output_dir = None
    results = {"height": {}, "length": {}, "width": {}}
    for scene in scenes:
        sid = scene.scene_id
        if sid not in object_visibility:
            continue
        if multichip is not None:
            mins, maxs, _ = multichip[sid]
        else:
            vis = None if visibility is None else visibility.get(sid)
            if vis is None:
                vis = compute_scene_visibility(scene, device=device)
            mins, maxs, _ = object_coverage_intervals(scene, vis, device)
        obj_map = object_visibility[sid]["object_to_images"]
        for dim in results:
            results[dim].setdefault(sid, {})
        for object_id, vis_list in obj_map.items():
            visible_images = [v["image_id"] for v in vis_list]
            rng = stream(seed, "coverage", sid, object_id)
            res = process_object_coverage(
                scene, object_id, visible_images, mins, maxs, rng, tolerance)
            for dim in results:
                results[dim][sid][object_id] = res[dim]
    if output_dir:
        for dim in results:
            dump_pickle(
                results[dim],
                f"{output_dir}/{split_name}_object_coverage_{dim}.pkl",
            )
    return results["height"], results["length"], results["width"]


def merge_coverage_shards(shard_dicts: Iterable[dict]) -> dict:
    """Merge per-shard coverage dicts (merge_object_coverage.py:17-64)."""
    merged: dict = {}
    for shard in shard_dicts:
        for scene_id, objs in shard.items():
            merged.setdefault(scene_id, {}).update(objs)
    return merged
