"""Stage: object visibility (which images see which objects), the port of
multi_spatialmllm_tpu/stages/object_visibility.py.

TPU-native replacement for
`spatial_engine/object_perception/compute_object_visibility.py`: the
reference intersects Python sets per (object, image) sequentially
(:122-135, 1h46m train). Here intersection counts for *all* objects and
images of a scene are one matmul: `counts = V @ onehot(instance_ids)`
with `V` the `[I, N]` visibility matrix.

Semantics parity:
  * skip categories in NONINFORMATIVE_DESC (compute_object_visibility.py:58),
  * skip objects with no points (:111-115),
  * keep images with intersection >= max(1, int(0.05 * |object|)) (:122, :135),
  * emit both `object_to_images` and `image_to_objects` with
    `intersection_count` and `visibility` percent (:135-150),
  * iterate images in sorted valid-pose order.

The counts run as torch ops on the device. Not ported yet (ROADMAP.md,
queue 1): the scene-parallel multi-device stage.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from ..core.io import WarningSink, dump_pickle
from ..core.scene import Scene
from .frame_relations import _unpack_bits
from .visibility import compute_scene_visibility

NONINFORMATIVE_DESC = {"wall", "object", "floor", "ceiling", "window"}

# an f32 count of visible points is exact below 2^24
_F32_EXACT = 1 << 24


def _count_kernel(packed: torch.Tensor, instance_ids: torch.Tensor, n: int,
                  num_segments: int) -> torch.Tensor:
    """counts[img, obj] for obj ids 0..num_segments-1 (0 = unannotated).

    `packed` is the host-packbits'd `[I, ceil(n/8)]` visibility matrix
    (big-endian bit order within each byte, numpy.packbits default),
    unpacked on the device. The counts are the JAX stage's f32 product
    `V @ onehot(ids)` with TF32 off (set and restored around it): sums of
    0/1 terms, exact in f32 in any order below 2^24 points."""
    if n >= _F32_EXACT:
        raise ValueError(
            f"object counts in f32 are exact below 2^24 points; got {n}")
    vis = _unpack_bits(packed, n).to(torch.float32)
    # jax.nn.one_hot: an id outside [0, num_segments) is a zero row
    onehot = (instance_ids[:, None] == torch.arange(
        num_segments, dtype=instance_ids.dtype,
        device=instance_ids.device)).to(torch.float32)
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return vis @ onehot
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow


def object_image_counts(scene: Scene, vis: np.ndarray,
                        device="cuda") -> np.ndarray:
    """`[num_images, num_objects]` float32 visible-point counts per object,
    computed on `device`."""
    dev = torch.device(device)
    packed = np.packbits(np.ascontiguousarray(vis), axis=1)
    counts = _count_kernel(
        torch.from_numpy(packed).to(dev),
        torch.from_numpy(scene.instance_ids.astype(np.int32)).to(dev),
        vis.shape[1], scene.num_objects + 1)
    return counts.cpu().numpy()[:, 1:]  # drop the unannotated segment


def compute_object_visibility(
    scene: Scene,
    vis: np.ndarray | None = None,
    warning_sink: WarningSink | None = None,
    counts: np.ndarray | None = None,
    device="cuda",
) -> dict:
    """Reference-schema dict for one scene (compute_object_visibility.py
    docstring :40-44). `counts` short-circuits the device matmul when a
    batched caller already computed `[I, num_objects]`."""
    if counts is None:
        if vis is None:
            vis = compute_scene_visibility(scene, device=device)
        counts = object_image_counts(scene, vis, device)
    valid = scene.valid_image_mask()
    result = {"object_to_images": {}, "image_to_objects": {}}
    for object_id in range(scene.num_objects):
        if scene.categories[object_id] in NONINFORMATIVE_DESC:
            continue
        total = int(scene.object_point_mask(object_id).sum())
        if total == 0:
            if warning_sink is not None:
                warning_sink(
                    f"[Warning] Scene {scene.scene_id}, object {object_id} "
                    f"has no point indices, skipping."
                )
            continue
        threshold = max(1, int(0.05 * total))
        for i, image_id in enumerate(scene.image_ids):
            if not valid[i]:
                continue
            c = int(counts[i, object_id])
            if c >= threshold:
                pct = c / total * 100.0
                result["object_to_images"].setdefault(object_id, []).append(
                    {"image_id": image_id, "intersection_count": c,
                     "visibility": pct}
                )
                result["image_to_objects"].setdefault(image_id, []).append(
                    {"object_id": object_id, "intersection_count": c,
                     "visibility": pct}
                )
    return result


def build_object_visibility(
    scenes: Iterable[Scene],
    output_pkl: str | None = None,
    warning_path: str | None = None,
    visibility: "dict[str, np.ndarray] | None" = None,
    device="cuda",
) -> dict:
    sink = WarningSink(warning_path)
    results = {}
    for scene in scenes:
        vis = None if visibility is None else visibility.get(scene.scene_id)
        results[scene.scene_id] = compute_object_visibility(
            scene, vis, sink, device=device)
    if output_pkl:
        dump_pickle(results, output_pkl)
    return results
