"""Posed-image info assembly (L1 #4) and direct scene-pack construction.

Two paths:
  * `build_images_info` — parity with
    `spatial_engine/utils/scannet_utils/update_info_file_with_images.py`:
    walk a posed_images/<scene>/ directory, keep every `frame_skip`-th
    image, read pose txts, and emit the `images_info` dict merged into the
    scene info (keys: num_posed_images, images_info{id -> {image_path,
    depth_image_path, extrinsic_matrix}}, intrinsic_matrix).
  * `scene_from_sens` — the TPU-first path: decode a .sens stream straight
    into a packed `Scene` (no intermediate per-frame files), with depth
    frames inflated by the native batch helper.
"""

from __future__ import annotations

import os

import numpy as np

from ..core.scene import Scene
from .native import inflate_depth_frames
from .sens import iter_frames, read_header


def build_images_info(scene_dir: str, frame_skip: int = 5) -> dict:
    """Reference images_info entry for one scene directory."""
    with open(os.path.join(scene_dir, "intrinsic.txt")) as f:
        intrinsic = np.asarray(
            [[float(v) for v in line.split()] for line in f])
    jpgs = sorted(f for f in os.listdir(scene_dir) if f.endswith(".jpg"))
    images_info = {}
    for i, fname in enumerate(jpgs):
        if i % frame_skip != 0:
            continue
        image_id = fname.split(".")[0]
        with open(os.path.join(scene_dir, f"{image_id}.txt")) as f:
            extrinsic = np.asarray(
                [[float(v) for v in line.split()] for line in f])
        scene_name = os.path.basename(scene_dir.rstrip("/"))
        images_info[image_id] = {
            "image_path": f"posed_images/{scene_name}/{fname}",
            "depth_image_path": f"posed_images/{scene_name}/{image_id}.png",
            "extrinsic_matrix": extrinsic,
        }
    return {
        "num_posed_images": len(images_info),
        "images_info": images_info,
        "intrinsic_matrix": intrinsic,
    }


def update_info_with_images(
    scene_infos: dict, posed_images_root: str, frame_skip: int = 5
) -> dict:
    """Merge images_info into every scene entry (the `*_i_D{skip}.pkl`
    step, update_info_file_with_images.py:20-72)."""
    for scene_id in scene_infos:
        scene_dir = os.path.join(posed_images_root, scene_id)
        scene_infos[scene_id].update(
            build_images_info(scene_dir, frame_skip))
    return scene_infos


def scene_from_sens(
    sens_path: str,
    scene_id: str,
    export_arrays: dict,
    frame_skip: int = 5,
) -> Scene:
    """Decode .sens + export arrays (ingest/scannet_export.py) straight
    into a packed Scene — no per-frame files on disk.

    Image ids are the kept-frame ordinals at D1 numbering times
    `frame_skip`... matching the reference double-subsample convention
    (extract at skip=1 then keep every 5th, update_info_file:42) reduces to
    ids 0, skip, 2*skip, ... of the kept order.
    """
    from .image import color_size   # cv2.IMREAD_COLOR's size, no decode

    with open(sens_path, "rb") as f:
        header = read_header(f)
    frames = list(iter_frames(sens_path, frame_skip))
    depth = inflate_depth_frames(
        [fr.depth_zlib for fr in frames], header.depth_hw)
    extrinsics = np.stack([fr.camera_to_world for fr in frames])
    image_hw = color_size(frames[0].color_jpeg)

    has_labels = "instance_ids" in export_arrays
    return Scene(
        scene_id=scene_id,
        intrinsic=header.intrinsic_color,
        axis_align=export_arrays["axis_align"],
        image_ids=[f"{fr.index:05d}" for fr in frames],
        extrinsics=extrinsics,
        image_hw=image_hw,
        depth_maps=depth,
        points_aligned=export_arrays["aligned_points"],
        points_unaligned=export_arrays["unaligned_points"],
        instance_ids=(export_arrays["instance_ids"].astype(np.uint32)
                      if has_labels
                      else np.zeros(len(export_arrays["aligned_points"]),
                                    dtype=np.uint32)),
        aligned_bboxes=(export_arrays["aligned_bboxes"] if has_labels
                        else np.zeros((0, 7))),
        unaligned_bboxes=(export_arrays["unaligned_bboxes"] if has_labels
                          else np.zeros((0, 7))),
        categories=(list(export_arrays["raw_categories"]) if has_labels
                    else []),
    )
