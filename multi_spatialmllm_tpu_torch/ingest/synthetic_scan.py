"""A ScanNet scan directory written from a scene, for ingest runs with no
dataset on the machine.

`write_scan(root, scene)` writes `<root>/<scene_id>/` in the layout of a
raw ScanNet scan, from which `ingest-scannet` and `ingest-sens` rebuild the
scene:

- `<scan>_vh_clean_2.ply`: binary little-endian vertices (the scene's
  unaligned points as float32, seeded RGB);
- `<scan>_vh_clean_2.0.010000.segs.json`: one segment per instance (segment
  k holds object k's points, segment 0 the unannotated ones);
- `<scan>.aggregation.json`: object k (objectId k - 1) owns segment k;
- `<scan>.txt`: the meta file with the scene's `axisAlignment`;
- `<scan>.sens`: a v4 stream of `n_images * frame_skip` frames. Frames 0,
  frame_skip, 2 * frame_skip, ... carry the scene's poses and zlib depth
  maps and a JPEG colour frame at the scene's image size; each frame
  between repeats the payload of the kept frame before it, so the stream's
  size is a real one and a reader must seek over it.

Colour frames are smooth integer patterns (`scan_frame`, seeded), encoded
by the native codec (cv2.imencode's bytes) on a thread pool.
"""

from __future__ import annotations

import json
import os
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..core.io import mkdir_or_exist
from . import jpeg
from .ply import write_ply_vertices
from .sens import SensFrame, SensHeader, write_sens


def scan_frame(h: int, w: int, k: int, seed: int = 0) -> np.ndarray:
    """uint8 [h, w, 3] BGR frame k: gradients that drift with k plus a
    few flat patches (compresses like a camera frame, not like noise)."""
    rng = np.random.default_rng([seed, k])
    yy = np.arange(h, dtype=np.int32)[:, None]
    xx = np.arange(w, dtype=np.int32)[None, :]
    a, b, c = (int(v) for v in rng.integers(2, 7, size=3))
    img = np.empty((h, w, 3), np.uint8)
    img[..., 0] = (yy // a + xx // b + 3 * k) % 256
    img[..., 1] = (xx // c + 2 * k) % 256
    img[..., 2] = ((yy + xx) // (a + b) + k) % 256
    for _ in range(4):
        y0, x0 = int(rng.integers(0, h)), int(rng.integers(0, w))
        img[y0:y0 + h // 5, x0:x0 + w // 5] = rng.integers(0, 256, size=3)
    return img


def write_scan(root: str, scene, frame_skip: int = 5, quality: int = 90,
               seed: int = 0, threads: int = 8) -> str:
    """Write `scene` as a raw ScanNet scan directory under `root`; returns
    the directory. See the module docstring for the files."""
    scan = scene.scene_id
    scan_dir = os.path.join(root, scan)
    mkdir_or_exist(scan_dir)
    rng = np.random.default_rng(seed)
    xyz = np.asarray(scene.points_unaligned[:, :3], np.float32)
    rgb = rng.integers(0, 256, size=(len(xyz), 3), dtype=np.uint8)
    write_ply_vertices(os.path.join(scan_dir, f"{scan}_vh_clean_2.ply"),
                       xyz, rgb, binary=True)
    with open(os.path.join(scan_dir, f"{scan}_vh_clean_2.0.010000.segs.json"),
              "w") as f:
        json.dump({"segIndices": np.asarray(scene.instance_ids,
                                            np.int64).tolist()}, f)
    groups = [{"objectId": k, "label": cat, "segments": [k + 1]}
              for k, cat in enumerate(scene.categories)]
    with open(os.path.join(scan_dir, f"{scan}.aggregation.json"), "w") as f:
        json.dump({"segGroups": groups}, f)
    with open(os.path.join(scan_dir, f"{scan}.txt"), "w") as f:
        vals = " ".join(repr(float(v)) for v in
                        np.asarray(scene.axis_align).reshape(-1))
        f.write(f"axisAlignment = {vals}\n")

    h, w = scene.image_hw
    n_kept = len(scene.image_ids)

    def color(k):
        return jpeg.imencode(scan_frame(h, w, k, seed), quality)

    def depth(k):
        return zlib.compress(np.ascontiguousarray(
            scene.depth_maps[k], np.uint16).tobytes())

    with ThreadPoolExecutor(threads) as pool:
        colors = list(pool.map(color, range(n_kept)))
        depths = list(pool.map(depth, range(n_kept)))
    frames = []
    for i in range(n_kept * frame_skip):
        k = i // frame_skip
        frames.append(SensFrame(
            index=i, camera_to_world=scene.extrinsics[k], timestamp_color=i,
            timestamp_depth=i, color_jpeg=colors[k], depth_zlib=depths[k]))
    hd, wd = np.asarray(scene.depth_maps).shape[1:3]
    header = SensHeader(
        sensor_name="synthetic", intrinsic_color=scene.intrinsic,
        extrinsic_color=np.eye(4), intrinsic_depth=scene.intrinsic,
        extrinsic_depth=np.eye(4), color_compression="jpeg",
        depth_compression="zlib_ushort", color_hw=(h, w), depth_hw=(hd, wd),
        depth_shift=1000.0, num_frames=len(frames))
    write_sens(os.path.join(scan_dir, f"{scan}.sens"), header, frames)
    return scan_dir
