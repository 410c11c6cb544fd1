"""Procedural synthetic fixtures: a mini ScanNet-style scene and a mini
TAPVid-3D sequence.

The reference has no tests and its pipeline only runs on the real ScanNet /
TAPVid-3D downloads. These generators produce small, fully self-consistent
scenes (known geometry, analytically checkable visibility) so that every
stage and engine can be integration-tested and benchmarked without any data
download (SURVEY.md §4 test strategy).

Consistency contract: depth maps are rendered by z-buffer splatting the
scene's own points with the same rounding semantics the occlusion test uses
(info_handler.py:359-371), plus a +2 mm bias, so a frontmost point is always
strictly closer than its depth pixel and therefore visible, while points
behind a nearer surface are occluded.
"""

from __future__ import annotations

import numpy as np

from .scene import Scene

DEPTH_BIAS_MM = 2


# ---------------------------------------------------------------------------
# Host-side float64 projection oracle (shared with tests)
# ---------------------------------------------------------------------------

def np_project_points(points: np.ndarray, K: np.ndarray, E_c2w: np.ndarray):
    """NumPy float64 oracle for geometry.project_points (same math as
    info_handler.py:46-72)."""
    pts = np.concatenate(
        [points[:, :3], np.ones((points.shape[0], 1), dtype=np.float64)], axis=1
    )
    cam = (np.linalg.inv(E_c2w) @ pts.T)
    depth = cam[2, :].copy()
    img = K @ cam
    with np.errstate(divide="ignore", invalid="ignore"):
        img = img / img[2, :]
    return img.T[:, :2], depth


def look_at_c2w(eye: np.ndarray, target: np.ndarray, up=(0.0, 0.0, 1.0)):
    """Camera-to-world matrix with ScanNet conventions: camera X right,
    Y down, Z forward (toward `target`); world up is +Z."""
    eye = np.asarray(eye, dtype=np.float64)
    fwd = np.asarray(target, dtype=np.float64) - eye
    fwd = fwd / np.linalg.norm(fwd)
    upv = np.asarray(up, dtype=np.float64)
    right = np.cross(fwd, upv)
    nr = np.linalg.norm(right)
    if nr < 1e-8:  # looking straight up/down; pick arbitrary right
        right = np.array([1.0, 0.0, 0.0])
        nr = 1.0
    right = right / nr
    down = np.cross(fwd, right)
    E = np.eye(4, dtype=np.float64)
    E[:3, 0] = right
    E[:3, 1] = down
    E[:3, 2] = fwd
    E[:3, 3] = eye
    return E


def render_depth_map(
    points: np.ndarray,
    K: np.ndarray,
    E_c2w: np.ndarray,
    image_hw: tuple[int, int],
    depth_hw: tuple[int, int],
) -> np.ndarray:
    """Z-buffer splat of the point cloud into a uint16 mm depth map."""
    xy, depth = np_project_points(points, K, E_c2w)
    h, w = image_hw
    hd, wd = depth_hw
    ok = (
        (depth > 0)
        & (xy[:, 0] >= 0) & (xy[:, 0] < w)
        & (xy[:, 1] >= 0) & (xy[:, 1] < h)
        & np.isfinite(xy).all(axis=1)
    )
    dx = np.clip(np.round(xy[ok, 0] * (wd / w)).astype(np.int64), 0, wd - 1)
    dy = np.clip(np.round(xy[ok, 1] * (hd / h)).astype(np.int64), 0, hd - 1)
    mm = np.floor(depth[ok] * 1000.0).astype(np.int64) + DEPTH_BIAS_MM
    buf = np.full(hd * wd, np.iinfo(np.uint16).max, dtype=np.int64)
    np.minimum.at(buf, dy * wd + dx, mm)
    buf[buf == np.iinfo(np.uint16).max] = 0  # unobserved pixels -> invalid
    return buf.reshape(hd, wd).astype(np.uint16)


def make_scene(
    scene_id: str = "synth0000_00",
    n_background: int = 4000,
    n_objects: int = 4,
    points_per_object: int = 300,
    n_images: int = 12,
    image_hw: tuple[int, int] = (96, 128),
    depth_hw: tuple[int, int] = (48, 64),
    room: tuple[float, float, float] = (6.0, 5.0, 3.0),
    seed: int = 0,
    n_invalid_poses: int = 1,
) -> Scene:
    """Procedural room scene with labeled objects and posed cameras."""
    rng = np.random.default_rng(seed)
    lx, ly, lz = room

    # Background: points on the floor and the four walls.
    n_each = n_background // 5
    floor = np.stack(
        [rng.uniform(0, lx, n_each), rng.uniform(0, ly, n_each),
         np.zeros(n_each)], axis=1)
    walls = []
    for fixed_axis, value in ((0, 0.0), (0, lx), (1, 0.0), (1, ly)):
        p = np.stack(
            [rng.uniform(0, lx, n_each), rng.uniform(0, ly, n_each),
             rng.uniform(0, lz, n_each)], axis=1)
        p[:, fixed_axis] = value
        walls.append(p)
    background = np.concatenate([floor] + walls, axis=0)

    categories = ["chair", "table", "sofa", "cabinet", "bed", "desk", "lamp"]
    obj_points = []
    obj_ids = []
    bboxes = []
    cats = []
    for k in range(n_objects):
        center = np.array(
            [rng.uniform(1.2, lx - 1.2), rng.uniform(1.2, ly - 1.2),
             rng.uniform(0.3, 1.2)])
        size = rng.uniform(0.3, 1.0, size=3)
        pts = center + (rng.uniform(-0.5, 0.5, size=(points_per_object, 3)) * size)
        obj_points.append(pts)
        obj_ids.append(np.full(points_per_object, k + 1, dtype=np.uint32))
        lo, hi = pts.min(axis=0), pts.max(axis=0)
        bboxes.append(np.concatenate([(lo + hi) / 2, hi - lo, [0.0]]))
        cats.append(categories[k % len(categories)])

    points_aligned = np.concatenate([background] + obj_points, axis=0)
    instance_ids = np.concatenate(
        [np.zeros(background.shape[0], dtype=np.uint32)] + obj_ids)
    aligned_bboxes = np.stack(bboxes) if bboxes else np.zeros((0, 7))

    # Axis-align matrix: aligned = A @ unaligned. Synthesize a small rigid
    # transform and derive the unaligned cloud from its inverse.
    theta = rng.uniform(-0.3, 0.3)
    A = np.eye(4)
    A[:2, :2] = [[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]]
    A[:3, 3] = rng.uniform(-0.5, 0.5, 3)
    A_inv = np.linalg.inv(A)
    pts_h = np.concatenate(
        [points_aligned, np.ones((points_aligned.shape[0], 1))], axis=1)
    points_unaligned = (A_inv @ pts_h.T).T[:, :3]

    # Unaligned bboxes: recompute AABB of each object's unaligned points.
    ub = []
    for k in range(n_objects):
        m = instance_ids == k + 1
        lo, hi = points_unaligned[m].min(axis=0), points_unaligned[m].max(axis=0)
        ub.append(np.concatenate([(lo + hi) / 2, hi - lo, [0.0]]))
    unaligned_bboxes = np.stack(ub) if ub else np.zeros((0, 7))

    # Intrinsics scaled to the image size.
    h, w = image_hw
    K = np.eye(4)
    K[0, 0] = K[1, 1] = 1.1 * w
    K[0, 2] = w / 2.0
    K[1, 2] = h / 2.0

    # Cameras on a ring inside the room looking across the center
    # (extrinsics stored UNALIGNED, as in the reference: the axis-align
    # matrix is applied at query time, info_handler.py:113-124).
    center = np.array([lx / 2, ly / 2, 1.0])
    extrinsics = []
    for i in range(n_images):
        ang = 2 * np.pi * i / n_images
        eye = center + np.array(
            [1.8 * np.cos(ang), 1.8 * np.sin(ang), rng.uniform(0.2, 0.8)])
        target = center + rng.uniform(-0.4, 0.4, 3)
        E_aligned = look_at_c2w(eye, target)
        extrinsics.append(A_inv @ E_aligned)  # store unaligned
    extrinsics = np.stack(extrinsics)

    # Poison a few poses with inf (reference stores invalid poses this way).
    for i in range(min(n_invalid_poses, n_images)):
        extrinsics[n_images - 1 - i] = np.full((4, 4), -np.inf)

    # Depth maps rendered from the aligned cloud with aligned extrinsics.
    depth_maps = []
    for i in range(n_images):
        if not np.isfinite(extrinsics[i]).all():
            depth_maps.append(np.zeros(depth_hw, dtype=np.uint16))
            continue
        E_al = A @ extrinsics[i]
        depth_maps.append(
            render_depth_map(points_aligned, K, E_al, image_hw, depth_hw))

    return Scene(
        scene_id=scene_id,
        intrinsic=K,
        axis_align=A,
        image_ids=[f"{i * 5:05d}" for i in range(n_images)],  # D5 spacing
        extrinsics=extrinsics,
        image_hw=image_hw,
        depth_maps=np.stack(depth_maps),
        points_aligned=points_aligned,
        points_unaligned=points_unaligned,
        instance_ids=instance_ids,
        aligned_bboxes=aligned_bboxes,
        unaligned_bboxes=unaligned_bboxes,
        categories=cats,
    )


# ---------------------------------------------------------------------------
# Synthetic TAPVid-3D sequence
# ---------------------------------------------------------------------------

def make_tapvid_npz(
    path: str | None = None,
    n_frames: int = 12,
    n_groups: int = 3,
    points_per_group: int = 8,
    n_static: int = 10,
    image_hw: tuple[int, int] = (64, 96),
    camera_motion: bool = True,
    seed: int = 0,
) -> dict:
    """A TAPVid-3D-format record: rigid clusters with known motion.

    Keys match the official npz schema consumed by the reference
    (single_object_movement_engine_coord.py:441-444): `images_jpeg_bytes`,
    `fx_fy_cx_cy`, `tracks_XYZ` (camera coords), `visibility`,
    `extrinsics_w2c`. If `path` is given the dict is also saved as npz.
    """
    from ..ingest import jpeg   # cv2.imencode's bytes, without cv2

    rng = np.random.default_rng(seed)
    h, w = image_hw
    fx = fy = 1.2 * w
    cx, cy = w / 2.0, h / 2.0

    # World tracks: each group translates with a constant velocity.
    groups = []
    for g in range(n_groups):
        base = rng.uniform(-1.0, 1.0, size=(points_per_group, 3)) * 0.4
        base += np.array([rng.uniform(-1, 1), rng.uniform(-0.5, 0.5),
                          rng.uniform(3.0, 5.0)])
        # Per-frame velocity large enough that inter-group distance changes
        # clear the segmentation smoothing threshold (0.01 m/step) and
        # accumulate well past the 0.1 clustering cut.
        direction = rng.normal(size=3)
        direction /= np.linalg.norm(direction)
        vel = direction * rng.uniform(0.06, 0.15)
        track = base[None] + vel[None, None] * np.arange(n_frames)[:, None, None]
        groups.append(track)
    static = rng.uniform(-1.0, 1.0, size=(n_static, 3)) * 0.8
    static += np.array([0.0, 0.0, 4.0])
    static_track = np.broadcast_to(static, (n_frames, n_static, 3)).copy()
    tracks_world = np.concatenate(groups + [static_track], axis=1)
    n_points = tracks_world.shape[1]

    # Camera: slow lateral drift (w2c = inverse of c2w translation).
    extrinsics_w2c = np.tile(np.eye(4), (n_frames, 1, 1))
    if camera_motion:
        for t in range(n_frames):
            extrinsics_w2c[t, :3, 3] = [-0.05 * t, 0.01 * t, 0.0]

    # Camera-frame tracks.
    pts_h = np.concatenate(
        [tracks_world, np.ones((n_frames, n_points, 1))], axis=2)
    tracks_cam = np.einsum("nij,nkj->nki", extrinsics_w2c, pts_h)[..., :3]

    # Visibility: in front of camera and inside the frame.
    u = fx * tracks_cam[..., 0] / (tracks_cam[..., 2] + 1e-8) + cx
    v = fy * tracks_cam[..., 1] / (tracks_cam[..., 2] + 1e-8) + cy
    visibility = (
        (tracks_cam[..., 2] > 0) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    )

    frames = []
    for t in range(n_frames):
        img = rng.integers(0, 255, size=(h, w, 3), dtype=np.uint8)
        frames.append(jpeg.imencode(img))

    record = {
        "images_jpeg_bytes": np.array(frames, dtype=object),
        "fx_fy_cx_cy": np.array([fx, fy, cx, cy]),
        "tracks_XYZ": tracks_cam,
        "visibility": visibility,
        "extrinsics_w2c": extrinsics_w2c,
    }
    if path is not None:
        np.savez(path, **record)
    return record


# ---------------------------------------------------------------------------
# Synthetic .sens stream (L1 ingestion bench / fixtures)
# ---------------------------------------------------------------------------

def make_synthetic_sens(
    path: str,
    n_frames: int = 100,
    image_hw: tuple[int, int] = (480, 640),
    depth_hw: tuple[int, int] = (480, 640),
    seed: int = 0,
) -> None:
    """Write a ScanNet-like `.sens` stream with REALISTIC payload sizes.

    Color frames are smooth gradients + textured blobs (JPEG compresses
    them like real photos, not like noise); depth is a smooth surface
    with quantization steps (zlib ratios comparable to real ScanNet
    exports). Used by bench.py's L1 ingestion stage — the reference's
    extractor (extract_posed_images.py:161-188) publishes no wall, the
    info update publishes ~40 min (utils/scannet_utils/README.md:82).
    """
    import zlib

    from ..ingest import jpeg   # cv2.imencode's bytes, without cv2
    from ..ingest.sens import SensFrame, SensHeader, write_sens

    rng = np.random.default_rng(seed)
    h, w = image_hw
    hd, wd = depth_hw
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    yyd, xxd = np.mgrid[0:hd, 0:wd].astype(np.float32)
    frames = []
    for i in range(n_frames):
        # smooth background + a few textured blobs, drifting per frame
        img = (96 + 80 * np.sin(xx / 97.0 + i * 0.1)
               * np.cos(yy / 61.0 - i * 0.05))
        for _ in range(6):
            bx, by = rng.uniform(0, w), rng.uniform(0, h)
            r2 = (xx - bx) ** 2 + (yy - by) ** 2
            img = img + 50 * np.exp(-r2 / rng.uniform(500, 5000))
        img = np.clip(img, 0, 255).astype(np.uint8)
        img3 = np.stack([img, np.roll(img, 7, 0), np.roll(img, 13, 1)], -1)
        color = jpeg.imencode(img3, 90)
        depth = (2000 + 1500 * np.sin(xxd / 131.0 + i * 0.07)
                 + 900 * np.cos(yyd / 89.0)).astype(np.uint16)
        pose = look_at_c2w(np.array([i * 0.05, 0.0, 1.5]),
                           np.array([2.0, 1.0, 1.0]))
        frames.append(SensFrame(
            index=i, camera_to_world=pose, timestamp_color=i,
            timestamp_depth=i, color_jpeg=color,
            depth_zlib=zlib.compress(depth.tobytes())))
    K = np.eye(4)
    K[0, 0] = K[1, 1] = 1.2 * w
    K[0, 2], K[1, 2] = w / 2.0, h / 2.0
    header = SensHeader(
        sensor_name="synthetic", intrinsic_color=K,
        extrinsic_color=np.eye(4), intrinsic_depth=K,
        extrinsic_depth=np.eye(4), color_compression="jpeg",
        depth_compression="zlib_ushort", color_hw=image_hw,
        depth_hw=depth_hw, depth_shift=1000.0, num_frames=n_frames)
    write_sens(path, header, frames)
