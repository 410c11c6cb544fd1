"""Object-movement QA engines (TAPVid-3D dynamic/4D tasks), coord + dot.

The port of multi_spatialmllm_tpu/engines/object_movement.py, replacing
`spatial_engine/object_movement/single_object_movement_engine_{coord,dot}.py`.
The hot numerical step — accumulating smoothed pairwise-distance changes
over time for rigid-body segmentation (T x N^2 `scipy.pdist` calls,
:69-84) — runs as torch ops on a device (M5); hierarchical average-linkage
clustering of the resulting N x N matrix stays on host via scipy (tiny).
Frames are decoded, re-encoded and annotated with cv2's bytes through the
native codec (ingest/jpeg.py) and engines/draw.py, never through cv2.

Semantics parity (single_object_movement_engine_coord.py unless noted):
  * smoothing: |d_t - d_{t-1}| kept only above 0.01 then accumulated
    (:34-47); average-linkage fcluster at t=0.1 (:80-84); groups > 5
    points kept (:94-105),
  * per group `npoints_per_group` points; per point all visible-frame
    pairs; static (<1 cm) pairs contribute one random sample; moving pairs
    binned into 10 distance bins with the middle bin's count as per-bin
    quota (>=1) (:502-548),
  * reverse-pair augmentation with `augment_ratio` (:558-567),
  * GT: world displacement distance (zeroed + "The point did not move. "
    prefix when < 1 cm, :335-338, :377-378); displacement vector rotated
    (w=0) into camera 1 (:352-356); camera-moving flag from c2w translation
    delta (:342-350); pinhole projection validity 0<=u,v<1 and z>0
    (:293-315); coords round(u*1000),
  * gt_value: int(dist*1000) for total_distance (truncating int, :393 —
    the answer text uses round(), :372; both behaviors preserved), vector
    stored in meters (:393),
  * dot variant (single_object_movement_engine_dot.py): circle of radius
    W//100 on the query point in image 1, image 2 unannotated (:330-345);
    image filenames get an `_annotated` suffix for frame 1.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..core.io import mkdir_or_exist, write_jsonl
from ..ingest import jpeg
from .draw import circle
from .annotate import AnnotationPool
from ..core.rng import ENGINE_SEEDS, stream
from .base import EngineOutputs, choice, make_conversation, to_eval_sample
from .templates import object_movement as T

QUESTION_TYPES = ("tapvid3d_total_distance", "tapvid3d_displacement_vector")


@dataclasses.dataclass
class ObjectMovementConfig:
    question_type: str = "tapvid3d_total_distance"
    npoints_per_group: int = 15       # train cfg :690
    npairs_per_bin: int = 30          # train cfg :691
    augment: bool = True
    augment_ratio: float = 0.05       # :706
    object_not_moving_threshold: float = 0.01
    camera_not_moving_threshold: float = 0.01
    min_group_size: int = 5
    cluster_threshold: float = 0.1
    smoothing_factor: float = 0.01
    seed: int = ENGINE_SEEDS["object_movement"]
    dot_variant: bool = False


# ---------------------------------------------------------------------------
# Rigid-body segmentation: device accumulation + host clustering
# ---------------------------------------------------------------------------

# pair distances M5 computes at once ([frames, N, N]), which bounds its
# float64 temporaries to a few hundred MB whatever T is
M5_CHUNK_PAIRS = 1 << 24


def _fma_square(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 fma(a, a, c), rounded once, for c >= 0: XLA contracts the
    squared sum into such fmas and torch has none. a * a is exact in
    float64; TwoSum gives the float64 sum's error, which rounding to odd
    keeps in the last bit, so the cast to float32 rounds as one fma does.
    IEEE-exact operations only, so every device gives the same bits."""
    a, c = a.double(), c.double()
    p = a * a
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    bits = s.view(torch.int64)          # s >= 0: one ulp is one step
    odd = torch.where(err > 0, bits + 1, bits - 1)
    bits = torch.where((err != 0) & ((bits & 1) == 0), odd, bits)
    return bits.view(torch.float64).float()


def _pair_distances(points: torch.Tensor) -> torch.Tensor:
    """[F, N, 3] float32 -> [F, N, N] direct distances, as XLA computes
    them: fma(dz, dz, fma(dy, dy, dx * dx)), then a correctly rounded
    sqrt (a float64 sqrt rounded to float32 is one; torch's vectorised
    CPU float32 sqrt is not). Direct differences, NOT the Gram-matrix
    identity: the smoothing threshold (1 cm) sits far below the
    cancellation error of |p|^2-based distances at f32 precision."""
    diff = points[:, :, None, :] - points[:, None, :, :]
    dx, dy, dz = diff.unbind(-1)
    return torch.sqrt(_fma_square(dz, _fma_square(dy, dx * dx)).double()
                      ).float()


def m5(points: torch.Tensor) -> torch.Tensor:
    """M5, on the device of `points` ([T, N, 3] float32): the [N, N] sum
    over frames of |d_t - d_{t-1}|, each change of 0.01 or less zeroed.
    The frames go through in chunks of M5_CHUNK_PAIRS pair distances, and
    the changes are summed in frame order; [T, N, N] is never held
    whole."""
    t, n, _ = points.shape
    dev = points.device
    chunk = max(1, M5_CHUNK_PAIRS // (n * n))
    threshold = torch.tensor(0.01, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    acc = torch.zeros((n, n), dtype=torch.float32, device=dev)
    prev = None
    for lo in range(0, t, chunk):
        dists = _pair_distances(points[lo: lo + chunk])
        if prev is not None:
            dists = torch.cat([prev[None], dists])
        change = (dists[1:] - dists[:-1]).abs()
        for row in torch.where(change > threshold, change, zero):
            acc += row
        prev = dists[-1]
    return acc


def cumulative_loss(points: np.ndarray, device="cuda") -> np.ndarray:
    """M5 of a [T, N, 3] track array, run on `device`."""
    pts = torch.from_numpy(np.ascontiguousarray(points, np.float32))
    return m5(pts.to(torch.device(device))).cpu().numpy()


def rigid_body_segmentation(
    points: np.ndarray,
    threshold: float = 0.1,
    min_group_size: int = 5,
    device="cuda",
) -> list[list[int]]:
    """Cluster points into rigid bodies from a `[T, N, 3]` track tensor
    (M5 on `device`)."""
    from scipy.cluster.hierarchy import fcluster, linkage
    from scipy.spatial.distance import squareform

    cumulative = cumulative_loss(points, device).astype(np.float64)
    np.fill_diagonal(cumulative, 0.0)
    cumulative = (cumulative + cumulative.T) / 2  # enforce exact symmetry
    links = linkage(squareform(cumulative), method="average")
    labels = fcluster(links, threshold, criterion="distance")
    groups = [np.where(labels == i)[0].tolist()
              for i in range(1, labels.max() + 1)]
    return [g for g in groups if len(g) > min_group_size]


# ---------------------------------------------------------------------------
# Per-sequence processing
# ---------------------------------------------------------------------------

def project_point(point_3d, intrinsics, image_hw):
    """Pinhole projection to normalized [0,1) coords with validity check
    (parity: project_point :293-315)."""
    fx, fy, cx, cy = intrinsics
    x, y, z = float(point_3d[0]), float(point_3d[1]), float(point_3d[2])
    u = (fx * x / (z + 1e-8)) + cx
    v = (fy * y / (z + 1e-8)) + cy
    un, vn = u / image_hw[1], v / image_hw[0]
    if not (0 <= un < 1 and 0 <= vn < 1 and z > 0):
        return None
    return un, vn


def select_sample_pairs(
    record: dict,
    tracks_world: np.ndarray,
    config: ObjectMovementConfig,
    rng: np.random.Generator,
    device="cuda",
) -> list[dict]:
    """Group points, enumerate visible-frame pairs, balance by distance
    bins (:468-556)."""
    visibility = record["visibility"]
    groups = rigid_body_segmentation(
        record["tracks_XYZ"], config.cluster_threshold, config.min_group_size,
        device)

    sample_pairs = []
    for group in groups:
        group = list(group)
        rng.shuffle(group)
        for point_idx in group[: config.npoints_per_group]:
            frames = np.where(visibility[:, point_idx])[0]
            if len(frames) < 2:
                continue
            a, b = np.triu_indices(len(frames), k=1)
            f1, f2 = frames[a], frames[b]
            dists = np.linalg.norm(
                tracks_world[f2, point_idx] - tracks_world[f1, point_idx],
                axis=1)
            static = dists < config.object_not_moving_threshold
            selected = []
            if static.any():
                pick = int(rng.integers(static.sum()))
                k = np.where(static)[0][pick]
                selected.append((dists[k], int(f1[k]), int(f2[k])))
            moving_idx = np.where(~static)[0]
            if len(moving_idx):
                mdists = dists[moving_idx]
                edges = np.histogram_bin_edges(mdists, bins=10)
                bins = np.minimum(np.digitize(mdists, edges) - 1, 9)
                mid_count = int((bins == 4).sum())
                quota = max(min(mid_count, config.npairs_per_bin), 1)
                for b_id in range(10):
                    members = moving_idx[bins == b_id]
                    if len(members) > quota:
                        members = rng.choice(members, size=quota,
                                             replace=False)
                    for k in members:
                        selected.append(
                            (dists[k], int(f1[k]), int(f2[k])))
            for _, fr1, fr2 in selected:
                sample_pairs.append(
                    {"point_index": int(point_idx), "frame1": fr1,
                     "frame2": fr2})

    if config.augment and sample_pairs:
        n_aug = int(len(sample_pairs) * config.augment_ratio)
        pick = rng.choice(len(sample_pairs), size=n_aug, replace=False)
        for i in pick:
            s = sample_pairs[int(i)]
            sample_pairs.append({"point_index": s["point_index"],
                                 "frame1": s["frame2"],
                                 "frame2": s["frame1"]})
    return sample_pairs


def format_samples(
    scene_id: str,
    record: dict,
    sample_pairs: list[dict],
    tracks_world: np.ndarray,
    image_hw: tuple[int, int],
    config: ObjectMovementConfig,
    rng: np.random.Generator,
) -> list[dict]:
    """Turn (point, frame1, frame2) picks into InternVL samples
    (format_training_samples :317-404)."""
    intrinsics = record["fx_fy_cx_cy"]
    extrinsics_w2c = record["extrinsics_w2c"]
    tracks_cam = record["tracks_XYZ"]
    qtype = config.question_type
    h, w = image_hw
    # one batched inverse for all frames (samples reuse the same 4x4s)
    c2w_all = np.linalg.inv(extrinsics_w2c)
    cam_centers = c2w_all[:, :3, 3]
    out = []
    for sp in sample_pairs:
        f1, f2, p = sp["frame1"], sp["frame2"], sp["point_index"]
        disp_world = tracks_world[f2, p] - tracks_world[f1, p]
        dist = float(np.linalg.norm(disp_world))
        if dist < config.object_not_moving_threshold:
            point_moving = False
            dist = 0.0
            disp_world = np.zeros(3)
        else:
            point_moving = True

        cam_dist = float(np.linalg.norm(cam_centers[f2] - cam_centers[f1]))
        camera_moving = cam_dist >= config.camera_not_moving_threshold

        # rotation-only world -> camera-1 (homogeneous w=0, :352-356)
        disp_cam1 = (extrinsics_w2c[f1] @ np.append(disp_world, 0.0))[:3]

        p2d_1 = project_point(tracks_cam[f1, p], intrinsics, image_hw)
        p2d_2 = project_point(tracks_cam[f2, p], intrinsics, image_hw)
        if p2d_1 is None or p2d_2 is None:
            continue
        # Python round() == np.round on scalars (half-to-even), ~8x faster
        x1, y1 = round(p2d_1[0] * 1000), round(p2d_1[1] * 1000)
        x2, y2 = round(p2d_2[0] * 1000), round(p2d_2[1] * 1000)

        task = choice(rng, T.TASK_DESCRIPTION)
        question = choice(rng, T.QUESTION_TEMPLATES[qtype]).format(x1=x1, y1=y1)
        answer = choice(rng, T.ANSWER_TEMPLATES[qtype]).format(
            total_distance=round(dist * 1000),
            x_value=round(float(disp_cam1[0]) * 1000),
            y_value=round(float(disp_cam1[1]) * 1000),
            z_value=round(float(disp_cam1[2]) * 1000),
        )
        if not point_moving:
            answer = "The point did not move. " + answer

        if config.dot_variant:
            images = [f"{scene_id}/{f1:05d}_p{p}_annotated.jpg",
                      f"{scene_id}/{f2:05d}.jpg"]
        else:
            images = [f"{scene_id}/{f1:05d}.jpg", f"{scene_id}/{f2:05d}.jpg"]

        out.append({
            "id": f"{scene_id}_{f1}_{f2}_{p}",
            "image": images,
            "conversations": make_conversation(f"{task}\n{question}", answer),
            "height_list": [h] * 2,
            "width_list": [w] * 2,
            "gt_value": (int(dist * 1000) if "total_distance" in qtype
                         else disp_cam1.tolist()),
            "question_type": qtype,
            "point_moving": int(point_moving),
            "cam_moving": int(camera_moving),
            "p1": (x1, y1),
            "p2": (x2, y2),
        })
    return out


def process_sequence(
    scene_id: str,
    record: dict,
    config: ObjectMovementConfig,
    rng: np.random.Generator,
    img_output_dir: str | None = None,
    pool: AnnotationPool | None = None,
    device="cuda",
) -> list[dict]:
    """One npz record -> train samples. Decodes/caches frames when
    `img_output_dir` is given (:415-432); the dot variant annotates the
    frame-1 query point (dot engine :330-345)."""
    n_frames, n_points, _ = record["tracks_XYZ"].shape
    extrinsics_w2c = record.get("extrinsics_w2c")
    if extrinsics_w2c is not None:
        c2w = np.linalg.inv(extrinsics_w2c)
        pts_h = np.concatenate(
            [record["tracks_XYZ"], np.ones((n_frames, n_points, 1))], axis=2)
        tracks_world = np.einsum("nij,nkj->nki", c2w, pts_h)[..., :3]
    else:
        tracks_world = record["tracks_XYZ"].copy()
        record = dict(record)
        record["extrinsics_w2c"] = np.tile(np.eye(4), (n_frames, 1, 1))

    image_hw = jpeg.jpeg_size(record["images_jpeg_bytes"][0])

    pairs = select_sample_pairs(record, tracks_world, config, rng, device)
    samples = format_samples(
        scene_id, record, pairs, tracks_world, image_hw, config, rng)

    if img_output_dir is not None:
        own_pool = pool is None
        if own_pool:
            pool = AnnotationPool()
        scene_dir = os.path.join(img_output_dir, scene_id)
        mkdir_or_exist(scene_dir)
        needed_frames = {s["frame1"] for s in pairs} | {s["frame2"] for s in pairs}
        for f in sorted(needed_frames):
            path = os.path.join(scene_dir, f"{f:05d}.jpg")
            if not os.path.exists(path):
                def write_frame(f=f, path=path):
                    jpeg.imwrite(path, jpeg.imdecode(
                        record["images_jpeg_bytes"][f]))

                pool.submit(write_frame, key=path)
        if config.dot_variant:
            # dedupe on (submitted this run) OR (exists on disk): identical
            # to the inline exists()-check semantics (a prior iteration's
            # write always completed inline) but independent of the pool's
            # write timing, so the rng stream stays deterministic.
            submitted: set = set()
            for s in samples:
                f1 = int(s["id"].split("_")[-3])
                apath = os.path.join(scene_dir,
                                     os.path.basename(s["image"][0]))
                if apath in submitted or os.path.exists(apath):
                    continue
                submitted.add(apath)
                # rng draw stays synchronous (stream order); only the
                # decode + circle + encode runs on the pool
                color = tuple(int(c) for c in rng.integers(0, 256, 3))

                def write_annot(f1=f1, apath=apath, color=color,
                                x=int(s["p1"][0] / 1000 * image_hw[1]),
                                y=int(s["p1"][1] / 1000 * image_hw[0])):
                    img = jpeg.imdecode(record["images_jpeg_bytes"][f1])
                    radius = max(image_hw[1] // 100, 1)
                    circle(img, (x, y), radius, color)
                    jpeg.imwrite(apath, img)

                pool.submit(write_annot, key=apath)
        if own_pool:
            pool.close()
    return samples


def generate(
    scene_records: dict[str, dict],
    output_file: str,
    config: ObjectMovementConfig | None = None,
    img_output_dir: str | None = None,
    max_samples: int = -1,
    eval_mode: bool = False,
    device="cuda",
) -> EngineOutputs:
    """Run over a {scene_id: npz-record} mapping and write JSONL
    (generate_qa_training_data :580-607 / eval :614-644); M5 runs on
    `device`."""
    config = config or ObjectMovementConfig()
    rng = stream(config.seed, "object_movement", config.question_type,
                 "eval" if eval_mode else "train")
    all_samples: list[dict] = []
    pool = AnnotationPool()
    for scene_id in sorted(scene_records.keys()):
        srng = stream(config.seed, "object_movement", config.question_type,
                      "eval" if eval_mode else "train", scene_id)
        all_samples.extend(
            process_sequence(scene_id, scene_records[scene_id], config,
                             srng, img_output_dir, pool=pool, device=device))
    pool.close()
    out = EngineOutputs()
    if eval_mode:
        # Reference eval flow (single_object_movement_engine_dot.py
        # :671-686): convert to eval format, dump the FULL set to
        # `*_orig.jsonl`, then subsample to max_samples for the eval file
        # (no shuffle; the reference keeps eval_data when under the cap —
        # its unconditional `subsampled_eval_data` write is a latent
        # NameError there, evident intent implemented).
        all_samples = [to_eval_sample(s, keep_conversations=True)
                       for s in all_samples]
        write_jsonl(all_samples, output_file.replace(".jsonl",
                                                     "_orig.jsonl"))
        if 0 < max_samples < len(all_samples):
            idx = rng.choice(len(all_samples), size=max_samples,
                             replace=False)
            all_samples = [all_samples[int(i)] for i in idx]
        n = write_jsonl(all_samples, output_file)
        out.val_path, out.n_val = output_file, n
        return out
    if 0 < max_samples < len(all_samples):
        idx = rng.choice(len(all_samples), size=max_samples, replace=False)
        all_samples = [all_samples[int(i)] for i in idx]
    order = rng.permutation(len(all_samples))
    all_samples = [all_samples[i] for i in order]
    n = write_jsonl(all_samples, output_file)
    out.train_path, out.n_train = output_file, n
    return out


def _sequence_columns(
    scene_id: str,
    record: dict,
    config: ObjectMovementConfig,
    rng: np.random.Generator,
    img_output_dir: str | None,
    pool: AnnotationPool,
    cols: dict,
    device="cuda",
) -> None:
    """Columnar twin of process_sequence + format_samples: identical
    sampling / template / annotation rng order, values into columns."""
    n_frames, n_points, _ = record["tracks_XYZ"].shape
    extrinsics_w2c = record.get("extrinsics_w2c")
    if extrinsics_w2c is not None:
        c2w = np.linalg.inv(extrinsics_w2c)
        pts_h = np.concatenate(
            [record["tracks_XYZ"], np.ones((n_frames, n_points, 1))], axis=2)
        tracks_world = np.einsum("nij,nkj->nki", c2w, pts_h)[..., :3]
    else:
        tracks_world = record["tracks_XYZ"].copy()
        record = dict(record)
        record["extrinsics_w2c"] = np.tile(np.eye(4), (n_frames, 1, 1))
        extrinsics_w2c = record["extrinsics_w2c"]

    image_hw = jpeg.jpeg_size(record["images_jpeg_bytes"][0])
    h, w = image_hw

    pairs = select_sample_pairs(record, tracks_world, config, rng, device)

    intrinsics = record["fx_fy_cx_cy"]
    tracks_cam = record["tracks_XYZ"]
    qtype = config.question_type
    c2w_all = np.linalg.inv(extrinsics_w2c)
    cam_centers = c2w_all[:, :3, 3]
    kept = []  # rows that produced samples (for the annotation loop)
    for sp in pairs:
        f1, f2, p = sp["frame1"], sp["frame2"], sp["point_index"]
        disp_world = tracks_world[f2, p] - tracks_world[f1, p]
        dist = float(np.linalg.norm(disp_world))
        if dist < config.object_not_moving_threshold:
            point_moving = False
            dist = 0.0
            disp_world = np.zeros(3)
        else:
            point_moving = True
        cam_dist = float(np.linalg.norm(cam_centers[f2] - cam_centers[f1]))
        camera_moving = cam_dist >= config.camera_not_moving_threshold
        disp_cam1 = (extrinsics_w2c[f1] @ np.append(disp_world, 0.0))[:3]
        p2d_1 = project_point(tracks_cam[f1, p], intrinsics, image_hw)
        p2d_2 = project_point(tracks_cam[f2, p], intrinsics, image_hw)
        if p2d_1 is None or p2d_2 is None:
            continue
        x1, y1 = round(p2d_1[0] * 1000), round(p2d_1[1] * 1000)
        x2, y2 = round(p2d_2[0] * 1000), round(p2d_2[1] * 1000)
        row = {
            "sid": scene_id, "f1": f1, "f2": f2, "pt": p,
            "f1s": f"{f1:05d}", "f2s": f"{f2:05d}",
            "x1": x1, "y1": y1, "x2": x2, "y2": y2, "h": h, "w": w,
            "pm": int(point_moving), "cm": int(camera_moving),
            "dist_mm_round": round(dist * 1000),
            "dist_mm_trunc": int(dist * 1000),
            "vx": round(float(disp_cam1[0]) * 1000),
            "vy": round(float(disp_cam1[1]) * 1000),
            "vz": round(float(disp_cam1[2]) * 1000),
            "g0": float(disp_cam1[0]), "g1": float(disp_cam1[1]),
            "g2": float(disp_cam1[2]),
            "t_idx": int(rng.integers(len(T.TASK_DESCRIPTION))),
            "q_idx": int(rng.integers(len(T.QUESTION_TEMPLATES[qtype]))),
            "a_idx": int(rng.integers(len(T.ANSWER_TEMPLATES[qtype]))),
        }
        for k, v in row.items():
            cols[k].append(v)
        kept.append(row)

    if img_output_dir is not None:
        scene_dir = os.path.join(img_output_dir, scene_id)
        mkdir_or_exist(scene_dir)
        needed = {r["f1"] for r in kept} | {r["f2"] for r in kept}
        for f in sorted(needed):
            path = os.path.join(scene_dir, f"{f:05d}.jpg")
            if not os.path.exists(path):
                def write_frame(f=f, path=path):
                    jpeg.imwrite(path, jpeg.imdecode(
                        record["images_jpeg_bytes"][f]))

                pool.submit(write_frame, key=path)
        if config.dot_variant:
            # see process_sequence: submitted-set keeps the dedupe (and
            # hence the rng stream) independent of pool write timing
            submitted: set = set()
            for r in kept:
                apath = os.path.join(
                    scene_dir, f"{r['f1']:05d}_p{r['pt']}_annotated.jpg")
                if apath in submitted or os.path.exists(apath):
                    continue
                submitted.add(apath)
                color = tuple(int(c) for c in rng.integers(0, 256, 3))

                def write_annot(f1=r["f1"], apath=apath, color=color,
                                x=int(r["x1"] / 1000 * w),
                                y=int(r["y1"] / 1000 * h)):
                    img = jpeg.imdecode(record["images_jpeg_bytes"][f1])
                    radius = max(w // 100, 1)
                    circle(img, (x, y), radius, color)
                    jpeg.imwrite(apath, img)

                pool.submit(write_annot, key=apath)


def generate_to_jsonl(
    scene_records: dict[str, dict],
    output_file: str,
    config: ObjectMovementConfig | None = None,
    img_output_dir: str | None = None,
    max_samples: int = -1,
    eval_mode: bool = False,
    force_python: bool = False,
    device="cuda",
) -> EngineOutputs:
    """Columnar fast path: same rng order as :func:`generate`, records
    emitted by the template VM (byte-compatible with json.dumps of the
    dict path, including the float displacement gt); M5 runs on
    `device`."""
    from .fast_jsonl import OP_FLT, OP_INT, OP_STR, EmitProgram

    config = config or ObjectMovementConfig()
    rng = stream(config.seed, "object_movement", config.question_type,
                 "eval" if eval_mode else "train")
    qtype = config.question_type
    keys = ("sid", "f1", "f2", "pt", "f1s", "f2s", "x1", "y1", "x2", "y2",
            "h", "w", "pm", "cm", "dist_mm_round", "dist_mm_trunc",
            "vx", "vy", "vz", "g0", "g1", "g2", "t_idx", "q_idx", "a_idx")
    cols: dict[str, list] = {k: [] for k in keys}
    pool = AnnotationPool()
    for scene_id in sorted(scene_records.keys()):
        srng = stream(config.seed, "object_movement", config.question_type,
                      "eval" if eval_mode else "train", scene_id)
        _sequence_columns(scene_id, scene_records[scene_id], config, srng,
                          img_output_dir, pool, cols, device)
    pool.close()

    n = len(cols["sid"])
    p = EmitProgram(n)
    sid_c = p.add_str_col(cols["sid"])
    f1s_c = p.add_str_col(cols["f1s"])
    f2s_c = p.add_str_col(cols["f2s"])
    ints = {k: p.add_int_col(cols[k]) for k in keys
            if k not in ("sid", "f1s", "f2s", "g0", "g1", "g2")}
    flts = {k: p.add_float_col(cols[k]) for k in ("g0", "g1", "g2")}

    field_ops = {
        "x1": [(OP_INT, ints["x1"], 0)], "y1": [(OP_INT, ints["y1"], 0)],
        "total_distance": [(OP_INT, ints["dist_mm_round"], 0)],
        "x_value": [(OP_INT, ints["vx"], 0)],
        "y_value": [(OP_INT, ints["vy"], 0)],
        "z_value": [(OP_INT, ints["vz"], 0)],
    }
    sel_task = p.make_select(ints["t_idx"], [
        p.ops_for(lambda o, t=t: p.lit_json(o, t))
        for t in T.TASK_DESCRIPTION])
    sel_q = p.make_select(ints["q_idx"], [
        p.template_subprogram(t, field_ops)
        for t in T.QUESTION_TEMPLATES[qtype]])
    sel_a = p.make_select(ints["a_idx"], [
        p.template_subprogram(t, field_ops)
        for t in T.ANSWER_TEMPLATES[qtype]])
    # "The point did not move. " prefix when point_moving == 0
    sel_prefix = p.make_select(ints["pm"], [
        p.ops_for(lambda o: p.lit_json(o, "The point did not move. ")),
        p.ops_for(lambda o: None),
    ])
    sel_bool_pm = p.make_select(ints["pm"], [
        p.ops_for(lambda o: p.lit(o, "0")),
        p.ops_for(lambda o: p.lit(o, "1"))])
    sel_bool_cm = p.make_select(ints["cm"], [
        p.ops_for(lambda o: p.lit(o, "0")),
        p.ops_for(lambda o: p.lit(o, "1"))])

    main: list[tuple] = []
    p.lit(main, '{"id": "')
    main.append((OP_STR, sid_c, 0)); p.lit(main, "_")
    main.append((OP_INT, ints["f1"], 0)); p.lit(main, "_")
    main.append((OP_INT, ints["f2"], 0)); p.lit(main, "_")
    main.append((OP_INT, ints["pt"], 0))
    p.lit(main, '", "image": ["')
    main.append((OP_STR, sid_c, 0)); p.lit(main, "/")
    main.append((OP_STR, f1s_c, 0))
    if config.dot_variant:
        p.lit(main, "_p"); main.append((OP_INT, ints["pt"], 0))
        p.lit(main, '_annotated.jpg", "')
    else:
        p.lit(main, '.jpg", "')
    main.append((OP_STR, sid_c, 0)); p.lit(main, "/")
    main.append((OP_STR, f2s_c, 0)); p.lit(main, '.jpg"], ')
    # object-movement eval KEEPS conversations
    # (single_object_movement_engine_dot.py:655-658)
    p.lit(main, '"conversations": [{"from": "human", "value": "')
    main.append(sel_task); p.lit(main, "\\n"); main.append(sel_q)
    p.lit(main, '"}, {"from": "gpt", "value": "')
    main.append(sel_prefix); main.append(sel_a)
    p.lit(main, '"}], ')
    p.lit(main, '"height_list": [')
    main.append((OP_INT, ints["h"], 0)); p.lit(main, ", ")
    main.append((OP_INT, ints["h"], 0))
    p.lit(main, '], "width_list": [')
    main.append((OP_INT, ints["w"], 0)); p.lit(main, ", ")
    main.append((OP_INT, ints["w"], 0))
    p.lit(main, '], "gt_value": ')
    if "total_distance" in qtype:
        main.append((OP_INT, ints["dist_mm_trunc"], 0))
    else:
        p.lit(main, "[")
        main.append((OP_FLT, flts["g0"], 0)); p.lit(main, ", ")
        main.append((OP_FLT, flts["g1"], 0)); p.lit(main, ", ")
        main.append((OP_FLT, flts["g2"], 0))
        p.lit(main, "]")
    p.lit(main, f', "question_type": "{qtype}", "point_moving": ')
    main.append(sel_bool_pm)
    p.lit(main, ', "cam_moving": ')
    main.append(sel_bool_cm)
    p.lit(main, ', "p1": [')
    main.append((OP_INT, ints["x1"], 0)); p.lit(main, ", ")
    main.append((OP_INT, ints["y1"], 0))
    p.lit(main, '], "p2": [')
    main.append((OP_INT, ints["x2"], 0)); p.lit(main, ", ")
    main.append((OP_INT, ints["y2"], 0))
    if eval_mode:
        p.lit(main, '], "text": "')
        main.append(sel_task); p.lit(main, "\\n"); main.append(sel_q)
        p.lit(main, '"}')
    else:
        p.lit(main, ']}')

    out = EngineOutputs()
    if eval_mode:
        # full _orig dump in original order, then subsample (no shuffle)
        p.emit(main, output_file.replace(".jsonl", "_orig.jsonl"),
               row_order=np.arange(n), force_python=force_python)
        order = np.arange(n)
        if 0 < max_samples < n:
            order = rng.choice(n, size=max_samples, replace=False)
        p.emit(main, output_file, row_order=order,
               force_python=force_python)
        out.val_path, out.n_val = output_file, len(order)
        return out
    order = np.arange(n)
    if 0 < max_samples < n:
        order = rng.choice(n, size=max_samples, replace=False)
    order = order[rng.permutation(len(order))]
    p.emit(main, output_file, row_order=order, force_python=force_python)
    out.train_path, out.n_train = output_file, len(order)
    return out
