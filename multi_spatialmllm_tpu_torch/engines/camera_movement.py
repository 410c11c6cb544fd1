"""Camera-movement QA engine (L4).

The port of multi_spatialmllm_tpu/engines/camera_movement.py (PyTorch for
the device path), replacing
`spatial_engine/camera_movement/camera_movement_engine_train_val.py`: the
reference loops over sampled pairs computing two 4x4 inverses + a matmul per
row in Python (:153-245, ~4 min per 1M samples). Here the ground-truth math
for *all* sampled pairs is one batched device program (`inv(E1) @ E2` over
`[n, 4, 4]` stacks), and only text formatting stays on host.

Semantics parity, per build_training_sample (:153-245):
  * 50% random image swap with yaw/pitch negation (:163-167),
  * yaw wrapped into +-180 (:168-172),
  * displacement expressed in frame 1 (:184-190),
  * consistency assert |distance - parquet distance| < 0.1 (:193),
  * answer-value mapping: x>0 -> "right", y>0 -> "down", z>0 -> "forward",
    yaw>0 -> "left", pitch>0 -> "up"; mm = int(m*1000); deg = int(abs(deg))
    (:209-225) — note the reference uses *truncating* int(), not round().
  * sample dict schema (:234-243) and eval conversion (:247-269).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import geometry as G
from ..core.rng import ENGINE_SEEDS, stream
from ..core.scene import SceneStore
from .base import EngineOutputs, make_conversation
from .sampling import sample_overlap_balanced
from .templates import camera_movement as T

QUESTION_TYPES = (
    "x_movement", "y_movement", "z_movement", "yaw_movement",
    "pitch_movement", "yaw_angle", "pitch_angle", "total_distance",
    "displacement_vector",
)

# Reference sample volumes (camera_movement_engine_train_val.py:369-390).
TRAIN_QUESTION_SAMPLES = {
    "x_movement": 1_000_000, "y_movement": 1_000_000, "z_movement": 1_000_000,
    "yaw_movement": 1_000_000, "pitch_movement": 1_000_000,
    "yaw_angle": 1_000_000, "pitch_angle": 1_000_000,
    "total_distance": 3_000_000, "displacement_vector": 3_000_000,
}
VAL_QUESTION_SAMPLES = {q: 300 for q in QUESTION_TYPES}


@dataclasses.dataclass
class CameraMovementConfig:
    overlap_min: float = 6.0
    overlap_max: float = 35.0
    interval: float = 1.0
    seed: int = ENGINE_SEEDS["camera_movement"]
    distance_consistency_tol: float = 0.1
    chunk: int = 1_000_000


def _batched_displacement(E1, E2):
    """`[n, 3]` displacement of camera 2 in camera 1 coordinates."""
    return G.displacement_in_frame1(E1, E2)


def compute_displacements(E1: np.ndarray, E2: np.ndarray, chunk: int,
                          device: bool | str = False) -> np.ndarray:
    """Displacement of camera 2 in camera 1's frame for `[n, 4, 4]` stacks.

    Host float64 path (default): both extrinsics are rigid, so
    `inv(E1) @ E2` has translation `R1^T (t2 - t1)` — one vectorized
    einsum, exact in f64 at NumPy speed (TPU-emulated f64 matmuls are an
    order of magnitude slower than host einsum at these tiny shapes).

    Device path (`device=True` for the card, or a torch device name):
    `chunk` pairs a dispatch through `geometry.displacement_in_frame1`,
    in the stacks' dtype.
    """
    if not device:
        t_delta = E2[:, :3, 3] - E1[:, :3, 3]
        return np.einsum("nji,nj->ni", E1[:, :3, :3], t_delta)
    dev = torch.device("cuda" if device is True else device)
    n = E1.shape[0]
    out = np.empty((n, 3), dtype=E1.dtype)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        out[lo:hi] = _batched_displacement(
            torch.from_numpy(E1[lo:hi]).to(dev),
            torch.from_numpy(E2[lo:hi]).to(dev)).cpu().numpy()
    return out


def _gather_pair_extrinsics(store: SceneStore, scene_ids, image1, image2):
    """Stack aligned extrinsics for every sampled pair: two `[n, 4, 4]`.

    Fully vectorized: rows are grouped per scene and image ids resolved by
    `searchsorted` against the scene's sorted id array (the reference does
    two dict lookups + two 4x4 copies per row in Python)."""
    n = len(scene_ids)
    E1 = np.empty((n, 4, 4), dtype=np.float64)
    E2 = np.empty((n, 4, 4), dtype=np.float64)
    hw = np.empty((n, 2), dtype=np.int64)
    sids = np.asarray(scene_ids, dtype=object)
    unique_sids, inverse = np.unique(sids.astype(str), return_inverse=True)
    img1 = np.asarray(image1, dtype=str)
    img2 = np.asarray(image2, dtype=str)
    for u, sid in enumerate(unique_sids):
        rows = np.where(inverse == u)[0]
        scene = store.get(str(sid))
        ext = scene.extrinsics_align()
        ids = np.asarray(scene.image_ids, dtype=str)  # sorted by contract
        i1 = np.clip(np.searchsorted(ids, img1[rows]), 0, len(ids) - 1)
        i2 = np.clip(np.searchsorted(ids, img2[rows]), 0, len(ids) - 1)
        # searchsorted returns an insertion point even for ids absent from
        # the scene (stale/foreign relations table); fail loudly instead of
        # gathering the wrong extrinsic.
        if not (np.array_equal(ids[i1], img1[rows])
                and np.array_equal(ids[i2], img2[rows])):
            missing = sorted(set(img1[rows][ids[i1] != img1[rows]])
                             | set(img2[rows][ids[i2] != img2[rows]]))
            raise KeyError(
                f"relations rows reference image ids absent from scene "
                f"{sid}: {missing[:5]}{'...' if len(missing) > 5 else ''}")
        E1[rows] = ext[i1]
        E2[rows] = ext[i2]
        hw[rows] = scene.image_hw
    return E1, E2, hw


def build_answer_values(disp: np.ndarray, yaw: float, pitch: float) -> dict:
    """Value mapping parity (camera_movement_engine_train_val.py:209-225)."""
    return {
        "x_movement": "right" if disp[0] > 0 else "left",
        "y_movement": "down" if disp[1] > 0 else "up",
        "z_movement": "forward" if disp[2] > 0 else "backward",
        "yaw_movement": "left" if yaw > 0 else "right",
        "pitch_movement": "up" if pitch > 0 else "down",
        "x_distance": int(abs(disp[0]) * 1000),
        "y_distance": int(abs(disp[1]) * 1000),
        "z_distance": int(abs(disp[2]) * 1000),
        "yaw_angle": int(abs(yaw)),
        "pitch_angle": int(abs(pitch)),
        "x_value": int(disp[0] * 1000),
        "y_value": int(disp[1] * 1000),
        "z_value": int(disp[2] * 1000),
        "total_distance": int(np.linalg.norm(disp) * 1000),
        "displacement_vector": disp.tolist(),
    }


def build_answer_values_batch(disp: np.ndarray, yaw: np.ndarray,
                              pitch: np.ndarray) -> list[dict]:
    """Vectorized variant of :func:`build_answer_values` for the hot path:
    all numeric conversions happen as array ops (the reference does ~15
    Python-float conversions per row, camera_movement_engine_train_val.py
    :209-225); the final per-row dict assembly uses plain Python ints from
    `tolist()`. `int()` truncates toward zero, matching the reference."""
    n = disp.shape[0]
    x_right = (disp[:, 0] > 0)
    y_down = (disp[:, 1] > 0)
    z_fwd = (disp[:, 2] > 0)
    yaw_left = yaw > 0
    pitch_up = pitch > 0
    abs_mm = np.trunc(np.abs(disp) * 1000).astype(np.int64)
    val_mm = np.trunc(disp * 1000).astype(np.int64)
    yaw_i = np.trunc(np.abs(yaw)).astype(np.int64)
    pitch_i = np.trunc(np.abs(pitch)).astype(np.int64)
    total = np.trunc(np.linalg.norm(disp, axis=1) * 1000).astype(np.int64)
    cols = (x_right.tolist(), y_down.tolist(), z_fwd.tolist(),
            yaw_left.tolist(), pitch_up.tolist(),
            abs_mm.tolist(), val_mm.tolist(), yaw_i.tolist(),
            pitch_i.tolist(), total.tolist(), disp.tolist())
    out = []
    for k in range(n):
        (xr, yd, zf, yl, pu, amm, vmm, yi, pi, tot, dv) = (
            cols[0][k], cols[1][k], cols[2][k], cols[3][k], cols[4][k],
            cols[5][k], cols[6][k], cols[7][k], cols[8][k], cols[9][k],
            cols[10][k])
        out.append({
            "x_movement": "right" if xr else "left",
            "y_movement": "down" if yd else "up",
            "z_movement": "forward" if zf else "backward",
            "yaw_movement": "left" if yl else "right",
            "pitch_movement": "up" if pu else "down",
            "x_distance": amm[0], "y_distance": amm[1], "z_distance": amm[2],
            "yaw_angle": yi, "pitch_angle": pi,
            "x_value": vmm[0], "y_value": vmm[1], "z_value": vmm[2],
            "total_distance": tot,
            "displacement_vector": dv,
        })
    return out


class PreparedRelations:
    """Numeric-index view of a frame-relations table bound to a SceneStore.

    Column conversion (pandas/arrow -> numpy) and image-id -> extrinsic
    resolution run ONCE per table and amortize across question types and
    passes — a real campaign draws all nine question types from one
    relations table (the reference re-does two dict lookups + two 4x4
    copies per ROW per type, camera_movement_engine_train_val.py:150-158).
    Accepted anywhere `relations` is (generate_to_jsonl, generate,
    build_sample_columns); sampling, swap, and GT math are unchanged —
    outputs are byte-identical to the unprepared path (test-asserted)."""

    def __init__(self, relations, store: SceneStore):
        self.store = store  # gathers are only valid against this store
        self.columns = {c: np.asarray(relations[c]) for c in
                        ("scene_id", "image_id1", "image_id2", "overlap",
                         "distance", "yaw", "pitch")}
        sids = self.columns["scene_id"].astype(str)
        self.unique_sids, self.scene_idx = np.unique(sids,
                                                     return_inverse=True)
        n_scenes = len(self.unique_sids)
        scenes = [store.get(str(sid)) for sid in self.unique_sids]
        # ragged flat layout (offsets per scene), NOT dense
        # [n_scenes, i_max] padding: at campaign scale one multi-
        # thousand-frame scene would pad every other scene to it
        self.ext_off = np.zeros(n_scenes, dtype=np.int64)
        total = 0
        for u, scene in enumerate(scenes):
            self.ext_off[u] = total
            total += scene.num_images
        self.ext_flat = np.zeros((total, 4, 4), dtype=np.float64)
        self.hw_all = np.zeros((n_scenes, 2), dtype=np.int64)
        img1 = self.columns["image_id1"].astype(str)
        img2 = self.columns["image_id2"].astype(str)
        # global image-id string codes: the emit program's string
        # columns skip per-call dedup (fast_jsonl.add_coded_str_col)
        self.img_strings, inv = np.unique(
            np.concatenate([img1, img2]), return_inverse=True)
        self.im1_codes = inv[: len(img1)].astype(np.int64)
        self.im2_codes = inv[len(img1):].astype(np.int64)
        self.i1 = np.zeros(len(img1), dtype=np.int64)
        self.i2 = np.zeros(len(img2), dtype=np.int64)
        for u, scene in enumerate(scenes):
            ext = scene.extrinsics_align()
            self.ext_flat[self.ext_off[u]: self.ext_off[u] + len(ext)] = ext
            self.hw_all[u] = scene.image_hw
            rows = np.where(self.scene_idx == u)[0]
            ids = np.asarray(scene.image_ids, dtype=str)  # sorted
            a1 = np.clip(np.searchsorted(ids, img1[rows]), 0, len(ids) - 1)
            a2 = np.clip(np.searchsorted(ids, img2[rows]), 0, len(ids) - 1)
            if not (np.array_equal(ids[a1], img1[rows])
                    and np.array_equal(ids[a2], img2[rows])):
                missing = sorted(
                    set(img1[rows][ids[a1] != img1[rows]])
                    | set(img2[rows][ids[a2] != img2[rows]]))
                raise KeyError(
                    f"relations rows reference image ids absent from "
                    f"scene {scene.scene_id}: {missing[:5]}"
                    f"{'...' if len(missing) > 5 else ''}")
            self.i1[rows] = a1
            self.i2[rows] = a2

    def __getitem__(self, c):  # mapping compatibility (column access)
        return self.columns[c]


def prepare_relations(relations, store: SceneStore) -> PreparedRelations:
    """See :class:`PreparedRelations` (idempotent for the same store;
    rebinds — re-resolving extrinsics — when given a different one)."""
    if isinstance(relations, PreparedRelations):
        if relations.store is store:
            return relations
        return PreparedRelations(relations.columns, store)
    return PreparedRelations(relations, store)


def build_sample_columns(
    relations,
    store: SceneStore,
    question_type: str,
    desired_count: int,
    config: CameraMovementConfig | None = None,
    rng: np.random.Generator | None = None,
) -> dict:
    """Columnar sample bundle for one question type: balanced sampling,
    swap/wrap, batched device pose math, and pre-drawn template indices.
    Both the Python dict assembly and the native JSONL emitter consume
    this bundle, so their contents are identical."""
    config = config or CameraMovementConfig()
    if rng is None:
        rng = stream(config.seed, "camera_movement", question_type)

    prep = relations if isinstance(relations, PreparedRelations) else None
    if prep is not None and prep.store is not store:
        raise ValueError(
            "PreparedRelations was built against a different SceneStore; "
            "its extrinsic gathers would be wrong — re-run "
            "prepare_relations(prep, store)")
    cols = prep.columns if prep is not None else {
        c: np.asarray(relations[c]) for c in
        ("scene_id", "image_id1", "image_id2", "overlap", "distance",
         "yaw", "pitch")}
    idx = sample_overlap_balanced(
        cols["overlap"], desired_count, rng,
        overlap_min=config.overlap_min, overlap_max=config.overlap_max,
        interval=config.interval,
    )
    n = len(idx)
    scene_ids = cols["scene_id"][idx]
    image1 = cols["image_id1"][idx].astype(object)
    image2 = cols["image_id2"][idx].astype(object)
    yaw = cols["yaw"][idx].astype(np.float64).copy()
    pitch = cols["pitch"][idx].astype(np.float64).copy()
    overlap = cols["overlap"][idx].astype(np.float64)
    ref_distance = cols["distance"][idx].astype(np.float64)

    # 50% swap with sign negation (:163-167).
    swap = rng.random(n) < 0.5
    yaw[swap] = -yaw[swap]
    pitch[swap] = -pitch[swap]
    image1[swap], image2[swap] = image2[swap].copy(), image1[swap].copy()

    # yaw wrap (:168-172).
    yaw = np.where(yaw > 180.0, yaw - 360.0, yaw)
    yaw = np.where(yaw < -180.0, yaw + 360.0, yaw)

    # Batched GT math on device.
    coded = {}
    if prep is not None:  # pure integer gather, resolution precomputed
        si = prep.scene_idx[idx]
        a1 = np.where(swap, prep.i2[idx], prep.i1[idx])
        a2 = np.where(swap, prep.i1[idx], prep.i2[idx])
        base = prep.ext_off[si]
        E1 = prep.ext_flat[base + a1]
        E2 = prep.ext_flat[base + a2]
        hw = prep.hw_all[si]
        coded = {  # pre-factored string columns for the emit program
            "scene_codes": si, "scene_strings": prep.unique_sids,
            "img1_codes": np.where(swap, prep.im2_codes[idx],
                                   prep.im1_codes[idx]),
            "img2_codes": np.where(swap, prep.im1_codes[idx],
                                   prep.im2_codes[idx]),
            "img_strings": prep.img_strings,
        }
    else:
        E1, E2, hw = _gather_pair_extrinsics(store, scene_ids, image1,
                                             image2)
    disp = compute_displacements(E1, E2, config.chunk)
    dist = np.linalg.norm(disp, axis=1)
    bad = np.abs(dist - ref_distance) >= config.distance_consistency_tol
    if bad.any():
        k = int(np.where(bad)[0][0])
        raise AssertionError(
            f"distance inconsistency for {scene_ids[k]} {image1[k]} "
            f"{image2[k]}: {dist[k]} vs {ref_distance[k]}"
        )

    if (overlap < 0.1).any():
        # reference raises NotImplementedError (:199-201); pairs are
        # sampled from overlap >= overlap_min so this cannot trigger.
        raise NotImplementedError("overlap < 0.1 is not supported.")

    return {
        "n": n,
        "question_type": question_type,
        "scene_ids": scene_ids,
        "image1": image1,
        "image2": image2,
        "yaw": yaw,
        "pitch": pitch,
        "disp": disp,
        "hw": hw,
        "t_idx": rng.integers(len(T.TASK_DESCRIPTION), size=n),
        "q_idx": rng.integers(
            len(T.QUESTION_TEMPLATES[question_type]), size=n),
        "a_idx": rng.integers(
            len(T.ANSWER_TEMPLATES[question_type]), size=n),
        **coded,
    }


def build_samples_for_question_type(
    relations,
    store: SceneStore,
    question_type: str,
    desired_count: int,
    config: CameraMovementConfig | None = None,
    rng: np.random.Generator | None = None,
) -> list[dict]:
    """Balanced-sample pairs and build train samples for one question type.

    `relations` is the frame-relations DataFrame (or any mapping of column
    name -> array with scene_id/image_id1/image_id2/overlap/distance/yaw/
    pitch).
    """
    cols = build_sample_columns(relations, store, question_type,
                                desired_count, config, rng)
    return assemble_samples(cols)


def assemble_samples(cols: dict) -> list[dict]:
    """Python dict assembly of a columnar bundle (reference schema)."""
    n = cols["n"]
    question_type = cols["question_type"]
    scene_ids, image1, image2 = cols["scene_ids"], cols["image1"], cols["image2"]
    values_list = build_answer_values_batch(cols["disp"], cols["yaw"],
                                            cols["pitch"])
    tasks = T.TASK_DESCRIPTION
    qbank = T.QUESTION_TEMPLATES[question_type]
    abank = T.ANSWER_TEMPLATES[question_type]
    t_idx = cols["t_idx"].tolist()
    q_idx = cols["q_idx"].tolist()
    a_idx = cols["a_idx"].tolist()
    heights = cols["hw"][:, 0].tolist()
    widths = cols["hw"][:, 1].tolist()

    samples = []
    for k in range(n):
        values = values_list[k]
        answer = abank[a_idx[k]].format(**values)
        samples.append({
            "id": k,
            "image": [f"{scene_ids[k]}/{image1[k]}.jpg",
                      f"{scene_ids[k]}/{image2[k]}.jpg"],
            "conversations": make_conversation(
                f"{tasks[t_idx[k]]}\n{qbank[q_idx[k]]}", answer),
            "height_list": [heights[k]] * 2,
            "width_list": [widths[k]] * 2,
            "answer_values": values,
            "question_type": question_type,
            "gt_value": values[question_type],
        })
    return samples


def _emit_program(cols: dict, eval_mode: bool = False):
    """Compile the record layout into a fast_jsonl program (byte-identical
    to json.dumps of assemble_samples output)."""
    from .fast_jsonl import EmitProgram

    n = cols["n"]
    qtype = cols["question_type"]
    disp = cols["disp"]
    yaw, pitch = cols["yaw"], cols["pitch"]
    p = EmitProgram(n)

    if "scene_codes" in cols:  # PreparedRelations: pre-factored strings
        sid = p.add_coded_str_col(cols["scene_codes"],
                                  cols["scene_strings"])
        img1 = p.add_coded_str_col(cols["img1_codes"], cols["img_strings"])
        img2 = p.add_coded_str_col(cols["img2_codes"], cols["img_strings"])
    else:
        sid = p.add_str_col(cols["scene_ids"])
        img1 = p.add_str_col(cols["image1"])
        img2 = p.add_str_col(cols["image2"])
    c_id = p.add_int_col(np.arange(n))
    c_h = p.add_int_col(cols["hw"][:, 0])
    c_w = p.add_int_col(cols["hw"][:, 1])
    c_task = p.add_int_col(cols["t_idx"])
    c_q = p.add_int_col(cols["q_idx"])
    c_a = p.add_int_col(cols["a_idx"])

    abs_mm = np.trunc(np.abs(disp) * 1000).astype(np.int64)
    val_mm = np.trunc(disp * 1000).astype(np.int64)
    c_dist = [p.add_int_col(abs_mm[:, i]) for i in range(3)]
    c_val = [p.add_int_col(val_mm[:, i]) for i in range(3)]
    c_yaw = p.add_int_col(np.trunc(np.abs(yaw)).astype(np.int64))
    c_pitch = p.add_int_col(np.trunc(np.abs(pitch)).astype(np.int64))
    c_total = p.add_int_col(
        np.trunc(np.linalg.norm(disp, axis=1) * 1000).astype(np.int64))
    c_disp = [p.add_float_col(disp[:, i]) for i in range(3)]

    # Direction selectors: column value 0/1 picks the word.
    def dir_sel(values: np.ndarray, words: tuple[str, str]):
        col = p.add_int_col((values > 0).astype(np.int64))
        return p.make_select(
            col, [[(0, p._lit_id(words[0]), 0)], [(0, p._lit_id(words[1]), 0)]])

    sel_x = dir_sel(disp[:, 0], ("left", "right"))
    sel_y = dir_sel(disp[:, 1], ("up", "down"))
    sel_z = dir_sel(disp[:, 2], ("backward", "forward"))
    sel_yaw = dir_sel(yaw, ("right", "left"))
    sel_pitch = dir_sel(pitch, ("down", "up"))  # "up" if pitch > 0

    field_ops = {
        "x_movement": [sel_x], "y_movement": [sel_y], "z_movement": [sel_z],
        "yaw_movement": [sel_yaw], "pitch_movement": [sel_pitch],
        "x_distance": [(2, c_dist[0], 0)], "y_distance": [(2, c_dist[1], 0)],
        "z_distance": [(2, c_dist[2], 0)],
        "yaw_angle": [(2, c_yaw, 0)], "pitch_angle": [(2, c_pitch, 0)],
        "x_value": [(2, c_val[0], 0)], "y_value": [(2, c_val[1], 0)],
        "z_value": [(2, c_val[2], 0)], "total_distance": [(2, c_total, 0)],
    }

    task_sub = [p.ops_for(lambda ops, t=t: p.lit_json(ops, t))
                for t in T.TASK_DESCRIPTION]
    q_sub = [p.ops_for(lambda ops, t=t: p.lit_json(ops, t))
             for t in T.QUESTION_TEMPLATES[qtype]]
    a_sub = [p.template_subprogram(t, field_ops)
             for t in T.ANSWER_TEMPLATES[qtype]]
    sel_task = p.make_select(c_task, task_sub)
    sel_q = p.make_select(c_q, q_sub)
    sel_a = p.make_select(c_a, a_sub)

    main: list[tuple] = []
    p.lit(main, '{"id": ')
    main.append((2, c_id, 0))
    p.lit(main, ', "image": ["')
    main.append((1, sid, 0)); p.lit(main, "/"); main.append((1, img1, 0))
    p.lit(main, '.jpg", "')
    main.append((1, sid, 0)); p.lit(main, "/"); main.append((1, img2, 0))
    p.lit(main, '.jpg"], ')
    if not eval_mode:
        p.lit(main, '"conversations": [{"from": "human", "value": "')
        main.append(sel_task); p.lit(main, "\\n"); main.append(sel_q)
        p.lit(main, '"}, {"from": "gpt", "value": "')
        main.append(sel_a)
        p.lit(main, '"}], ')
    p.lit(main, '"height_list": [')
    main.append((2, c_h, 0)); p.lit(main, ", "); main.append((2, c_h, 0))
    p.lit(main, '], "width_list": [')
    main.append((2, c_w, 0)); p.lit(main, ", "); main.append((2, c_w, 0))
    p.lit(main, '], "answer_values": {"x_movement": "')
    main.append(sel_x)
    p.lit(main, '", "y_movement": "'); main.append(sel_y)
    p.lit(main, '", "z_movement": "'); main.append(sel_z)
    p.lit(main, '", "yaw_movement": "'); main.append(sel_yaw)
    p.lit(main, '", "pitch_movement": "'); main.append(sel_pitch)
    p.lit(main, '", "x_distance": '); main.append((2, c_dist[0], 0))
    p.lit(main, ', "y_distance": '); main.append((2, c_dist[1], 0))
    p.lit(main, ', "z_distance": '); main.append((2, c_dist[2], 0))
    p.lit(main, ', "yaw_angle": '); main.append((2, c_yaw, 0))
    p.lit(main, ', "pitch_angle": '); main.append((2, c_pitch, 0))
    p.lit(main, ', "x_value": '); main.append((2, c_val[0], 0))
    p.lit(main, ', "y_value": '); main.append((2, c_val[1], 0))
    p.lit(main, ', "z_value": '); main.append((2, c_val[2], 0))
    p.lit(main, ', "total_distance": '); main.append((2, c_total, 0))
    p.lit(main, ', "displacement_vector": [')
    main.append((3, c_disp[0], 0)); p.lit(main, ", ")
    main.append((3, c_disp[1], 0)); p.lit(main, ", ")
    main.append((3, c_disp[2], 0))
    p.lit(main, ']}, "question_type": ')
    p.lit(main, f'"{qtype}", "gt_value": ')
    if qtype in ("x_movement", "y_movement", "z_movement", "yaw_movement",
                 "pitch_movement"):
        p.lit(main, '"')
        main.append({"x_movement": sel_x, "y_movement": sel_y,
                     "z_movement": sel_z, "yaw_movement": sel_yaw,
                     "pitch_movement": sel_pitch}[qtype])
        p.lit(main, '"')
    elif qtype == "displacement_vector":
        p.lit(main, '[')
        main.append((3, c_disp[0], 0)); p.lit(main, ", ")
        main.append((3, c_disp[1], 0)); p.lit(main, ", ")
        main.append((3, c_disp[2], 0))
        p.lit(main, ']')
    else:
        main.append({"yaw_angle": (2, c_yaw, 0),
                     "pitch_angle": (2, c_pitch, 0),
                     "total_distance": (2, c_total, 0)}.get(
                         qtype, (2, c_total, 0)))
    if eval_mode:
        # eval conversion appends "text" as the trailing key
        # (to_eval_sample parity: conversations popped, text added last)
        p.lit(main, ', "text": "')
        main.append(sel_task); p.lit(main, "\\n"); main.append(sel_q)
        p.lit(main, '"}')
    else:
        p.lit(main, '}')
    return p, main


def generate_to_jsonl(
    relations,
    store: SceneStore,
    question_type: str,
    desired_count: int,
    output_path: str,
    config: CameraMovementConfig | None = None,
    rng: np.random.Generator | None = None,
    eval_mode: bool = False,
    force_python: bool = False,
) -> int:
    """Sampling + device math + native columnar JSONL emission (shuffled).
    ~20x the Python-assembly path on the formatting side; byte-identical
    records. Returns the number of rows written."""
    config = config or CameraMovementConfig()
    if rng is None:
        rng = stream(config.seed, "camera_movement", question_type)
    cols = build_sample_columns(relations, store, question_type,
                                desired_count, config, rng)
    program, main = _emit_program(cols, eval_mode=eval_mode)
    order = rng.permutation(cols["n"])
    program.emit(main, output_path, row_order=order,
                 force_python=force_python)
    return cols["n"]


def generate(
    relations_train,
    relations_val,
    store: SceneStore,
    output_dir_train: str,
    output_dir_val: str,
    train_counts: dict | None = None,
    val_counts: dict | None = None,
    config: CameraMovementConfig | None = None,
) -> dict[str, EngineOutputs]:
    """Full engine run over all question types (main() parity :360-444).
    Uses the columnar emitter (native when built, Python interpreter
    otherwise) — output records are identical to the dict-assembly path."""
    config = config or CameraMovementConfig()
    train_counts = train_counts or TRAIN_QUESTION_SAMPLES
    val_counts = val_counts or VAL_QUESTION_SAMPLES
    # one table resolution shared by all nine question types
    relations_train = prepare_relations(relations_train, store)
    relations_val = prepare_relations(relations_val, store)
    outputs: dict[str, EngineOutputs] = {}
    for qtype, count in train_counts.items():
        out = EngineOutputs()
        out.val_path = f"{output_dir_val}/{qtype}_val.jsonl"
        out.n_val = generate_to_jsonl(
            relations_val, store, qtype, val_counts.get(qtype, 300),
            out.val_path, config,
            stream(config.seed, "camera_movement", qtype, "val"),
            eval_mode=True)

        out.train_path = f"{output_dir_train}/{qtype}_train.jsonl"
        out.n_train = generate_to_jsonl(
            relations_train, store, qtype, count, out.train_path, config,
            stream(config.seed, "camera_movement", qtype, "train"))
        outputs[qtype] = out
    return outputs
