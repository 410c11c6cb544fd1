"""Depth-perception QA engines: estimation and comparison, coor and dot.

TPU-native replacement for the four reference engines
(`spatial_engine/depth_perception/depth_{estimation,comparison}_{coor,dot}_
engine.py`). The reference re-reads the depth PNG from disk for every
sampled point via `get_point_2d_coordinates_in_image` (info_handler.py
:291-305 — the dominant cost, 51 min-1.5 h per split); here points are
reprojected in bulk from the in-memory scene pack, with the same float64
math and visibility re-check.

Semantics parity (depth_estimation_coor_engine.py unless noted):
  * per-scene quota `max(all_max_samples // n_scenes + 1, 1)`; when the
    quota is 1 a random subset of `all_max_samples` scenes is used
    (:260-267),
  * images sampled without replacement (with replacement when the quota
    exceeds the image count — comparison engines, depth_comparison_coor
    :246-255),
  * one (estimation) or two (comparison) visible points per image from the
    visibility index, re-checked by reprojection, skipped with a warning if
    the re-check fails (:207-213),
  * x,y = round(px/extent*1000); depth = round(m*1000) (:216-218),
  * comparison: equal-depth pairs skipped (coor :289-294) / retried up to
    10 times (dot :262-310); A/B labels shuffled; closer/farther question
    chosen at random (:296-325),
  * final pool subsampled to `all_max_samples` and shuffled (:273-276),
  * eval = train with conversations[0] lifted to `text` (:289-306).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.io import WarningSink
from ..core.rng import ENGINE_SEEDS, stream
from ..core.scene import Scene, SceneStore
from ..core.synthetic import np_project_points
from ..stages.visibility import VisibilityIndex
from .annotate import (
    AnnotatedJpegWriter,
    AnnotationPool,
    ImageProvider,
    generate_distinct_colors,
)
from .base import (
    EngineOutputs,
    choice,
    make_conversation,
    normalized_coord,
    shuffle_and_write,
    subsample,
    to_eval_sample,
)
from .templates import depth as T


@dataclasses.dataclass
class DepthEngineConfig:
    all_max_samples: int = -1
    max_n_points_per_image: int = 1
    seed: int = ENGINE_SEEDS["depth_perception"]


def _project_many(scene: Scene, image_index: int, point_indices):
    """Vectorized reprojection of many scene points into one image with the
    visibility re-check (get_point_2d_coordinates_in_image parity, float64).

    Returns (x_px, y_px, depth_m, ok) arrays over `point_indices`.
    """
    E = scene.extrinsic_align(image_index)
    pts = scene.points_aligned[np.asarray(point_indices, dtype=np.int64), :3]
    xy, depth = np_project_points(pts, scene.intrinsic, E)
    x, y = xy[:, 0], xy[:, 1]
    h, w = scene.image_hw
    hd, wd = scene.depth_hw
    inb = (x >= 0) & (x < w) & (y >= 0) & (y < h)
    # precomputed scale factors (x * (wd/w), NOT (x*wd)/w): the reference
    # computes scale_x = depth_width / image_width first
    # (info_handler.py:359-363), and the two orders differ in the last
    # ulp — enough to flip round-half-to-even at exact .5 boundaries.
    sx, sy = wd / w, hd / h
    dx = np.clip(np.round(x * sx), 0, wd - 1).astype(np.int64)
    dy = np.clip(np.round(y * sy), 0, hd - 1).astype(np.int64)
    dv = scene.depth_maps[image_index][dy, dx] * 0.001
    ok = inb & (depth > 0) & (depth < dv)
    return x, y, depth, ok


def _project_point(scene: Scene, image_index: int, point_index: int):
    """Single-point wrapper over :func:`_project_many`. Returns
    (x_px, y_px, depth_m) or None if the visibility re-check fails."""
    x, y, d, ok = _project_many(scene, image_index, [point_index])
    if not ok[0]:
        return None
    return float(x[0]), float(y[0]), float(d[0])


class ProjectionCache:
    """Whole-point-cloud projection memo per (scene, image).

    Engines that look points up one at a time in row order (correspondence,
    multi-round comparison) would otherwise pay a full 4x4-inverse +
    projection per LOOKUP; caching the vectorized all-points projection per
    image turns O(rows) tiny calls into O(unique images) batched ones while
    leaving the callers' rng-draw order untouched (lookups consume no rng).
    """

    def __init__(self, max_bytes: int = 2 << 30):
        # an entry holds x/y/depth f64 + ok for every scene point (~5 MB
        # at 200K points, ~120 KB on small scenes); FIFO-bound by BYTES so
        # production-scale runs stay within host RAM while small-scene
        # runs (thousands of cheap entries) never thrash. The newest entry
        # is always stored, so the effective cap is
        # max(max_bytes, largest single entry).
        self.max_bytes = max_bytes
        self._memo: dict[tuple[str, int], tuple] = {}
        self._bytes = 0

    def project(self, scene: Scene, image_index: int, point_index: int):
        """(x_px, y_px, depth_m) or None — same contract as
        :func:`_project_point`."""
        key = (scene.scene_id, image_index)
        arrays = self._memo.get(key)
        if arrays is None:
            arrays = _project_many(scene, image_index,
                                   np.arange(scene.num_points))
            size = sum(a.nbytes for a in arrays)
            while self._memo and self._bytes + size > self.max_bytes:
                old = self._memo.pop(next(iter(self._memo)))
                self._bytes -= sum(a.nbytes for a in old)
            self._memo[key] = arrays
            self._bytes += size
        x, y, d, ok = arrays
        if not ok[point_index]:
            return None
        return (float(x[point_index]), float(y[point_index]),
                float(d[point_index]))


def _scene_plan(scene_ids: list[str], all_max_samples: int,
                rng: np.random.Generator) -> tuple[list[str], int]:
    """Per-scene quota rule (:260-267)."""
    if all_max_samples > 0:
        quota = max(all_max_samples // len(scene_ids) + 1, 1)
        if quota == 1 and len(scene_ids) > all_max_samples:
            idx = rng.choice(len(scene_ids), size=all_max_samples,
                             replace=False)
            scene_ids = [scene_ids[i] for i in sorted(idx)]
        return scene_ids, quota
    return scene_ids, -1


def _sample_images(image_ids: list[str], quota: int,
                   rng: np.random.Generator, with_replacement_overflow: bool):
    if quota <= 0:
        return list(rng.permutation(image_ids))
    if quota > len(image_ids):
        if with_replacement_overflow:
            return [image_ids[int(i)] for i in
                    rng.integers(len(image_ids), size=quota)]
        return list(rng.permutation(image_ids))
    idx = rng.choice(len(image_ids), size=quota, replace=False)
    return [image_ids[int(i)] for i in idx]


# ---------------------------------------------------------------------------
# Depth estimation (coor + dot)
# ---------------------------------------------------------------------------

def _depth_estimation_columns(
    store: SceneStore,
    vis_index: VisibilityIndex,
    variant: str,
    config: DepthEngineConfig,
    rng: np.random.Generator,
    warn: WarningSink,
    image_provider: ImageProvider | None = None,
    image_output_dir: str | None = None,
) -> dict:
    """Columnar sample bundle for depth estimation (same loop and rng
    order as the dict path; dot-variant annotation happens inline)."""
    banks = ((T.EST_COOR_TASK_DESCRIPTION, T.EST_QUESTIONS_COOR,
              T.EST_ANSWERS_COOR) if variant == "coor" else
             (T.EST_DOT_TASK_DESCRIPTION, T.EST_QUESTIONS_DOT,
              T.EST_ANSWERS_DOT))
    cols: dict[str, list] = {k: [] for k in (
        "sid", "image_id", "point", "x", "y", "depth", "ix", "iy",
        "h", "w", "t_idx", "q_idx", "a_idx")}

    scene_ids, quota = _scene_plan(store.scene_ids(),
                                   config.all_max_samples, rng)
    pool = AnnotationPool()
    writer = (AnnotatedJpegWriter(image_provider, image_output_dir)
              if image_provider is not None and image_output_dir else None)
    for sid in scene_ids:
        scene = store.get(sid)
        h, w = scene.image_hw
        image_ids = scene.valid_image_ids()
        if not image_ids:
            continue
        for image_id in _sample_images(image_ids, quota, rng, False):
            visible = vis_index.image_to_points(sid, image_id)
            if len(visible) == 0:
                warn(f"Warning: image {image_id} in scene {sid} has no "
                     f"visible points.")
                continue
            if len(visible) < config.max_n_points_per_image:
                picks = [int(visible[int(i)]) for i in
                         rng.integers(len(visible),
                                      size=config.max_n_points_per_image)]
            else:
                picks = [int(visible[int(i)]) for i in
                         rng.choice(len(visible),
                                    size=config.max_n_points_per_image,
                                    replace=False)]
            img_index = scene.image_index(image_id)
            xs, ys, ds, oks = _project_many(scene, img_index, picks)
            for j, point in enumerate(picks):
                if not oks[j]:
                    warn(f"Warning: Point-Id {point} is not visible in "
                         f"image {image_id} in scene {sid}.")
                    continue
                x_px, y_px, depth_m = float(xs[j]), float(ys[j]), float(ds[j])
                # rng discipline: template indices are drawn BEFORE the
                # annotation color, matching the dict path's draw order
                # (task/question/answer via choice(), then
                # generate_distinct_colors) so both paths consume the
                # stream identically.
                t_idx = int(rng.integers(len(banks[0])))
                q_idx = int(rng.integers(len(banks[1])))
                a_idx = int(rng.integers(len(banks[2])))
                if variant == "dot" and writer is not None:
                    color = generate_distinct_colors(1, rng)[0]

                    rel = f"{sid}/{image_id}_p{point}_annotated.jpg"

                    def task(sid=sid, image_id=image_id, x=int(x_px),
                             y=int(y_px), color=color, rel=rel):
                        writer.write_dot(sid, image_id, (x, y), color, rel)

                    pool.submit(task, key=rel)
                cols["sid"].append(sid)
                cols["image_id"].append(image_id)
                cols["point"].append(point)
                cols["x"].append(normalized_coord(x_px, w))
                cols["y"].append(normalized_coord(y_px, h))
                cols["depth"].append(int(np.round(depth_m * 1000)))
                cols["ix"].append(int(x_px))
                cols["iy"].append(int(y_px))
                cols["h"].append(h)
                cols["w"].append(w)
                cols["t_idx"].append(t_idx)
                cols["q_idx"].append(q_idx)
                cols["a_idx"].append(a_idx)
    pool.close()
    if writer is not None:
        writer.close()
    cols["n"] = len(cols["sid"])
    cols["variant"] = variant
    return cols


def _depth_estimation_program(cols: dict, eval_mode: bool):
    """fast_jsonl program for depth-estimation records (byte-compatible
    with json.dumps of the dict path)."""
    from .fast_jsonl import OP_INT, OP_STR, EmitProgram

    variant = cols["variant"]
    n = cols["n"]
    p = EmitProgram(n)
    sid = p.add_str_col(cols["sid"])
    img = p.add_str_col(cols["image_id"])
    c_pt = p.add_int_col(cols["point"])
    c_x = p.add_int_col(cols["x"])
    c_y = p.add_int_col(cols["y"])
    c_d = p.add_int_col(cols["depth"])
    c_ix = p.add_int_col(cols["ix"])
    c_iy = p.add_int_col(cols["iy"])
    c_h = p.add_int_col(cols["h"])
    c_w = p.add_int_col(cols["w"])
    c_t = p.add_int_col(cols["t_idx"])
    c_q = p.add_int_col(cols["q_idx"])
    c_a = p.add_int_col(cols["a_idx"])

    field_ops = {"x1": [(OP_INT, c_x, 0)], "y1": [(OP_INT, c_y, 0)],
                 "depth": [(OP_INT, c_d, 0)]}
    if variant == "coor":
        tasks, qs, answers = (T.EST_COOR_TASK_DESCRIPTION,
                              T.EST_QUESTIONS_COOR, T.EST_ANSWERS_COOR)
    else:
        tasks, qs, answers = (T.EST_DOT_TASK_DESCRIPTION,
                              T.EST_QUESTIONS_DOT, T.EST_ANSWERS_DOT)
    sel_task = p.make_select(
        c_t, [p.ops_for(lambda o, t=t: p.lit_json(o, t)) for t in tasks])
    sel_q = p.make_select(
        c_q, [p.template_subprogram(t, field_ops) for t in qs])
    sel_a = p.make_select(
        c_a, [p.template_subprogram(t, field_ops) for t in answers])

    def emit_image(main):
        main.append((OP_STR, sid, 0)); p.lit(main, "/")
        main.append((OP_STR, img, 0))
        if variant == "dot":
            p.lit(main, "_p"); main.append((OP_INT, c_pt, 0))
            p.lit(main, "_annotated.jpg")
        else:
            p.lit(main, ".jpg")

    main: list[tuple] = []
    p.lit(main, '{"id": "')
    main.append((OP_STR, sid, 0)); p.lit(main, "_")
    main.append((OP_STR, img, 0)); p.lit(main, "_point")
    main.append((OP_INT, c_pt, 0))
    p.lit(main, '", "image": ["')
    emit_image(main)
    p.lit(main, '"], ')
    # Reference depth engines KEEP conversations in eval records
    # (depth_estimation_coor_engine.py:289-292 does not pop), so emit it
    # in both modes; eval appends `text` last.
    p.lit(main, '"conversations": [{"from": "human", "value": "')
    main.append(sel_task); p.lit(main, "\\n"); main.append(sel_q)
    p.lit(main, '"}, {"from": "gpt", "value": "')
    main.append(sel_a)
    p.lit(main, '"}], ')
    p.lit(main, '"height_list": [')
    main.append((OP_INT, c_h, 0))
    p.lit(main, '], "width_list": [')
    main.append((OP_INT, c_w, 0))
    p.lit(main, f'], "question_type": "depth_estimation_{variant}", '
                f'"gt_value": ')
    main.append((OP_INT, c_d, 0))
    p.lit(main, ', "ori_coordinates": [')
    main.append((OP_INT, c_ix, 0)); p.lit(main, ", ")
    main.append((OP_INT, c_iy, 0))
    if eval_mode:
        p.lit(main, '], "text": "')
        main.append(sel_task); p.lit(main, "\\n"); main.append(sel_q)
        p.lit(main, '"}')
    else:
        p.lit(main, ']}')
    return p, main


def generate_depth_estimation_to_jsonl(
    store: SceneStore,
    vis_index: VisibilityIndex,
    output_path: str,
    variant: str = "coor",
    config: DepthEngineConfig | None = None,
    eval_mode: bool = False,
    image_provider: ImageProvider | None = None,
    image_output_dir: str | None = None,
    warning_path: str | None = None,
    force_python: bool = False,
) -> EngineOutputs:
    """Columnar fast path: same sampling/annotation loop, records emitted
    by the native template VM (subsample + shuffle folded into row_order).
    """
    assert variant in ("coor", "dot")
    config = config or DepthEngineConfig()
    warn = WarningSink(warning_path)
    rng = stream(config.seed, "depth_estimation", variant,
                 "eval" if eval_mode else "train")
    cols = _depth_estimation_columns(
        store, vis_index, variant, config, rng, warn,
        image_provider, image_output_dir)
    n = cols["n"]
    order = np.arange(n)
    if 0 < config.all_max_samples < n:  # subsample parity (:273-274)
        order = rng.choice(n, size=config.all_max_samples, replace=False)
    order = order[rng.permutation(len(order))]
    program, main = _depth_estimation_program(cols, eval_mode)
    program.emit(main, output_path, row_order=order,
                 force_python=force_python)
    out = EngineOutputs(n_skipped=warn.count)
    if eval_mode:
        out.val_path, out.n_val = output_path, len(order)
    else:
        out.train_path, out.n_train = output_path, len(order)
    return out


def generate_depth_estimation(
    store: SceneStore,
    vis_index: VisibilityIndex,
    output_path: str,
    variant: str = "coor",
    config: DepthEngineConfig | None = None,
    eval_mode: bool = False,
    image_provider: ImageProvider | None = None,
    image_output_dir: str | None = None,
    warning_path: str | None = None,
) -> EngineOutputs:
    assert variant in ("coor", "dot")
    config = config or DepthEngineConfig()
    warn = WarningSink(warning_path)
    rng = stream(config.seed, "depth_estimation", variant,
                 "eval" if eval_mode else "train")
    task_name = f"depth_estimation_{variant}"

    scene_ids, quota = _scene_plan(store.scene_ids(), config.all_max_samples, rng)
    samples: list[dict] = []
    pool = AnnotationPool()
    writer = (AnnotatedJpegWriter(image_provider, image_output_dir)
              if image_provider is not None and image_output_dir else None)
    for sid in scene_ids:
        scene = store.get(sid)
        h, w = scene.image_hw
        image_ids = scene.valid_image_ids()
        if not image_ids:
            continue
        for image_id in _sample_images(image_ids, quota, rng, False):
            visible = vis_index.image_to_points(sid, image_id)
            if len(visible) == 0:
                warn(f"Warning: image {image_id} in scene {sid} has no "
                     f"visible points.")
                continue
            if len(visible) < config.max_n_points_per_image:
                picks = [int(visible[int(i)]) for i in
                         rng.integers(len(visible),
                                      size=config.max_n_points_per_image)]
            else:
                picks = [int(visible[int(i)]) for i in
                         rng.choice(len(visible),
                                    size=config.max_n_points_per_image,
                                    replace=False)]
            img_index = scene.image_index(image_id)
            xs, ys, ds, oks = _project_many(scene, img_index, picks)
            for j, point in enumerate(picks):
                if not oks[j]:
                    warn(f"Warning: Point-Id {point} is not visible in "
                         f"image {image_id} in scene {sid}.")
                    continue
                x_px, y_px, depth_m = float(xs[j]), float(ys[j]), float(ds[j])
                x = normalized_coord(x_px, w)
                y = normalized_coord(y_px, h)
                depth = int(np.round(depth_m * 1000))

                if variant == "coor":
                    task = choice(rng, T.EST_COOR_TASK_DESCRIPTION)
                    question = choice(rng, T.EST_QUESTIONS_COOR).format(x1=x, y1=y)
                    answer = choice(rng, T.EST_ANSWERS_COOR).format(
                        x1=x, y1=y, depth=depth)
                    image_rel = f"{sid}/{image_id}.jpg"
                else:
                    task = choice(rng, T.EST_DOT_TASK_DESCRIPTION)
                    question = choice(rng, T.EST_QUESTIONS_DOT)
                    answer = choice(rng, T.EST_ANSWERS_DOT).format(depth=depth)
                    image_rel = f"{sid}/{image_id}_p{point}_annotated.jpg"
                    if writer is not None:
                        color = generate_distinct_colors(1, rng)[0]

                        def task_fn(sid=sid, image_id=image_id,
                                    x=int(x_px), y=int(y_px),
                                    color=color, image_rel=image_rel):
                            writer.write_dot(sid, image_id, (x, y), color,
                                             image_rel)

                        pool.submit(task_fn, key=image_rel)

                samples.append({
                    "id": f"{sid}_{image_id}_point{point}",
                    "image": [image_rel],
                    "conversations": make_conversation(
                        f"{task}\n{question}", answer),
                    "height_list": [h],
                    "width_list": [w],
                    "question_type": task_name,
                    "gt_value": depth,
                    "ori_coordinates": [int(x_px), int(y_px)],
                })

    pool.close()
    if writer is not None:
        writer.close()
    samples = subsample(samples, config.all_max_samples, rng)
    if eval_mode:
        samples = [to_eval_sample(s, keep_conversations=True)
                   for s in samples]
    out = EngineOutputs(n_skipped=warn.count)
    n = shuffle_and_write(samples, output_path, rng)
    if eval_mode:
        out.val_path, out.n_val = output_path, n
    else:
        out.train_path, out.n_train = output_path, n
    return out


# ---------------------------------------------------------------------------
# Depth comparison (coor + dot)
# ---------------------------------------------------------------------------

def generate_depth_comparison_to_jsonl(
    store: SceneStore,
    vis_index: VisibilityIndex,
    output_path: str,
    variant: str = "coor",
    config: DepthEngineConfig | None = None,
    eval_mode: bool = False,
    image_provider: ImageProvider | None = None,
    image_output_dir: str | None = None,
    warning_path: str | None = None,
    force_python: bool = False,
) -> EngineOutputs:
    """Columnar fast path for both comparison variants (records
    byte-compatible with json.dumps of the dict path, same rng order;
    the dot variant replays the dict path's <=10-retry pair loop and
    submits annotation work to the thread pool)."""
    from .fast_jsonl import OP_INT, OP_STR, EmitProgram

    assert variant in ("coor", "dot")
    config = config or DepthEngineConfig()
    warn = WarningSink(warning_path)
    rng = stream(config.seed, "depth_comparison", variant,
                 "eval" if eval_mode else "train")
    dot = variant == "dot"
    task_bank = (T.COMP_DOT_TASK_DESCRIPTION if dot
                 else T.COMP_COOR_TASK_DESCRIPTION)
    closer_q = T.COMP_CLOSER_QUESTIONS_DOT if dot \
        else T.COMP_CLOSER_QUESTIONS_COOR
    farther_q = T.COMP_FARTHER_QUESTIONS_DOT if dot \
        else T.COMP_FARTHER_QUESTIONS_COOR
    closer_a = T.COMP_CLOSER_ANSWERS_DOT if dot else T.COMP_CLOSER_ANSWERS_COOR
    farther_a = T.COMP_FARTHER_ANSWERS_DOT if dot \
        else T.COMP_FARTHER_ANSWERS_COOR
    max_retries = 10 if dot else 1

    keys = ("sid", "image_id", "pid0", "pid1", "gt_x", "gt_y", "gt_l",
            "h", "w", "is_closer", "t_idx", "qa_idx", "aa_idx",
            "p1x", "p1y", "p1d", "p1cx", "p1cy", "p1l",
            "p2x", "p2y", "p2d", "p2cx", "p2cy", "p2l")
    cols: dict[str, list] = {k: [] for k in keys}

    scene_ids, quota = _scene_plan(store.scene_ids(),
                                   config.all_max_samples, rng)
    pool = AnnotationPool()
    writer = (AnnotatedJpegWriter(image_provider, image_output_dir)
              if image_provider is not None and image_output_dir else None)
    for sid in scene_ids:
        scene = store.get(sid)
        h, w = scene.image_hw
        image_ids = scene.valid_image_ids()
        if not image_ids:
            continue
        for image_id in _sample_images(image_ids, quota, rng, True):
            visible = vis_index.image_to_points(sid, image_id)
            if len(visible) < 2:
                continue
            img_index = scene.image_index(image_id)
            vxs, vys, vds, voks = _project_many(scene, img_index, visible)
            for _ in range(config.max_n_points_per_image):
                candidate = None
                for retry in range(max_retries + 1):
                    if retry == max_retries:
                        candidate = None
                        break
                    pick = rng.choice(len(visible), size=2, replace=False)
                    candidate = []
                    for p in pick:
                        if not voks[p]:
                            warn(f"Warning: Point-Id {int(visible[p])} is "
                                 f"not visible in image {image_id} in "
                                 f"scene {sid}.")
                            continue
                        candidate.append({
                            "x": normalized_coord(float(vxs[p]), w),
                            "y": normalized_coord(float(vys[p]), h),
                            "depth": int(np.round(float(vds[p]) * 1000)),
                            "cx": int(float(vxs[p])),
                            "cy": int(float(vys[p])),
                            "pid": int(visible[p]),
                        })
                    if (len(candidate) == 2 and
                            candidate[0]["depth"] != candidate[1]["depth"]):
                        break
                    candidate = None
                if candidate is None:
                    warn(f"Warning: no valid unequal-depth pair in image "
                         f"{image_id} in scene {sid}.")
                    continue
                letters = ["A", "B"]
                rng.shuffle(letters)
                order = rng.permutation(2)
                shuffled = [candidate[int(i)] for i in order]
                p1, p2 = shuffled
                l1, l2 = letters
                closer = p1 if p1["depth"] <= p2["depth"] else p2
                farther = p2 if p1["depth"] <= p2["depth"] else p1
                is_closer = bool(rng.integers(2))
                target = closer if is_closer else farther
                t_idx = int(rng.integers(len(task_bank)))
                qbank = closer_q if is_closer else farther_q
                abank = closer_a if is_closer else farther_a
                q_local = int(rng.integers(len(qbank)))
                a_local = int(rng.integers(len(abank)))
                off_q = 0 if is_closer else len(closer_q)
                off_a = 0 if is_closer else len(closer_a)
                # target's letter: 0 = "A", 1 = "B"
                tgt_is_p1 = target is p1
                gt_l = (0 if (l1 if tgt_is_p1 else l2) == "A" else 1)
                if dot and writer is not None:
                    draws = []
                    for i, info in enumerate(shuffled):
                        color = tuple(int(c) for c in rng.integers(0, 256, 3))
                        draws.append(((info["cx"], info["cy"]),
                                      letters[i], color))
                    image_rel = (f"{sid}/{image_id}_p{candidate[0]['pid']}"
                                 f"_p{candidate[1]['pid']}_annotated.jpg")

                    def task_fn(sid=sid, image_id=image_id, draws=draws,
                                image_rel=image_rel):
                        writer.write_lettered_dots(sid, image_id, draws,
                                                   image_rel)

                    pool.submit(task_fn, key=image_rel)
                row = {
                    "sid": sid, "image_id": image_id,
                    "pid0": candidate[0]["pid"], "pid1": candidate[1]["pid"],
                    "gt_x": target["x"], "gt_y": target["y"], "gt_l": gt_l,
                    "h": h, "w": w, "is_closer": int(is_closer),
                    "t_idx": t_idx, "qa_idx": off_q + q_local,
                    "aa_idx": off_a + a_local,
                    "p1x": p1["x"], "p1y": p1["y"], "p1d": p1["depth"],
                    "p1cx": p1["cx"], "p1cy": p1["cy"],
                    "p1l": 0 if l1 == "A" else 1,
                    "p2x": p2["x"], "p2y": p2["y"], "p2d": p2["depth"],
                    "p2cx": p2["cx"], "p2cy": p2["cy"],
                    "p2l": 0 if l2 == "A" else 1,
                }
                for k in keys:
                    cols[k].append(row[k])
    pool.close()
    if writer is not None:
        writer.close()

    n = len(cols["sid"])
    p = EmitProgram(n)
    sid_c = p.add_str_col(cols["sid"])
    img_c = p.add_str_col(cols["image_id"])
    ints = {k: p.add_int_col(cols[k]) for k in keys
            if k not in ("sid", "image_id")}
    letter_sub = [p.ops_for(lambda o: p.lit(o, "A")),
                  p.ops_for(lambda o: p.lit(o, "B"))]
    sel_gt_l = p.make_select(ints["gt_l"], [list(s) for s in letter_sub])
    field_ops = {
        "x1": [(OP_INT, ints["p1x"], 0)], "y1": [(OP_INT, ints["p1y"], 0)],
        "x2": [(OP_INT, ints["p2x"], 0)], "y2": [(OP_INT, ints["p2y"], 0)],
        "correct_x": [(OP_INT, ints["gt_x"], 0)],
        "correct_y": [(OP_INT, ints["gt_y"], 0)],
        "correct_label": [sel_gt_l],
    }
    sel_task = p.make_select(ints["t_idx"], [
        p.ops_for(lambda o, t=t: p.lit_json(o, t)) for t in task_bank])
    sel_q = p.make_select(ints["qa_idx"], [
        p.template_subprogram(t, field_ops)
        for t in (closer_q + farther_q)])
    sel_a = p.make_select(ints["aa_idx"], [
        p.template_subprogram(t, field_ops)
        for t in (closer_a + farther_a)])
    sel_l1 = p.make_select(ints["p1l"], [list(s) for s in letter_sub])
    sel_l2 = p.make_select(ints["p2l"],
                           [list(s) for s in letter_sub])
    sel_bool = p.make_select(ints["is_closer"], [
        p.ops_for(lambda o: p.lit(o, "false")),
        p.ops_for(lambda o: p.lit(o, "true"))])

    main: list[tuple] = []
    p.lit(main, '{"id": "')
    main.append((OP_STR, sid_c, 0)); p.lit(main, "_")
    main.append((OP_STR, img_c, 0)); p.lit(main, "_p")
    main.append((OP_INT, ints["pid0"], 0)); p.lit(main, "_p")
    main.append((OP_INT, ints["pid1"], 0))
    p.lit(main, '", "image": ["')
    main.append((OP_STR, sid_c, 0)); p.lit(main, "/")
    main.append((OP_STR, img_c, 0))
    if dot:
        p.lit(main, "_p"); main.append((OP_INT, ints["pid0"], 0))
        p.lit(main, "_p"); main.append((OP_INT, ints["pid1"], 0))
        p.lit(main, '_annotated.jpg"], ')
    else:
        p.lit(main, '.jpg"], ')
    # conversations kept in eval too (depth_comparison_coor_engine.py
    # :381-384 does not pop); eval appends `text` last.
    p.lit(main, '"conversations": [{"from": "human", "value": "')
    main.append(sel_task); p.lit(main, "\\n"); main.append(sel_q)
    p.lit(main, '"}, {"from": "gpt", "value": "')
    main.append(sel_a)
    p.lit(main, '"}], ')
    p.lit(main, '"height_list": [')
    main.append((OP_INT, ints["h"], 0))
    p.lit(main, '], "width_list": [')
    main.append((OP_INT, ints["w"], 0))
    if dot:
        p.lit(main, '], "question_type": "depth_comparison_annotated", '
                    '"gt_value": "')
        main.append(sel_gt_l)
        p.lit(main, '", "points_info": [')
    else:
        p.lit(main, '], "question_type": "depth_comparison_coordinate", '
                    '"gt_value": [')
        main.append((OP_INT, ints["gt_x"], 0)); p.lit(main, ", ")
        main.append((OP_INT, ints["gt_y"], 0))
        p.lit(main, '], "points_info": [')
    for tag, sel_l in (("p1", sel_l1), ("p2", sel_l2)):
        if tag == "p2":
            p.lit(main, ", ")
        p.lit(main, '{"x": ')
        main.append((OP_INT, ints[f"{tag}x"], 0))
        p.lit(main, ', "y": ')
        main.append((OP_INT, ints[f"{tag}y"], 0))
        p.lit(main, ', "depth": ')
        main.append((OP_INT, ints[f"{tag}d"], 0))
        p.lit(main, ', "coords": [')
        main.append((OP_INT, ints[f"{tag}cx"], 0)); p.lit(main, ", ")
        main.append((OP_INT, ints[f"{tag}cy"], 0))
        p.lit(main, '], "letter": "')
        main.append(sel_l)
        p.lit(main, '"}')
    p.lit(main, '], "is_closer_question": ')
    main.append(sel_bool)
    if eval_mode:
        p.lit(main, ', "text": "')
        main.append(sel_task); p.lit(main, "\\n"); main.append(sel_q)
        p.lit(main, '"}')
    else:
        p.lit(main, '}')

    order = np.arange(n)
    if 0 < config.all_max_samples < n:
        order = rng.choice(n, size=config.all_max_samples, replace=False)
    order = order[rng.permutation(len(order))]
    p.emit(main, output_path, row_order=order, force_python=force_python)
    out = EngineOutputs(n_skipped=warn.count)
    if eval_mode:
        out.val_path, out.n_val = output_path, len(order)
    else:
        out.train_path, out.n_train = output_path, len(order)
    return out


def generate_depth_comparison(
    store: SceneStore,
    vis_index: VisibilityIndex,
    output_path: str,
    variant: str = "coor",
    config: DepthEngineConfig | None = None,
    eval_mode: bool = False,
    image_provider: ImageProvider | None = None,
    image_output_dir: str | None = None,
    warning_path: str | None = None,
) -> EngineOutputs:
    assert variant in ("coor", "dot")
    config = config or DepthEngineConfig()
    warn = WarningSink(warning_path)
    rng = stream(config.seed, "depth_comparison", variant,
                 "eval" if eval_mode else "train")
    question_type = ("depth_comparison_coordinate" if variant == "coor"
                     else "depth_comparison_annotated")

    scene_ids, quota = _scene_plan(store.scene_ids(), config.all_max_samples, rng)
    samples: list[dict] = []
    pool = AnnotationPool()
    writer = (AnnotatedJpegWriter(image_provider, image_output_dir)
              if image_provider is not None and image_output_dir else None)
    for sid in scene_ids:
        scene = store.get(sid)
        h, w = scene.image_hw
        image_ids = scene.valid_image_ids()
        if not image_ids:
            continue
        for image_id in _sample_images(image_ids, quota, rng, True):
            visible = vis_index.image_to_points(sid, image_id)
            if len(visible) < 2:
                continue
            img_index = scene.image_index(image_id)
            # One vectorized reprojection of every visible point serves all
            # pair draws/retries for this image.
            vxs, vys, vds, voks = _project_many(scene, img_index, visible)

            for _ in range(config.max_n_points_per_image):
                max_retries = 10 if variant == "dot" else 1
                pair = None
                for retry in range(max_retries + 1):
                    if retry == max_retries:
                        break
                    pick = rng.choice(len(visible), size=2, replace=False)
                    candidate = []
                    for p in pick:
                        if not voks[p]:
                            warn(f"Warning: Point-Id {int(visible[p])} is not "
                                 f"visible in image {image_id} in scene {sid}.")
                            continue
                        x_px, y_px, depth_m = (float(vxs[p]), float(vys[p]),
                                               float(vds[p]))
                        candidate.append({
                            "x": normalized_coord(x_px, w),
                            "y": normalized_coord(y_px, h),
                            "depth": int(np.round(depth_m * 1000)),
                            "coords": (int(x_px), int(y_px)),
                            "point_id": int(visible[p]),
                        })
                    if (len(candidate) == 2
                            and candidate[0]["depth"] != candidate[1]["depth"]):
                        pair = candidate
                        break
                if pair is None:
                    warn(f"Warning: no valid unequal-depth pair in image "
                         f"{image_id} in scene {sid}.")
                    continue

                letters = ["A", "B"]
                rng.shuffle(letters)
                order = rng.permutation(2)
                shuffled = [pair[int(i)] for i in order]
                for i, info in enumerate(shuffled):
                    info["letter"] = letters[i]
                p1, p2 = shuffled
                closer = p1 if p1["depth"] <= p2["depth"] else p2
                farther = p2 if p1["depth"] <= p2["depth"] else p1
                is_closer = bool(rng.integers(2))

                if variant == "coor":
                    task = choice(rng, T.COMP_COOR_TASK_DESCRIPTION)
                    qbank = (T.COMP_CLOSER_QUESTIONS_COOR if is_closer
                             else T.COMP_FARTHER_QUESTIONS_COOR)
                    abank = (T.COMP_CLOSER_ANSWERS_COOR if is_closer
                             else T.COMP_FARTHER_ANSWERS_COOR)
                    target = closer if is_closer else farther
                    question = choice(rng, qbank).format(
                        x1=p1["x"], y1=p1["y"], x2=p2["x"], y2=p2["y"])
                    answer = choice(rng, abank).format(
                        correct_x=target["x"], correct_y=target["y"])
                    gt_value = [target["x"], target["y"]]
                    image_rel = f"{sid}/{image_id}.jpg"
                else:
                    task = choice(rng, T.COMP_DOT_TASK_DESCRIPTION)
                    qbank = (T.COMP_CLOSER_QUESTIONS_DOT if is_closer
                             else T.COMP_FARTHER_QUESTIONS_DOT)
                    abank = (T.COMP_CLOSER_ANSWERS_DOT if is_closer
                             else T.COMP_FARTHER_ANSWERS_DOT)
                    target = closer if is_closer else farther
                    question = choice(rng, qbank)
                    answer = choice(rng, abank).format(
                        correct_label=target["letter"])
                    gt_value = target["letter"]
                    pid0, pid1 = pair[0]["point_id"], pair[1]["point_id"]
                    image_rel = f"{sid}/{image_id}_p{pid0}_p{pid1}_annotated.jpg"
                    if writer is not None:
                        draws = [
                            (info["coords"], info["letter"],
                             tuple(int(c) for c in rng.integers(0, 256, 3)))
                            for info in shuffled
                        ]

                        def task_fn(sid=sid, image_id=image_id,
                                    draws=draws, image_rel=image_rel):
                            writer.write_lettered_dots(sid, image_id, draws,
                                                       image_rel)

                        pool.submit(task_fn, key=image_rel)

                pid0, pid1 = pair[0]["point_id"], pair[1]["point_id"]
                samples.append({
                    "id": f"{sid}_{image_id}_p{pid0}_p{pid1}",
                    "image": [image_rel],
                    "conversations": make_conversation(
                        f"{task}\n{question}", answer),
                    "height_list": [h],
                    "width_list": [w],
                    "question_type": question_type,
                    "gt_value": gt_value,
                    "points_info": [
                        {k: v for k, v in info.items() if k != "point_id"}
                        for info in shuffled
                    ],
                    "is_closer_question": is_closer,
                })

    pool.close()
    if writer is not None:
        writer.close()
    samples = subsample(samples, config.all_max_samples, rng)
    if eval_mode:
        samples = [to_eval_sample(s, keep_conversations=True)
                   for s in samples]
    out = EngineOutputs(n_skipped=warn.count)
    n = shuffle_and_write(samples, output_path, rng)
    if eval_mode:
        out.val_path, out.n_val = output_path, n
    else:
        out.train_path, out.n_train = output_path, n
    return out
