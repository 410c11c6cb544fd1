"""Visual-correspondence QA engines: coor->coor and dot->multichoice.

TPU-native replacement for
`spatial_engine/visual_correspondence/visual_correspondence_qa_engine_
{coor_2_coor,dot_2_multichoice}.py`. The reference resolves the common
visible points of each sampled pair by JSON-decoding two point lists and
`np.intersect1d`-ing them, then re-reads depth PNGs per reprojection
(4 h / 1M samples, 7 h / 500K annotated). Here the pair's common points are
one AND of two visibility-matrix rows, and reprojection runs on in-memory
scene packs.

Semantics parity (coor_2_coor :264-395 / dot_2_multichoice :280-428):
  * pairs drawn from the overlap table with the same bin-balanced sampler,
  * 50% random image swap (:280-281 / :295-296),
  * common point sampled uniformly; both-image reprojection re-check with
    skip-and-log,
  * coor: normalized 0-1000 coords in both images; gt = [x2, y2]
    (:341-344, :391),
  * dot: circle in image 1; in image 2 the correct point plus three random
    distractor pixels, shuffled A-D with shuffled labels, distinct colors,
    letter text at (x+15, y); gt = correct letter (:362-391). The reference
    draws distractors over the whole frame minus a 10px border using
    attributes that don't exist at runtime (`scene_infos.image_width`,
    :370-371 — latent AttributeError, SURVEY.md §2 #21); we use the scene's
    actual width/height, i.e. the evident intent.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.io import WarningSink
from ..core.rng import ENGINE_SEEDS, stream
from ..core.scene import SceneStore
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
    to_eval_sample,
)
from .depth_perception import ProjectionCache, _project_point
from .sampling import sample_overlap_balanced
from .templates import correspondence as T


@dataclasses.dataclass
class CorrespondenceConfig:
    overlap_min: float = 6.0
    overlap_max: float = 35.0
    interval: float = 1.0
    max_points_per_pair: int = 1
    seed: int = ENGINE_SEEDS["visual_correspondence"]


def _sample_pairs(relations, desired_count, config, rng):
    cols = {c: np.asarray(relations[c]) for c in
            ("scene_id", "image_id1", "image_id2", "overlap")}
    idx = sample_overlap_balanced(
        cols["overlap"], desired_count, rng,
        overlap_min=config.overlap_min, overlap_max=config.overlap_max,
        interval=config.interval)
    return (cols["scene_id"][idx], cols["image_id1"][idx],
            cols["image_id2"][idx])


def generate_coor_to_coor(
    relations,
    store: SceneStore,
    vis_index: VisibilityIndex,
    output_path: str,
    desired_count: int,
    config: CorrespondenceConfig | None = None,
    eval_mode: bool = False,
    warning_path: str | None = None,
) -> EngineOutputs:
    config = config or CorrespondenceConfig()
    if eval_mode:
        assert config.max_points_per_pair == 1
    warn = WarningSink(warning_path)
    rng = stream(config.seed, "vc_coor_2_coor",
                 "eval" if eval_mode else "train")
    scene_ids, image1s, image2s = _sample_pairs(
        relations, desired_count, config, rng)

    samples = []
    proj_cache = ProjectionCache()
    for idx in range(len(scene_ids)):
        sid = scene_ids[idx]
        image1, image2 = image1s[idx], image2s[idx]
        if rng.random() < 0.5:
            image1, image2 = image2, image1
        scene = store.get(sid)
        h, w = scene.image_hw
        common = vis_index.common_points(sid, image1, image2)
        if len(common) == 0:
            warn(f"[build_training_sample] Warning: No common visible "
                 f"points for scene {sid} {image1}, {image2}")
            continue

        if len(common) >= config.max_points_per_pair:
            picks = rng.choice(common, size=config.max_points_per_pair,
                               replace=False)
        else:
            picks = rng.choice(common, size=config.max_points_per_pair,
                               replace=True)

        conversation = []
        p1_list, p2_list = [], []
        i1, i2 = scene.image_index(image1), scene.image_index(image2)
        for pt in picks:
            proj1 = proj_cache.project(scene, i1, int(pt))
            proj2 = proj_cache.project(scene, i2, int(pt))
            if proj1 is None or proj2 is None:
                warn(f"Warning: Point {int(pt)} reprojection failed for "
                     f"{sid} {image1}/{image2}.")
                continue
            x1 = normalized_coord(proj1[0], w)
            y1 = normalized_coord(proj1[1], h)
            x2 = normalized_coord(proj2[0], w)
            y2 = normalized_coord(proj2[1], h)
            task = choice(rng, T.COOR_TASK_DESCRIPTION)
            question = choice(rng, T.COOR_QUESTIONS).format(x1=x1, y1=y1)
            answer = choice(rng, T.COOR_ANSWERS).format(
                x1=x1, y1=y1, x2=x2, y2=y2)
            if not conversation:
                conversation = make_conversation(f"{task}\n{question}", answer)
            else:
                conversation += make_conversation(question, answer)
            p1_list.append((x1, y1))
            p2_list.append((x2, y2))

        if not conversation:
            warn(f"[build_training_sample] Warning: No conversation for "
                 f"scene {sid} {image1}, {image2}")
            continue
        samples.append({
            "id": f"{sid}_{image1}_{image2}_{idx}",
            "image": [f"{sid}/{image1}.jpg", f"{sid}/{image2}.jpg"],
            "conversations": conversation,
            "height_list": [h, h],
            "width_list": [w, w],
            "question_type": "visual_correspondence_coor_2_coor",
            "p1_list": p1_list,
            "p2_list": p2_list,
            "gt_value": list(p2_list[0]),
        })

    if eval_mode:
        samples = [to_eval_sample(s) for s in samples]
    out = EngineOutputs(n_skipped=warn.count)
    n = shuffle_and_write(samples, output_path, rng)
    if eval_mode:
        out.val_path, out.n_val = output_path, n
    else:
        out.train_path, out.n_train = output_path, n
    return out


def generate_coor_to_coor_to_jsonl(
    relations,
    store: SceneStore,
    vis_index: VisibilityIndex,
    output_path: str,
    desired_count: int,
    config: CorrespondenceConfig | None = None,
    eval_mode: bool = False,
    warning_path: str | None = None,
    force_python: bool = False,
) -> EngineOutputs:
    """Columnar fast path for the single-round coor->coor engine
    (max_points_per_pair must be 1): records emitted by the native
    template VM, byte-identical to json.dumps of the dict path."""
    from .fast_jsonl import OP_INT, OP_STR, EmitProgram

    config = config or CorrespondenceConfig()
    assert config.max_points_per_pair == 1
    warn = WarningSink(warning_path)
    rng = stream(config.seed, "vc_coor_2_coor",
                 "eval" if eval_mode else "train")
    scene_ids, image1s, image2s = _sample_pairs(
        relations, desired_count, config, rng)

    cols: dict[str, list] = {k: [] for k in (
        "sid", "img1", "img2", "idx", "x1", "y1", "x2", "y2", "h", "w",
        "t_idx", "q_idx", "a_idx")}
    proj_cache = ProjectionCache()
    for idx in range(len(scene_ids)):
        sid = scene_ids[idx]
        image1, image2 = image1s[idx], image2s[idx]
        if rng.random() < 0.5:
            image1, image2 = image2, image1
        scene = store.get(sid)
        h, w = scene.image_hw
        common = vis_index.common_points(sid, image1, image2)
        if len(common) == 0:
            warn(f"[build_training_sample] Warning: No common visible "
                 f"points for scene {sid} {image1}, {image2}")
            continue
        pt = int(rng.choice(common, size=1, replace=False)[0])
        i1, i2 = scene.image_index(image1), scene.image_index(image2)
        proj1 = proj_cache.project(scene, i1, pt)
        proj2 = proj_cache.project(scene, i2, pt)
        if proj1 is None or proj2 is None:
            warn(f"Warning: Point {pt} reprojection failed for "
                 f"{sid} {image1}/{image2}.")
            continue
        cols["sid"].append(sid)
        cols["img1"].append(image1)
        cols["img2"].append(image2)
        cols["idx"].append(idx)
        cols["x1"].append(normalized_coord(proj1[0], w))
        cols["y1"].append(normalized_coord(proj1[1], h))
        cols["x2"].append(normalized_coord(proj2[0], w))
        cols["y2"].append(normalized_coord(proj2[1], h))
        cols["h"].append(h)
        cols["w"].append(w)
        cols["t_idx"].append(int(rng.integers(len(T.COOR_TASK_DESCRIPTION))))
        cols["q_idx"].append(int(rng.integers(len(T.COOR_QUESTIONS))))
        cols["a_idx"].append(int(rng.integers(len(T.COOR_ANSWERS))))

    n = len(cols["sid"])
    p = EmitProgram(n)
    sid_c = p.add_str_col(cols["sid"])
    i1_c = p.add_str_col(cols["img1"])
    i2_c = p.add_str_col(cols["img2"])
    ints = {k: p.add_int_col(cols[k]) for k in
            ("idx", "x1", "y1", "x2", "y2", "h", "w", "t_idx", "q_idx",
             "a_idx")}
    field_ops = {k: [(OP_INT, ints[k], 0)] for k in ("x1", "y1", "x2", "y2")}
    sel_task = p.make_select(ints["t_idx"], [
        p.ops_for(lambda o, t=t: p.lit_json(o, t))
        for t in T.COOR_TASK_DESCRIPTION])
    sel_q = p.make_select(ints["q_idx"], [
        p.template_subprogram(t, field_ops) for t in T.COOR_QUESTIONS])
    sel_a = p.make_select(ints["a_idx"], [
        p.template_subprogram(t, field_ops) for t in T.COOR_ANSWERS])

    main: list[tuple] = []
    p.lit(main, '{"id": "')
    main.append((OP_STR, sid_c, 0)); p.lit(main, "_")
    main.append((OP_STR, i1_c, 0)); p.lit(main, "_")
    main.append((OP_STR, i2_c, 0)); p.lit(main, "_")
    main.append((OP_INT, ints["idx"], 0))
    p.lit(main, '", "image": ["')
    main.append((OP_STR, sid_c, 0)); p.lit(main, "/")
    main.append((OP_STR, i1_c, 0)); p.lit(main, '.jpg", "')
    main.append((OP_STR, sid_c, 0)); p.lit(main, "/")
    main.append((OP_STR, i2_c, 0)); p.lit(main, '.jpg"], ')
    if not eval_mode:
        p.lit(main, '"conversations": [{"from": "human", "value": "')
        main.append(sel_task); p.lit(main, "\\n"); main.append(sel_q)
        p.lit(main, '"}, {"from": "gpt", "value": "')
        main.append(sel_a)
        p.lit(main, '"}], ')
    p.lit(main, '"height_list": [')
    main.append((OP_INT, ints["h"], 0)); p.lit(main, ", ")
    main.append((OP_INT, ints["h"], 0))
    p.lit(main, '], "width_list": [')
    main.append((OP_INT, ints["w"], 0)); p.lit(main, ", ")
    main.append((OP_INT, ints["w"], 0))
    p.lit(main,
          '], "question_type": "visual_correspondence_coor_2_coor", '
          '"p1_list": [[')
    main.append((OP_INT, ints["x1"], 0)); p.lit(main, ", ")
    main.append((OP_INT, ints["y1"], 0))
    p.lit(main, ']], "p2_list": [[')
    main.append((OP_INT, ints["x2"], 0)); p.lit(main, ", ")
    main.append((OP_INT, ints["y2"], 0))
    p.lit(main, ']], "gt_value": [')
    main.append((OP_INT, ints["x2"], 0)); p.lit(main, ", ")
    main.append((OP_INT, ints["y2"], 0))
    if eval_mode:
        p.lit(main, '], "text": "')
        main.append(sel_task); p.lit(main, "\\n"); main.append(sel_q)
        p.lit(main, '"}')
    else:
        p.lit(main, ']}')

    order = rng.permutation(n)
    p.emit(main, output_path, row_order=order, force_python=force_python)
    out = EngineOutputs(n_skipped=warn.count)
    if eval_mode:
        out.val_path, out.n_val = output_path, n
    else:
        out.train_path, out.n_train = output_path, n
    return out


def generate_dot_to_multichoice(
    relations,
    store: SceneStore,
    vis_index: VisibilityIndex,
    output_path: str,
    desired_count: int,
    image_output_dir: str,
    image_provider: ImageProvider | None = None,
    config: CorrespondenceConfig | None = None,
    eval_mode: bool = False,
    warning_path: str | None = None,
) -> EngineOutputs:
    config = config or CorrespondenceConfig()
    assert config.max_points_per_pair == 1
    warn = WarningSink(warning_path)
    rng = stream(config.seed, "vc_dot_2_multichoice",
                 "eval" if eval_mode else "train")
    scene_ids, image1s, image2s = _sample_pairs(
        relations, desired_count, config, rng)

    samples = []
    proj_cache = ProjectionCache()
    pool = AnnotationPool()
    writer = (AnnotatedJpegWriter(image_provider, image_output_dir)
              if image_provider is not None else None)
    for idx in range(len(scene_ids)):
        sid = scene_ids[idx]
        image1, image2 = image1s[idx], image2s[idx]
        if rng.random() < 0.5:
            image1, image2 = image2, image1
        scene = store.get(sid)
        h, w = scene.image_hw
        common = vis_index.common_points(sid, image1, image2)
        if len(common) == 0:
            warn(f"[build_training_sample] Warning: No common visible "
                 f"points for scene {sid} {image1}, {image2}")
            continue
        pt = int(common[int(rng.integers(len(common)))])
        i1, i2 = scene.image_index(image1), scene.image_index(image2)
        proj1 = proj_cache.project(scene, i1, pt)
        proj2 = proj_cache.project(scene, i2, pt)
        if proj1 is None or proj2 is None:
            warn(f"Warning: Point {pt} reprojection failed for {sid} "
                 f"{image1}/{image2}.")
            continue

        correct_point = (int(proj2[0]), int(proj2[1]))
        incorrect = []
        while len(incorrect) < 3:
            x = int(rng.integers(0, w - 10))
            y = int(rng.integers(0, h - 10))
            if (x, y) != correct_point:
                incorrect.append((x, y))
        all_points = [correct_point] + incorrect
        order = rng.permutation(4)
        all_points = [all_points[int(i)] for i in order]
        labels = ["A", "B", "C", "D"]
        rng.shuffle(labels)
        labeled = dict(zip(labels, all_points))
        correct_label = next(l for l, p in labeled.items()
                             if p == correct_point)

        rel1 = f"{sid}/{idx}_point{pt}_{image1}_{image2}_img1.jpg"
        rel2 = f"{sid}/{idx}_point{pt}_{image1}_{image2}_img2.jpg"
        if writer is not None:
            color = tuple(int(c) for c in rng.integers(0, 256, 3))
            colors = generate_distinct_colors(4, rng)

            def task_fn(sid=sid, image1=image1, image2=image2,
                        p1=(int(proj1[0]), int(proj1[1])), color=color,
                        draws=[(labeled[lb], lb, colors[i])
                               for i, lb in enumerate(labels)],
                        rel1=rel1, rel2=rel2):
                writer.write_dot(sid, image1, p1, color, rel1)
                writer.write_lettered_dots(sid, image2, draws, rel2,
                                           text_offset=(15, 0))

            pool.submit(task_fn, key=rel2)

        task = choice(rng, T.DOT_TASK_DESCRIPTION)
        question = choice(rng, T.DOT_QUESTIONS)
        answer = choice(rng, T.DOT_ANSWERS).format(correct_label=correct_label)
        samples.append({
            "id": f"{idx}_p{pt}",
            "image": [rel1, rel2],
            "conversations": make_conversation(f"{task}\n{question}", answer),
            "height_list": [h, h],
            "width_list": [w, w],
            "question_type": "visual_correspondence_multiple_choice",
            "gt_value": correct_label,
            "p1_list": [int(proj1[0]), int(proj1[1])],
            "p2_list": [correct_point] + incorrect,
        })

    pool.close()
    if writer is not None:
        writer.close()
    if eval_mode:
        samples = [to_eval_sample(s) for s in samples]
    out = EngineOutputs(n_skipped=warn.count)
    n = shuffle_and_write(samples, output_path, rng)
    if eval_mode:
        out.val_path, out.n_val = output_path, n
    else:
        out.train_path, out.n_train = output_path, n
    return out


def generate_dot_to_multichoice_to_jsonl(
    relations,
    store: SceneStore,
    vis_index: VisibilityIndex,
    output_path: str,
    desired_count: int,
    image_output_dir: str,
    image_provider: ImageProvider | None = None,
    config: CorrespondenceConfig | None = None,
    eval_mode: bool = False,
    warning_path: str | None = None,
    force_python: bool = False,
) -> EngineOutputs:
    """Columnar fast path for the dot->multichoice engine: same sampling,
    distractor, label-shuffle and annotation rng order as the dict path
    (records byte-compatible with json.dumps of it); record assembly runs
    in the template VM and annotation on the thread pool."""
    from .fast_jsonl import OP_INT, OP_STR, EmitProgram

    config = config or CorrespondenceConfig()
    assert config.max_points_per_pair == 1
    warn = WarningSink(warning_path)
    rng = stream(config.seed, "vc_dot_2_multichoice",
                 "eval" if eval_mode else "train")
    scene_ids, image1s, image2s = _sample_pairs(
        relations, desired_count, config, rng)

    keys = ("sid", "img1", "img2", "idx", "pt", "p1x", "p1y", "h", "w",
            "gt_l", "t_idx", "q_idx", "a_idx",
            "c0x", "c0y", "c1x", "c1y", "c2x", "c2y", "c3x", "c3y")
    cols: dict[str, list] = {k: [] for k in keys}
    proj_cache = ProjectionCache()
    pool = AnnotationPool()
    writer = (AnnotatedJpegWriter(image_provider, image_output_dir)
              if image_provider is not None else None)
    for idx in range(len(scene_ids)):
        sid = scene_ids[idx]
        image1, image2 = image1s[idx], image2s[idx]
        if rng.random() < 0.5:
            image1, image2 = image2, image1
        scene = store.get(sid)
        h, w = scene.image_hw
        common = vis_index.common_points(sid, image1, image2)
        if len(common) == 0:
            warn(f"[build_training_sample] Warning: No common visible "
                 f"points for scene {sid} {image1}, {image2}")
            continue
        pt = int(common[int(rng.integers(len(common)))])
        i1, i2 = scene.image_index(image1), scene.image_index(image2)
        proj1 = proj_cache.project(scene, i1, pt)
        proj2 = proj_cache.project(scene, i2, pt)
        if proj1 is None or proj2 is None:
            warn(f"Warning: Point {pt} reprojection failed for {sid} "
                 f"{image1}/{image2}.")
            continue

        correct_point = (int(proj2[0]), int(proj2[1]))
        incorrect = []
        while len(incorrect) < 3:
            x = int(rng.integers(0, w - 10))
            y = int(rng.integers(0, h - 10))
            if (x, y) != correct_point:
                incorrect.append((x, y))
        all_points = [correct_point] + incorrect
        order = rng.permutation(4)
        all_points_shuf = [all_points[int(i)] for i in order]
        labels = ["A", "B", "C", "D"]
        rng.shuffle(labels)
        labeled = dict(zip(labels, all_points_shuf))
        correct_label = next(l for l, p in labeled.items()
                             if p == correct_point)

        rel1 = f"{sid}/{idx}_point{pt}_{image1}_{image2}_img1.jpg"
        rel2 = f"{sid}/{idx}_point{pt}_{image1}_{image2}_img2.jpg"
        if writer is not None:
            color = tuple(int(c) for c in rng.integers(0, 256, 3))
            colors = generate_distinct_colors(4, rng)

            def task_fn(sid=sid, image1=image1, image2=image2,
                        p1=(int(proj1[0]), int(proj1[1])), color=color,
                        draws=[(labeled[lb], lb, colors[i])
                               for i, lb in enumerate(labels)],
                        rel1=rel1, rel2=rel2):
                writer.write_dot(sid, image1, p1, color, rel1)
                writer.write_lettered_dots(sid, image2, draws, rel2,
                                           text_offset=(15, 0))

            pool.submit(task_fn, key=rel2)

        row = {
            "sid": sid, "img1": image1, "img2": image2, "idx": idx,
            "pt": pt, "p1x": int(proj1[0]), "p1y": int(proj1[1]),
            "h": h, "w": w, "gt_l": ord(correct_label) - 65,
            "t_idx": int(rng.integers(len(T.DOT_TASK_DESCRIPTION))),
            "q_idx": int(rng.integers(len(T.DOT_QUESTIONS))),
            "a_idx": int(rng.integers(len(T.DOT_ANSWERS))),
        }
        for j, (cx, cy) in enumerate(all_points):
            row[f"c{j}x"], row[f"c{j}y"] = cx, cy
        for k in keys:
            cols[k].append(row[k])
    pool.close()
    if writer is not None:
        writer.close()

    n = len(cols["sid"])
    p = EmitProgram(n)
    sid_c = p.add_str_col(cols["sid"])
    i1_c = p.add_str_col(cols["img1"])
    i2_c = p.add_str_col(cols["img2"])
    ints = {k: p.add_int_col(cols[k]) for k in keys
            if k not in ("sid", "img1", "img2")}
    letter4 = [p.ops_for(lambda o, t=t: p.lit(o, t))
               for t in ("A", "B", "C", "D")]
    sel_gt = p.make_select(ints["gt_l"], letter4)
    field_ops = {"correct_label": [sel_gt]}
    sel_task = p.make_select(ints["t_idx"], [
        p.ops_for(lambda o, t=t: p.lit_json(o, t))
        for t in T.DOT_TASK_DESCRIPTION])
    sel_q = p.make_select(ints["q_idx"], [
        p.template_subprogram(t, field_ops) for t in T.DOT_QUESTIONS])
    sel_a = p.make_select(ints["a_idx"], [
        p.template_subprogram(t, field_ops) for t in T.DOT_ANSWERS])

    def emit_rel(main, img_tag):
        main.append((OP_STR, sid_c, 0)); p.lit(main, "/")
        main.append((OP_INT, ints["idx"], 0)); p.lit(main, "_point")
        main.append((OP_INT, ints["pt"], 0)); p.lit(main, "_")
        main.append((OP_STR, i1_c, 0)); p.lit(main, "_")
        main.append((OP_STR, i2_c, 0)); p.lit(main, f"_{img_tag}.jpg")

    main: list[tuple] = []
    p.lit(main, '{"id": "')
    main.append((OP_INT, ints["idx"], 0)); p.lit(main, "_p")
    main.append((OP_INT, ints["pt"], 0))
    p.lit(main, '", "image": ["')
    emit_rel(main, "img1")
    p.lit(main, '", "')
    emit_rel(main, "img2")
    p.lit(main, '"], ')
    if not eval_mode:
        # correspondence eval pops conversations
        # (visual_correspondence_qa_engine_dot_2_multichoice.py:430-433)
        p.lit(main, '"conversations": [{"from": "human", "value": "')
        main.append(sel_task); p.lit(main, "\\n"); main.append(sel_q)
        p.lit(main, '"}, {"from": "gpt", "value": "')
        main.append(sel_a)
        p.lit(main, '"}], ')
    p.lit(main, '"height_list": [')
    main.append((OP_INT, ints["h"], 0)); p.lit(main, ", ")
    main.append((OP_INT, ints["h"], 0))
    p.lit(main, '], "width_list": [')
    main.append((OP_INT, ints["w"], 0)); p.lit(main, ", ")
    main.append((OP_INT, ints["w"], 0))
    p.lit(main,
          '], "question_type": "visual_correspondence_multiple_choice", '
          '"gt_value": "')
    main.append(sel_gt)
    p.lit(main, '", "p1_list": [')
    main.append((OP_INT, ints["p1x"], 0)); p.lit(main, ", ")
    main.append((OP_INT, ints["p1y"], 0))
    p.lit(main, '], "p2_list": [')
    for j in range(4):
        if j:
            p.lit(main, ", ")
        p.lit(main, "[")
        main.append((OP_INT, ints[f"c{j}x"], 0)); p.lit(main, ", ")
        main.append((OP_INT, ints[f"c{j}y"], 0))
        p.lit(main, "]")
    if eval_mode:
        p.lit(main, '], "text": "')
        main.append(sel_task); p.lit(main, "\\n"); main.append(sel_q)
        p.lit(main, '"}')
    else:
        p.lit(main, ']}')

    order = rng.permutation(n)
    p.emit(main, output_path, row_order=order, force_python=force_python)
    out = EngineOutputs(n_skipped=warn.count)
    if eval_mode:
        out.val_path, out.n_val = output_path, n
    else:
        out.train_path, out.n_train = output_path, n
    return out
