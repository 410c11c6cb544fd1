"""The MultiSPA data-engine pipeline on the card: the port of
multi_spatialmllm_tpu/pipeline.py, L2 -> L3 -> L4 (a scene store; the
visibility index, the pairwise frame relations, object visibility and
coverage; the camera-movement, depth, correspondence and object-perception
QA engines, and the TAPVid object-movement engines over npz records), with
manifest-based resume and structured logging. Artifact layout under `output_root`, as the JAX pipeline's:

    indices/visibility.npz            packed visibility index
    indices/visibility.parquet        reference-dialect export (optional)
    indices/frame_relations.parquet   (+ _nonzero companion)
    indices/object_visibility.pkl
    indices/coverage_{dim}.pkl
    qa/<split>/<engine>/...jsonl      QA outputs (+ annotated images/)
    manifest.jsonl                    stage-unit completion records
    events.jsonl                      stage events and counters

The stages run on `device` (the card unless the caller asks otherwise).
Where pandas or pyarrow is missing, the relations parquet is not written:
the manifest unit records `"parquet": null` and events.jsonl says why;
the QA output does not depend on it.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from .core.io import dump_pickle, load_pickle
from .core.scene import SceneStore
from .stages import coverage as cov
from .stages.frame_relations import build_frame_relations, parquet_unavailable
from .stages.manifest import Manifest, config_hash
from .stages.object_visibility import build_object_visibility
from .stages.visibility import (
    VisibilityIndex,
    compute_scene_visibility,
    compute_scene_visibility_hybrid,
)
from .utils.logging import StageLogger


def _records_fingerprint(scene_records: dict) -> str:
    """Content digest of a {scene_id: npz-record} mapping, so an
    object-movement manifest unit is invalidated when its INPUT changes,
    not only its config (r5 review: a later run with different TAPVid
    data on the same root silently revived the previous run's counts)."""
    import hashlib

    h = hashlib.blake2b(digest_size=8)
    for sid in sorted(scene_records):
        h.update(str(sid).encode())
        rec = scene_records[sid]
        for k in sorted(rec):
            v = np.asarray(rec[k])
            h.update(k.encode())
            h.update(f"{v.shape}{v.dtype}".encode())
            if v.dtype == object:  # e.g. images_jpeg_bytes
                for item in v.ravel():
                    b = (bytes(item) if isinstance(item, (bytes, bytearray))
                         else repr(item).encode())
                    h.update(len(b).to_bytes(8, "little"))
                    h.update(b)
            else:
                h.update(np.ascontiguousarray(v).tobytes())
    return h.hexdigest()


@dataclasses.dataclass
class PipelineConfig:
    # "float64" (labels bit-equal to the JAX pipeline's), "hybrid" (a
    # float32 device pass and a host float64 fix-up of the borderline
    # pairs: the float64 labels; the later stages run in float32) or
    # "float32" (speed opt-in, ~5% boundary flips)
    dtype: str = "float64"
    write_reference_parquet: bool = False
    overlap_min: float = 6.0
    overlap_max: float = 35.0
    interval: float = 1.0
    coverage_tolerance: float = cov.TOLERANCE
    seed: int = 0


class SpatialEnginePipeline:
    def __init__(self, store: SceneStore, output_root: str,
                 config: PipelineConfig | None = None, device="cuda"):
        self.store = store
        self.root = output_root
        self.config = config or PipelineConfig()
        self.device = device
        self.manifest = Manifest(os.path.join(output_root, "manifest.jsonl"))
        os.makedirs(os.path.join(output_root, "indices"), exist_ok=True)
        os.makedirs(os.path.join(output_root, "qa"), exist_ok=True)
        self._vis: VisibilityIndex | None = None
        self._relations = None

    # ------------------------------------------------------------------
    # L3 stages
    # ------------------------------------------------------------------

    def _dtype(self):
        return np.float64 if self.config.dtype == "float64" else np.float32

    def visibility(self) -> VisibilityIndex:
        if self._vis is not None:
            return self._vis
        path = os.path.join(self.root, "indices", "visibility.npz")
        cfg = {"dtype": self.config.dtype}
        log = StageLogger("visibility",
                          os.path.join(self.root, "events.jsonl"))
        if self.manifest.is_done("visibility", "all", config_hash(cfg)) \
                and os.path.exists(path):
            self._vis = VisibilityIndex.load_npz(path)
            log.event("loaded_cached", path=path)
            return self._vis
        index = VisibilityIndex()
        for scene in self.store:
            if self.config.dtype == "hybrid":
                vis = compute_scene_visibility_hybrid(scene,
                                                      device=self.device)
            else:
                vis = compute_scene_visibility(scene, self._dtype(),
                                               device=self.device)
            index.add_scene(scene.scene_id, scene.image_ids, vis)
            log.count("scenes")
        index.save_npz(path)
        if self.config.write_reference_parquet:
            index.to_parquet(
                os.path.join(self.root, "indices", "visibility.parquet"))
        self.manifest.mark_done("visibility", "all", config_hash(cfg),
                                {"path": path})
        log.summary()
        self._vis = index
        return index

    def frame_relations(self) -> dict[str, np.ndarray]:
        """The relation table (a dict of numpy columns). A finished unit
        loads its parquet when this host reads parquet; otherwise the
        table is rebuilt from the cached visibility index."""
        if self._relations is not None:
            return self._relations
        path = os.path.join(self.root, "indices", "frame_relations.parquet")
        cfg = {"dtype": self.config.dtype}
        log = StageLogger("frame_relations",
                          os.path.join(self.root, "events.jsonl"))
        no_parquet = parquet_unavailable()
        if self.manifest.is_done("frame_relations", "all", config_hash(cfg)) \
                and os.path.exists(path) and no_parquet is None:
            import pandas as pd

            df = pd.read_parquet(path)
            self._relations = {c: np.asarray(df[c]) for c in df.columns}
            log.event("loaded_cached", path=path)
            return self._relations
        vis_index = self.visibility()
        vis_map = {sid: vis_index.matrix(sid) for sid in
                   vis_index.scene_ids()}
        table = build_frame_relations(
            self.store, output_parquet=None if no_parquet else path,
            warning_path=os.path.join(self.root, "indices",
                                      "relations_warning.txt"),
            dtype=self._dtype(), visibility=vis_map, device=self.device)
        rows = len(table["overlap"])
        if no_parquet:
            log.event("parquet_not_written", path=path, reason=no_parquet)
            outputs = {"parquet": None, "rows": rows}
        else:
            outputs = {"path": path, "rows": rows}
        self.manifest.mark_done("frame_relations", "all", config_hash(cfg),
                                outputs)
        log.event("built", rows=rows)
        log.summary()
        self._relations = table
        return table

    def object_visibility(self) -> dict:
        path = os.path.join(self.root, "indices", "object_visibility.pkl")
        cfg = {"dtype": self.config.dtype}
        if self.manifest.is_done("object_visibility", "all",
                                 config_hash(cfg)) and os.path.exists(path):
            return load_pickle(path)
        vis_index = self.visibility()
        vis_map = {sid: vis_index.matrix(sid) for sid in
                   vis_index.scene_ids()}
        result = build_object_visibility(
            self.store, output_pkl=path,
            warning_path=os.path.join(self.root, "indices",
                                      "object_visibility_warning.txt"),
            visibility=vis_map, device=self.device)
        self.manifest.mark_done("object_visibility", "all",
                                config_hash(cfg), {"path": path})
        return result

    def coverage(self) -> dict[str, dict]:
        paths = {dim: os.path.join(self.root, "indices",
                                   f"coverage_{dim}.pkl")
                 for dim in ("height", "length", "width")}
        cfg = {"tolerance": self.config.coverage_tolerance,
               "seed": self.config.seed}
        if self.manifest.is_done("coverage", "all", config_hash(cfg)) and \
                all(os.path.exists(p) for p in paths.values()):
            return {dim: load_pickle(p) for dim, p in paths.items()}
        ov = self.object_visibility()
        vis_index = self.visibility()
        vis_map = {sid: vis_index.matrix(sid) for sid in
                   vis_index.scene_ids()}
        h, l, w = cov.build_object_coverage(
            self.store, ov, visibility=vis_map, seed=self.config.seed,
            tolerance=self.config.coverage_tolerance, device=self.device)
        result = {"height": h, "length": l, "width": w}
        for dim, p in paths.items():
            dump_pickle(result[dim], p)
        self.manifest.mark_done("coverage", "all", config_hash(cfg),
                                {k: v for k, v in paths.items()})
        return result

    # ------------------------------------------------------------------
    # L4 engines
    # ------------------------------------------------------------------

    # Every engine writes the reference's split layout under qa/:
    #   qa/training_data/<engine>/...    qa/evaluation_data/<engine>/...
    # (e.g. depth_estimation_coor_engine.py:318-322,
    # camera_movement_engine_train_val.py:406-407).

    def _train_dir(self, engine: str) -> str:
        return os.path.join(self.root, "qa", "training_data", engine)

    def _eval_dir(self, engine: str) -> str:
        return os.path.join(self.root, "qa", "evaluation_data", engine)

    def _unit(self, stage: str, unit: str, cfg, fn):
        """Manifest-gated engine unit: an interrupted campaign resumes
        at unit granularity — completed engine outputs are skipped (the
        recorded counts come back as an EngineOutputs-shaped namespace),
        the interrupted unit reruns from scratch. Config changes (counts,
        sampler params) invalidate the unit via the hash."""
        from types import SimpleNamespace

        h = config_hash(cfg)
        if self.manifest.is_done(stage, unit, h):
            saved = self.manifest.outputs(stage, unit)

            def revive(v):
                if isinstance(v, dict) and "n_train" in v:
                    return SimpleNamespace(**v)
                if isinstance(v, dict):
                    return {k: revive(x) for k, x in v.items()}
                return v

            return revive(saved)
        res = fn()

        def persist(v):
            if isinstance(v, dict):
                return {k: persist(x) for k, x in v.items()}
            return {"n_train": getattr(v, "n_train", 0),
                    "n_val": getattr(v, "n_val", 0)}

        self.manifest.mark_done(stage, unit, h, persist(res))
        return res

    def run_camera_movement(self, train_counts=None, val_counts=None):
        """One manifest unit PER question type: a 3M-sample campaign
        (reference TRAIN_QUESTION_SAMPLES scale) killed mid-type resumes
        at the interrupted type, not from scratch. Relations are
        prepared once and shared across the types that actually run."""
        from .engines import camera_movement as CM

        cfg = CM.CameraMovementConfig(
            overlap_min=self.config.overlap_min,
            overlap_max=self.config.overlap_max,
            interval=self.config.interval)
        train_counts = train_counts or CM.TRAIN_QUESTION_SAMPLES
        val_counts = val_counts or CM.VAL_QUESTION_SAMPLES
        prepared = None
        out = {}
        for qtype, count in train_counts.items():
            n_val = val_counts.get(qtype, 300)

            def run(qtype=qtype, count=count, n_val=n_val):
                nonlocal prepared
                if prepared is None:
                    prepared = CM.prepare_relations(
                        self.frame_relations(), self.store)
                return CM.generate(
                    prepared, prepared, self.store,
                    self._train_dir("camera_movement"),
                    self._eval_dir("camera_movement"),
                    train_counts={qtype: count},
                    val_counts={qtype: n_val}, config=cfg)[qtype]

            out[qtype] = self._unit(
                "engine.camera_movement", qtype,
                {"cfg": cfg, "n": count, "n_val": n_val}, run)
        return out

    def run_depth_perception(self, all_max_samples=1000,
                             eval_max_samples=None,
                             dot_max_samples=None, annotate_dots=True,
                             points_per_image=None):
        """All four depth engines, train + eval files each (the reference
        runs every engine twice: generate_qa_training_data then
        generate_qa_eval_data, e.g. depth_estimation_coor_engine.py
        :355-364). Dot variants write annotated JPEGs next to their
        JSONL (reference depth_estimation_dot_engine.py:162-173) and
        take their own sample budget (`dot_max_samples`) so volume
        campaigns can scale the coor engines past the annotated ones."""
        from .engines import depth_perception as DP
        from .engines.annotate import SyntheticImageProvider

        if eval_max_samples is None:
            eval_max_samples = max(all_max_samples // 4, 1)
        if dot_max_samples is None:
            dot_max_samples = all_max_samples
        dot_eval_max = max(dot_max_samples // 4, 1)
        ppi = (points_per_image if points_per_image is not None
               else DP.DepthEngineConfig.max_n_points_per_image)
        provider = None
        if annotate_dots:
            first = self.store.get(self.store.scene_ids()[0])
            provider = SyntheticImageProvider(first.image_hw)
        out = {}
        for variant in ("coor", "dot"):
            trn = all_max_samples if variant == "coor" else dot_max_samples
            ev_n = eval_max_samples if variant == "coor" else dot_eval_max
            for kind, gen in (("estimation",
                               DP.generate_depth_estimation_to_jsonl),
                              ("comparison",
                               DP.generate_depth_comparison_to_jsonl)):
                task = f"depth_{kind}_{variant}"
                for split, n, outdir, ev in (
                        ("train", trn, self._train_dir, False),
                        ("eval", ev_n, self._eval_dir, True)):
                    key = (f"{kind}_{variant}" if split == "train"
                           else f"{kind}_{variant}_eval")
                    img_dir = (os.path.join(outdir(task), "images")
                               if variant == "dot" and provider is not None
                               else None)
                    out[key] = self._unit(
                        f"engine.{task}", split,
                        {"n": n, "ppi": ppi, "dtype": self.config.dtype,
                         "annotated": img_dir is not None},
                        lambda task=task, n=n, outdir=outdir, ev=ev,
                        gen=gen, variant=variant, img_dir=img_dir: gen(
                            self.store, self.visibility(),
                            os.path.join(outdir(task), f"{task}.jsonl"),
                            variant=variant, eval_mode=ev,
                            image_provider=(provider if img_dir else None),
                            image_output_dir=img_dir,
                            config=DP.DepthEngineConfig(
                                all_max_samples=n,
                                max_n_points_per_image=ppi)))
        return out

    def run_visual_correspondence(self, desired_count=1000,
                                  eval_count=None, dot_count=None):
        from .engines import visual_correspondence as VC
        from .engines.annotate import SyntheticImageProvider

        cfg = VC.CorrespondenceConfig(
            overlap_min=self.config.overlap_min,
            overlap_max=self.config.overlap_max,
            interval=self.config.interval)
        if eval_count is None:
            eval_count = max(desired_count // 4, 1)
        if dot_count is None:
            dot_count = desired_count
        dot_eval_count = max(dot_count // 4, 1)
        first = self.store.get(self.store.scene_ids()[0])
        provider = SyntheticImageProvider(first.image_hw)
        # relations/visibility load lazily inside the unit bodies (the
        # run_camera_movement `prepared` pattern): resuming a finished
        # campaign must not pay the ~1M-row parquet + npz load just to
        # skip four completed units.
        loaded = None

        def inputs():
            nonlocal loaded
            if loaded is None:
                loaded = (self.frame_relations(), self.visibility())
            return loaded

        out = {}
        task = "visual_correspondence_coor_2_coor"
        out["coor_2_coor"] = self._unit(
            f"engine.{task}", "train", {"n": desired_count, "cfg": cfg},
            lambda: VC.generate_coor_to_coor(
                inputs()[0], self.store, inputs()[1],
                os.path.join(self._train_dir(task), f"train_{task}.jsonl"),
                desired_count, cfg))
        out["coor_2_coor_eval"] = self._unit(
            f"engine.{task}", "eval", {"n": eval_count, "cfg": cfg},
            lambda: VC.generate_coor_to_coor(
                inputs()[0], self.store, inputs()[1],
                os.path.join(self._eval_dir(task), f"val_{task}.jsonl"),
                eval_count, cfg, eval_mode=True))
        task2 = "visual_correspondence_dot_2_multichoice"
        out["dot_2_multichoice"] = self._unit(
            f"engine.{task2}", "train", {"n": dot_count, "cfg": cfg},
            lambda: VC.generate_dot_to_multichoice_to_jsonl(
                inputs()[0], self.store, inputs()[1],
                os.path.join(self._train_dir(task2), f"train_{task2}.jsonl"),
                dot_count,
                os.path.join(self._train_dir(task2), "images"),
                image_provider=provider, config=cfg))
        out["dot_2_multichoice_eval"] = self._unit(
            f"engine.{task2}", "eval", {"n": dot_eval_count, "cfg": cfg},
            lambda: VC.generate_dot_to_multichoice_to_jsonl(
                inputs()[0], self.store, inputs()[1],
                os.path.join(self._eval_dir(task2), f"val_{task2}.jsonl"),
                dot_eval_count,
                os.path.join(self._eval_dir(task2), "images"),
                image_provider=provider, config=cfg, eval_mode=True))
        return out

    def run_object_perception(self):
        from .engines import object_perception as OP

        out = {}
        out["train"] = self._unit(
            "engine.object_perception", "train",
            {"dtype": self.config.dtype, "seed": self.config.seed},
            lambda: OP.generate(
                self.store, self.coverage(),
                self._train_dir("object_perception"), "train"))
        out["val"] = self._unit(
            "engine.object_perception", "eval",
            {"dtype": self.config.dtype, "seed": self.config.seed},
            lambda: OP.generate(
                self.store, self.coverage(),
                self._eval_dir("object_perception"), "val",
                eval_mode=True))
        return out

    def run_object_movement(self, scene_records: dict,
                            max_eval_samples: int = 300):
        """TAPVid object-movement engines, coord + dot, train + eval (the
        eval run writes the full `*_orig.jsonl` dump before subsampling,
        single_object_movement_engine_dot.py:676-686); M5 runs on the
        pipeline's device."""
        from .engines import object_movement as OM

        inputs = _records_fingerprint(scene_records)
        out = {}
        for qtype, dot in (("tapvid3d_total_distance", False),
                           ("tapvid3d_displacement_vector", True)):
            tag = "dot" if dot else "coord"
            engine = f"object_movement_{tag}"
            cfg = OM.ObjectMovementConfig(question_type=qtype,
                                          dot_variant=dot)
            img_dir = (os.path.join(self._train_dir(engine), "images")
                       if dot else None)
            out[f"{tag}_train"] = self._unit(
                f"engine.{engine}", "train",
                {"cfg": cfg, "inputs": inputs},
                lambda engine=engine, cfg=cfg, img_dir=img_dir:
                OM.generate_to_jsonl(
                    scene_records,
                    os.path.join(self._train_dir(engine),
                                 f"{engine}.jsonl"),
                    cfg, img_output_dir=img_dir, device=self.device))
            img_dir_val = (os.path.join(self._eval_dir(engine), "images")
                           if dot else None)
            out[f"{tag}_eval"] = self._unit(
                f"engine.{engine}", "eval",
                {"cfg": cfg, "max": max_eval_samples, "inputs": inputs},
                lambda engine=engine, cfg=cfg, img_dir_val=img_dir_val:
                OM.generate_to_jsonl(
                    scene_records,
                    os.path.join(self._eval_dir(engine),
                                 f"{engine}.jsonl"),
                    cfg, img_output_dir=img_dir_val,
                    max_samples=max_eval_samples, eval_mode=True,
                    device=self.device))
        return out

    def run_all(
        self,
        tapvid_records: dict | None = None,
        camera_train_counts: dict | None = None,
        camera_val_counts: dict | None = None,
        depth_samples: int = 200,
        depth_dot_samples: int | None = None,
        depth_points_per_image: int | None = None,
        correspondence_count: int = 200,
        correspondence_dot_count: int | None = None,
    ) -> dict:
        """Full run: all stages + engines, train AND eval outputs per
        engine (full reference directory shape). Defaults are demo
        scale; a volume campaign passes real counts (every engine unit
        is manifest-gated, so an interrupted campaign resumes where it
        stopped — scripts/volume_drill.py). The `*_dot_*` knobs bound
        the annotated-JPEG engines separately, as a real campaign
        would (the reference's dot engines run two orders slower than
        its coor engines). TAPVid records, where given, run the
        object-movement engines last."""
        results = {}
        results["camera_movement"] = self.run_camera_movement(
            train_counts=camera_train_counts or {"total_distance": 500},
            val_counts=camera_val_counts or {"total_distance": 50})
        results["depth_perception"] = self.run_depth_perception(
            depth_samples, dot_max_samples=depth_dot_samples,
            points_per_image=depth_points_per_image)
        results["visual_correspondence"] = self.run_visual_correspondence(
            correspondence_count, dot_count=correspondence_dot_count)
        results["object_perception"] = self.run_object_perception()
        if tapvid_records:
            results["object_movement"] = self.run_object_movement(
                tapvid_records)
        return results
