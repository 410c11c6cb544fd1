"""The MultiSPA data-engine pipeline on the card: the port of
multi_spatialmllm_tpu/pipeline.py for its main path, L2 -> L3 -> L4 (a
scene store, the visibility index, the pairwise frame relations, the
camera-movement QA engine), with manifest-based resume and structured
logging. Artifact layout under `output_root`, as the JAX pipeline's:

    indices/visibility.npz            packed visibility index
    indices/visibility.parquet        reference-dialect export (optional)
    indices/frame_relations.parquet   (+ _nonzero companion)
    qa/<split>/camera_movement/...jsonl
    manifest.jsonl                    stage-unit completion records
    events.jsonl                      stage events and counters

The stages run on `device` (the card unless the caller asks otherwise).
Where pandas or pyarrow is missing, the relations parquet is not written:
the manifest unit records `"parquet": null` and events.jsonl says why;
the QA output does not depend on it.

Still to come (ROADMAP.md): the object-visibility, coverage, depth,
correspondence, object-perception and object-movement engines and
`run_all`, and the hybrid visibility dtype.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from .core.scene import SceneStore
from .stages.frame_relations import build_frame_relations, parquet_unavailable
from .stages.manifest import Manifest, config_hash
from .stages.visibility import VisibilityIndex, compute_scene_visibility
from .utils.logging import StageLogger

# coverage.TOLERANCE of the JAX package (its stage is not ported yet)
COVERAGE_TOLERANCE = 0.1


@dataclasses.dataclass
class PipelineConfig:
    # "float64" (labels bit-equal to the JAX pipeline's), "float32" (speed
    # opt-in, ~5% boundary flips) or "hybrid" (not ported yet: raises)
    dtype: str = "float64"
    write_reference_parquet: bool = False
    overlap_min: float = 6.0
    overlap_max: float = 35.0
    interval: float = 1.0
    coverage_tolerance: float = COVERAGE_TOLERANCE
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
        if self.config.dtype == "hybrid":
            raise NotImplementedError(
                "the hybrid visibility dtype is not ported yet (ROADMAP.md, "
                "queue 1): use float64, which is bit-exact on the card")
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
        dtype = self._dtype()
        index = VisibilityIndex()
        for scene in self.store:
            vis = compute_scene_visibility(scene, dtype, device=self.device)
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

    # ------------------------------------------------------------------
    # L4 engines
    # ------------------------------------------------------------------

    # Every engine writes the reference's split layout under qa/:
    #   qa/training_data/<engine>/...    qa/evaluation_data/<engine>/...
    # (e.g. camera_movement_engine_train_val.py:406-407).

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
