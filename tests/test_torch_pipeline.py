"""The port's data-engine pipeline (multi_spatialmllm_tpu_torch/pipeline.py)
against the JAX pipeline on the CPU at demo scale: the same scene store
through `visibility()`, `frame_relations()` and `run_camera_movement()` at
`run_all`'s demo counts. `indices/visibility.npz` and the whole
`qa/**/camera_movement` tree are byte-equal, the relations parquet holds
equal columns (pitch within its ulp limit), the manifests' lines are equal
but for the output root, and a second run resumes without rerunning a
unit."""

import json
import os

import numpy as np
import pandas as pd
import pytest

from multi_spatialmllm_tpu.core.scene import SceneStore as JStore
from multi_spatialmllm_tpu.core.synthetic import make_scene
from multi_spatialmllm_tpu.pipeline import PipelineConfig as JConfig
from multi_spatialmllm_tpu.pipeline import SpatialEnginePipeline as JPipe
from multi_spatialmllm_tpu_torch import __main__ as cli
from multi_spatialmllm_tpu_torch.core.scene import SceneStore as TStore
from multi_spatialmllm_tpu_torch.pipeline import PipelineConfig as TConfig
from multi_spatialmllm_tpu_torch.pipeline import SpatialEnginePipeline as TPipe

from test_torch_geometry import PITCH_ULP

DEMO = dict(overlap_min=0.1, overlap_max=100.0, interval=5.0)


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = p
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("pipe")
    # the demo command's scenes (`demo --scenes 2 --images-per-scene 12
    # --points-per-scene 4000`)
    scenes = [make_scene(scene_id=f"demo{i:04d}_00", seed=i, n_images=12,
                         n_background=4000) for i in range(2)]
    JStore.write(scenes, str(base / "scenes"))
    train, val = cli.DEMO_CAMERA_COUNTS
    jroot, troot = str(base / "jax"), str(base / "port")
    j = JPipe(JStore(str(base / "scenes")), jroot, JConfig(**DEMO))
    j.visibility()
    j.frame_relations()
    jres = j.run_camera_movement(train_counts=train, val_counts=val)
    t = TPipe(TStore(str(base / "scenes")), troot, TConfig(**DEMO),
              device="cpu")
    tres = cli._run_data_engine(t)["camera_movement"]
    return {"jroot": jroot, "troot": troot, "jres": jres, "tres": tres,
            "store": str(base / "scenes")}


def test_visibility_npz_byte_equal(runs):
    rel = os.path.join("indices", "visibility.npz")
    with open(os.path.join(runs["troot"], rel), "rb") as f, \
            open(os.path.join(runs["jroot"], rel), "rb") as g:
        assert f.read() == g.read()


def test_relations_parquet_columns(runs):
    rel = os.path.join("indices", "frame_relations.parquet")
    for name in (rel, rel.replace(".parquet", "_nonzero.parquet")):
        t = pd.read_parquet(os.path.join(runs["troot"], name))
        j = pd.read_parquet(os.path.join(runs["jroot"], name))
        assert list(t.columns) == list(j.columns) and len(t) == len(j) > 0
        assert dict(t.dtypes) == dict(j.dtypes)
        for c in ("scene_id", "image_id1", "image_id2", "overlap",
                  "distance", "yaw"):
            np.testing.assert_array_equal(np.asarray(t[c]), np.asarray(j[c]),
                                          err_msg=c)
        np.testing.assert_allclose(
            np.asarray(t["pitch"]), np.asarray(j["pitch"]), rtol=0,
            atol=2 * PITCH_ULP * np.spacing(90.0))


def test_qa_tree_byte_equal(runs):
    jt = _tree(os.path.join(runs["jroot"], "qa"))
    tt = _tree(os.path.join(runs["troot"], "qa"))
    assert sorted(tt) == sorted(jt) and len(tt) == 2
    for rel, p in jt.items():
        with open(p, "rb") as f, open(tt[rel], "rb") as g:
            assert g.read() == f.read(), rel
    assert {k: (v.n_train, v.n_val) for k, v in runs["tres"].items()} == \
        {k: (v.n_train, v.n_val) for k, v in runs["jres"].items()}


def _manifest(root):
    with open(os.path.join(root, "manifest.jsonl")) as f:
        return [json.loads(line.replace(root, "<root>")) for line in f]


def test_manifest_lines_equal(runs):
    assert _manifest(runs["troot"]) == _manifest(runs["jroot"])


def test_resume_without_rerunning_a_unit(runs):
    """As tests/test_pipeline.py pins for JAX: a fresh pipeline over the
    same root skips every finished unit (no file rewritten, no manifest
    line added, counts revived); a changed count reruns its unit."""
    root = runs["troot"]
    files = {p: os.path.getmtime(p) for p in _tree(root).values()
             if "scenes" not in p and not p.endswith("events.jsonl")}
    lines = _manifest(root)
    again = TPipe(TStore(runs["store"]), root, TConfig(**DEMO), device="cpu")
    res = cli._run_data_engine(again)["camera_movement"]
    assert {k: (v.n_train, v.n_val) for k, v in res.items()} == \
        {k: (v.n_train, v.n_val) for k, v in runs["tres"].items()}
    assert _manifest(root) == lines
    for p, mtime in files.items():
        assert os.path.getmtime(p) == mtime, p
    third = TPipe(TStore(runs["store"]), root, TConfig(**DEMO), device="cpu")
    out = third.run_camera_movement(train_counts={"total_distance": 40},
                                    val_counts={"total_distance": 5})
    assert out["total_distance"].n_train <= 40
    assert len(_manifest(root)) == len(lines) + 1


def test_hybrid_dtype_raises(runs, tmp_path):
    pipe = TPipe(TStore(runs["store"]), str(tmp_path),
                 TConfig(dtype="hybrid"), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        pipe.visibility()


def test_no_parquet_writer_recorded_not_pretended(runs, tmp_path,
                                                  monkeypatch):
    """Without pandas/pyarrow the relations parquet is not written: the
    manifest unit says `"parquet": null`, events.jsonl says why, and the
    QA files are those of a run that wrote it."""
    from multi_spatialmllm_tpu_torch import pipeline as TP

    monkeypatch.setattr(TP, "parquet_unavailable",
                        lambda: "No module named 'pyarrow'")
    root = str(tmp_path / "nopq")
    pipe = TPipe(TStore(runs["store"]), root, TConfig(**DEMO), device="cpu")
    cli._run_data_engine(pipe)
    assert not os.path.exists(
        os.path.join(root, "indices", "frame_relations.parquet"))
    rec = [r for r in _manifest(root) if r["stage"] == "frame_relations"]
    assert rec[0]["outputs"]["parquet"] is None
    with open(os.path.join(root, "events.jsonl")) as f:
        assert "parquet_not_written" in f.read()
    qa, ref = _tree(os.path.join(root, "qa")), _tree(
        os.path.join(runs["jroot"], "qa"))
    assert sorted(qa) == sorted(ref)
    for rel, p in qa.items():
        with open(p, "rb") as f, open(ref[rel], "rb") as g:
            assert f.read() == g.read(), rel


def test_pipeline_command_against_the_jax_stages(runs, tmp_path):
    """`pipeline --device cpu` over the store (the production sampler
    config): its camera-movement tree equals the JAX pipeline's stages and
    engine run with the same config; `--trace-dir` is refused."""
    out = str(tmp_path / "cli")
    cli.main(["pipeline", "--scenes", runs["store"], "--output", out,
              "--device", "cpu"])
    j = JPipe(JStore(runs["store"]), str(tmp_path / "jax"), JConfig())
    train, val = cli.DEMO_CAMERA_COUNTS
    j.run_camera_movement(train_counts=train, val_counts=val)
    jt, tt = _tree(os.path.join(j.root, "qa")), _tree(os.path.join(out, "qa"))
    assert sorted(tt) == sorted(jt) and tt
    for rel, p in jt.items():
        with open(p, "rb") as f, open(tt[rel], "rb") as g:
            assert g.read() == f.read(), rel
    with pytest.raises(NotImplementedError, match="trace-dir"):
        cli.main(["pipeline", "--scenes", runs["store"], "--output", out,
                  "--device", "cpu", "--trace-dir", str(tmp_path / "t")])
