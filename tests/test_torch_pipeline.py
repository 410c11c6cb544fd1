"""The port's data-engine pipeline (multi_spatialmllm_tpu_torch/pipeline.py)
against the JAX pipeline on the CPU at demo scale: the same scene store
through `run_all()`. `indices/visibility.npz`, the object-visibility and
coverage pickles and the whole `qa/` tree (JSONL and annotated JPEGs) are
byte-equal, the relations parquet holds equal columns (pitch within its
ulp limit), the manifests' lines are equal but for the output root, a
second run resumes without rerunning a unit; with TAPVid records the
object-movement units add the JAX pipeline's files and manifest lines, and
the `demo` and `tapvid` commands write the JAX commands' trees. Both
pipelines run in one process: the synthetic frames are seeded from
Python's string hash."""

import json
import os
import shutil
import sys

import numpy as np
import pandas as pd
import pytest

from multi_spatialmllm_tpu.core.scene import SceneStore as JStore
from multi_spatialmllm_tpu.core.synthetic import make_scene, make_tapvid_npz
from multi_spatialmllm_tpu.ingest import native as JN
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
    # the JAX writer encodes natively only where its library is built
    JN.build()
    assert JN.jpeg_available()
    jroot, troot = str(base / "jax"), str(base / "port")
    jres = JPipe(JStore(str(base / "scenes")), jroot,
                 JConfig(**DEMO)).run_all()
    t = TPipe(TStore(str(base / "scenes")), troot, TConfig(**DEMO),
              device="cpu")
    tres = t.run_all()
    return {"jroot": jroot, "troot": troot, "jres": jres, "tres": tres,
            "store": str(base / "scenes")}


def _counts(res):
    """{engine: {unit: (n_train, n_val)}}, object perception's per
    dimension."""
    def one(v):
        if isinstance(v, dict):
            return {k: one(x) for k, x in v.items()}
        return (v.n_train, v.n_val)

    return one(res)


def _assert_trees_equal(got_root, want_root, skip=()):
    want = {k: p for k, p in _tree(want_root).items()
            if not k.startswith(skip)}
    got = _tree(got_root)
    assert sorted(got) == sorted(want) and got
    for rel, p in want.items():
        with open(p, "rb") as f, open(got[rel], "rb") as g:
            assert g.read() == f.read(), rel
    return got


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
    tree = _assert_trees_equal(os.path.join(runs["troot"], "qa"),
                               os.path.join(runs["jroot"], "qa"))
    engines = {rel.split(os.sep)[1] for rel in tree}
    assert engines == {
        "camera_movement", "depth_estimation_coor", "depth_comparison_coor",
        "depth_estimation_dot", "depth_comparison_dot",
        "visual_correspondence_coor_2_coor",
        "visual_correspondence_dot_2_multichoice", "object_perception"}
    assert sum(rel.endswith(".jpg") for rel in tree) > 100
    assert _counts(runs["tres"]) == _counts(runs["jres"])
    assert sorted(runs["tres"]) == ["camera_movement", "depth_perception",
                                    "object_perception",
                                    "visual_correspondence"]


@pytest.mark.parametrize("name", [
    "object_visibility.pkl", "coverage_height.pkl", "coverage_length.pkl",
    "coverage_width.pkl"])
def test_index_pickles_byte_equal(runs, name):
    rel = os.path.join("indices", name)
    with open(os.path.join(runs["troot"], rel), "rb") as f, \
            open(os.path.join(runs["jroot"], rel), "rb") as g:
        got = f.read()
        assert got == g.read() and got


def _manifest(root, *other_roots):
    with open(os.path.join(root, "manifest.jsonl")) as f:
        text = f.read()
    for r in (root, *other_roots):
        text = text.replace(r, "<root>")
    return [json.loads(line) for line in text.splitlines()]


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
    res = again.run_all()
    assert _counts(res) == _counts(runs["tres"])
    assert _manifest(root) == lines
    for p, mtime in files.items():
        assert os.path.getmtime(p) == mtime, p
    third = TPipe(TStore(runs["store"]), root, TConfig(**DEMO), device="cpu")
    out = third.run_camera_movement(train_counts={"total_distance": 40},
                                    val_counts={"total_distance": 5})
    assert out["total_distance"].n_train <= 40
    assert len(_manifest(root)) == len(lines) + 1


def test_hybrid_visibility_equals_jax(runs, tmp_path):
    """`PipelineConfig(dtype="hybrid")` runs the hybrid stage: its
    visibility index is the JAX hybrid pipeline's file byte for byte and
    holds the float64 run's matrices, and its manifest line (the config
    hash included) is the JAX pipeline's."""
    from multi_spatialmllm_tpu_torch.stages.visibility import VisibilityIndex

    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "port")
    JPipe(JStore(runs["store"]), jroot, JConfig(dtype="hybrid")).visibility()
    got = TPipe(TStore(runs["store"]), troot, TConfig(dtype="hybrid"),
                device="cpu").visibility()
    f64 = VisibilityIndex.load_npz(
        os.path.join(runs["troot"], "indices", "visibility.npz"))
    assert got.scene_ids() == f64.scene_ids()
    for sid in f64.scene_ids():
        np.testing.assert_array_equal(got.matrix(sid), f64.matrix(sid))
    path = os.path.join("indices", "visibility.npz")
    with open(os.path.join(troot, path), "rb") as f, \
            open(os.path.join(jroot, path), "rb") as g:
        assert f.read() == g.read()
    assert _manifest(troot) == _manifest(jroot)


def test_hybrid_run_all_equals_jax(runs, tmp_path):
    """The whole `run_all` under `dtype="hybrid"` (visibility from the
    hybrid stage, the later stages in float32) writes the JAX hybrid
    pipeline's files: the qa/ tree, the index pickles and visibility.npz
    byte-equal, the relation columns equal (pitch within its float32 ulp
    limit), the manifests equal."""
    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "port")
    jres = JPipe(JStore(runs["store"]), jroot,
                 JConfig(dtype="hybrid", **DEMO)).run_all()
    tres = TPipe(TStore(runs["store"]), troot,
                 TConfig(dtype="hybrid", **DEMO), device="cpu").run_all()
    assert _counts(tres) == _counts(jres)
    tree = _assert_trees_equal(os.path.join(troot, "qa"),
                               os.path.join(jroot, "qa"))
    assert sum(rel.endswith(".jpg") for rel in tree) > 100
    for name in ("visibility.npz", "object_visibility.pkl",
                 "coverage_height.pkl", "coverage_length.pkl",
                 "coverage_width.pkl"):
        with open(os.path.join(troot, "indices", name), "rb") as f, \
                open(os.path.join(jroot, "indices", name), "rb") as g:
            assert f.read() == g.read(), name
    rel = os.path.join("indices", "frame_relations.parquet")
    t = pd.read_parquet(os.path.join(troot, rel))
    j = pd.read_parquet(os.path.join(jroot, rel))
    assert dict(t.dtypes) == dict(j.dtypes) and len(t) == len(j) > 0
    assert t["yaw"].dtype == np.float32
    for c in ("scene_id", "image_id1", "image_id2", "overlap", "distance",
              "yaw"):
        np.testing.assert_array_equal(np.asarray(t[c]), np.asarray(j[c]),
                                      err_msg=c)
    np.testing.assert_allclose(
        np.asarray(t["pitch"]), np.asarray(j["pitch"]), rtol=0,
        atol=2 * PITCH_ULP * np.spacing(np.float32(90.0)))
    assert _manifest(troot) == _manifest(jroot)


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
    pipe.run_all()
    assert not os.path.exists(
        os.path.join(root, "indices", "frame_relations.parquet"))
    rec = [r for r in _manifest(root) if r["stage"] == "frame_relations"]
    assert rec[0]["outputs"]["parquet"] is None
    with open(os.path.join(root, "events.jsonl")) as f:
        assert "parquet_not_written" in f.read()
    _assert_trees_equal(os.path.join(root, "qa"),
                        os.path.join(runs["jroot"], "qa"))


def test_pipeline_command_against_the_jax_stages(runs, tmp_path):
    """`pipeline --device cpu` over the store (the production sampler
    config): its qa tree and index pickles equal the JAX pipeline's
    `run_all` with the same config; with `--trace-dir` it writes a
    torch.profiler trace of the L3 stages and the same qa tree."""
    out = str(tmp_path / "cli")
    cli.main(["pipeline", "--scenes", runs["store"], "--output", out,
              "--device", "cpu"])
    j = JPipe(JStore(runs["store"]), str(tmp_path / "jax"), JConfig())
    j.run_all()
    _assert_trees_equal(os.path.join(out, "qa"), os.path.join(j.root, "qa"))
    for name in ("object_visibility.pkl", "coverage_height.pkl"):
        with open(os.path.join(out, "indices", name), "rb") as f, \
                open(os.path.join(j.root, "indices", name), "rb") as g:
            assert f.read() == g.read(), name
    traced = str(tmp_path / "traced")
    cli.main(["pipeline", "--scenes", runs["store"], "--output", traced,
              "--device", "cpu", "--trace-dir", str(tmp_path / "t")])
    [trace] = os.listdir(tmp_path / "t")
    with open(tmp_path / "t" / trace) as f:
        assert json.load(f)["traceEvents"]
    _assert_trees_equal(os.path.join(traced, "qa"), os.path.join(out, "qa"))


def test_run_all_with_tapvid_records_against_jax(runs, tmp_path):
    """`run_all(tapvid_records=...)` over copies of both finished roots
    runs the object-movement units (coord and dot, train and eval):
    their qa trees, `_orig` dumps and frames included, are byte-equal and
    the manifest lines they add equal; a second run rewrites nothing, and
    new records rerun those units alone."""
    records = {f"seq{i}": make_tapvid_npz(seed=60 + i) for i in range(2)}
    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "port")
    shutil.copytree(runs["jroot"], jroot)
    shutil.copytree(runs["troot"], troot)
    before = {r: len(_manifest(r)) for r in (jroot, troot)}
    jres = JPipe(JStore(runs["store"]), jroot,
                 JConfig(**DEMO)).run_all(tapvid_records=records)
    t = TPipe(TStore(runs["store"]), troot, TConfig(**DEMO), device="cpu")
    tres = t.run_all(tapvid_records=records)
    assert _counts(tres["object_movement"]) == _counts(jres["object_movement"])
    assert sorted(tres["object_movement"]) == [
        "coord_eval", "coord_train", "dot_eval", "dot_train"]
    om = []
    for split in ("training_data", "evaluation_data"):
        for engine in ("object_movement_coord", "object_movement_dot"):
            rel = os.path.join("qa", split, engine)
            om += _assert_trees_equal(os.path.join(troot, rel),
                                      os.path.join(jroot, rel))
    assert any(rel.endswith("_orig.jsonl") for rel in om)
    assert sum(rel.endswith("_annotated.jpg") for rel in om) > 10
    added = {r: [ln for ln in _manifest(r, o)[before[r]:]
                 if ln["stage"].startswith("engine.object_movement")]
             for r, o in ((troot, runs["troot"]), (jroot, runs["jroot"]))}
    assert added[troot] == added[jroot] and len(added[troot]) == 4
    lines = _manifest(troot, runs["troot"])
    files = {p: os.path.getmtime(p) for p in _tree(troot).values()
             if not p.endswith("events.jsonl")}
    again = TPipe(TStore(runs["store"]), troot, TConfig(**DEMO), device="cpu")
    assert _counts(again.run_all(tapvid_records=records)) == _counts(tres)
    assert _manifest(troot, runs["troot"]) == lines
    for p, mtime in files.items():
        assert os.path.getmtime(p) == mtime, p
    changed = dict(records, seq1=make_tapvid_npz(seed=70))
    again.run_all(tapvid_records=changed)
    new = _manifest(troot, runs["troot"])[len(lines):]
    assert sorted(r["stage"] for r in new) == sorted(
        2 * ["engine.object_movement_coord", "engine.object_movement_dot"])


def test_demo_command_against_the_jax_demo(tmp_path, capsys, monkeypatch):
    """`demo --device cpu` writes the JAX `demo`'s whole tree, the
    object-movement engines' JSONL and frames included, and prints its
    summary."""
    from multi_spatialmllm_tpu import __main__ as jcli

    JN.build()
    args = ["--scenes", "2", "--images-per-scene", "8",
            "--points-per-scene", "2000"]
    monkeypatch.setattr(sys, "argv", ["multi_spatialmllm_tpu", "demo",
                                      "--output", str(tmp_path / "jax"),
                                      *args])
    jcli.main()
    jsum = json.loads(capsys.readouterr().out)
    cli.main(["demo", "--output", str(tmp_path / "port"), "--device", "cpu",
              *args])
    tsum = json.loads(capsys.readouterr().out)
    assert tsum == jsum and jsum["object_movement"]
    tree = _assert_trees_equal(str(tmp_path / "port" / "qa"),
                               str(tmp_path / "jax" / "qa"))
    assert {rel.split(os.sep)[1] for rel in tree} >= {
        "object_movement_coord", "object_movement_dot"}


def _tapvid_split(root, split, ids, seed):
    """TAPVid-3D npz files as `<root>/adt/<id>.npz` and a `--meta` dir
    listing them."""
    os.makedirs(os.path.join(root, "data", "adt"), exist_ok=True)
    os.makedirs(os.path.join(root, "meta", "adt"), exist_ok=True)
    for i, sid in enumerate(ids):
        make_tapvid_npz(os.path.join(root, "data", "adt", f"{sid}.npz"),
                        seed=seed + i)
    with open(os.path.join(root, "meta", "adt", f"{split}.txt"), "w") as f:
        f.write("".join(f"{sid}\n" for sid in ids))


@pytest.mark.parametrize("dot", [False, True], ids=["coord", "dot"])
@pytest.mark.parametrize("split", ["train", "val"])
def test_tapvid_command_against_the_jax_command(tmp_path, capsys,
                                                monkeypatch, split, dot):
    from multi_spatialmllm_tpu import __main__ as jcli

    _tapvid_split(str(tmp_path), split, ["clip_a", "clip_b"], seed=80)
    args = ["--data", str(tmp_path / "data"), "--meta",
            str(tmp_path / "meta"), "--split", split] + (["--dot"] * dot)
    monkeypatch.setattr(sys, "argv", ["multi_spatialmllm_tpu", "tapvid",
                                      "--output", str(tmp_path / "jax"),
                                      *args])
    jcli.main()
    jout = capsys.readouterr().out
    cli.main(["tapvid", "--output", str(tmp_path / "port"), "--device",
              "cpu", *args])
    assert capsys.readouterr().out == jout and "samples" in jout
    tree = _assert_trees_equal(str(tmp_path / "port"), str(tmp_path / "jax"))
    assert sum(rel.endswith(".jsonl") for rel in tree) == (
        4 if split == "val" else 2)
    assert any(rel.endswith("_annotated.jpg") for rel in tree) == dot
