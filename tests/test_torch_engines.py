"""The port's copies of the depth, correspondence and object-perception QA
engines held against the JAX engines on the CPU, on the same scene store,
visibility and relations: depth estimation and comparison (coor and dot),
correspondence coor->coor and dot->multichoice, object perception, each in
train and eval, through the native emitter and the Python one. JSONL and
every annotated JPEG are byte-equal (both sides encode with the native
splice encoder) and the sample counts are equal. The port feeds the
engines the relation table as a dict of numpy columns; the JAX pipeline
feeds a DataFrame, and the port's engines read both. Frames are 96x128.
Tolerance: exact (bytes)."""

import os

import numpy as np
import pytest

from multi_spatialmllm_tpu.core.scene import SceneStore as JStore
from multi_spatialmllm_tpu.core.synthetic import make_scene
from multi_spatialmllm_tpu.engines import annotate as JA
from multi_spatialmllm_tpu.engines import depth_perception as JD
from multi_spatialmllm_tpu.engines import object_perception as JOP
from multi_spatialmllm_tpu.engines import visual_correspondence as JVC
from multi_spatialmllm_tpu.ingest import native as JN
from multi_spatialmllm_tpu.stages import coverage as JC
from multi_spatialmllm_tpu.stages import frame_relations as JF
from multi_spatialmllm_tpu.stages import object_visibility as JO
from multi_spatialmllm_tpu.stages import visibility as JV
from multi_spatialmllm_tpu_torch.core.scene import SceneStore as TStore
from multi_spatialmllm_tpu_torch.engines import annotate as TA
from multi_spatialmllm_tpu_torch.engines import depth_perception as TD
from multi_spatialmllm_tpu_torch.engines import object_perception as TOP
from multi_spatialmllm_tpu_torch.engines import visual_correspondence as TVC
from multi_spatialmllm_tpu_torch.stages import coverage as TC
from multi_spatialmllm_tpu_torch.stages import frame_relations as TF
from multi_spatialmllm_tpu_torch.stages import object_visibility as TO
from multi_spatialmllm_tpu_torch.stages import visibility as TV


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    # the JAX writer encodes natively only where its library is built
    JN.build()
    assert JN.jpeg_available()
    base = tmp_path_factory.mktemp("engines")
    scenes = [make_scene(scene_id=f"eng{i:04d}_00", seed=20 + i,
                         n_images=10, n_background=3000) for i in range(2)]
    JStore.write(scenes, str(base / "scenes"))
    js, ts = JStore(str(base / "scenes")), TStore(str(base / "scenes"))
    jvis = JV.VisibilityIndex.build(js)
    tvis = TV.VisibilityIndex.build(
        ts, lambda s: TV.compute_scene_visibility(s, device="cpu"))
    vmap = {sid: jvis.matrix(sid) for sid in jvis.scene_ids()}
    jrel = JF.build_frame_relations(js, visibility=vmap)
    trel = TF.build_frame_relations(ts, visibility=vmap, device="cpu")
    jov = JO.build_object_visibility(js, visibility=vmap)
    tov = TO.build_object_visibility(ts, visibility=vmap, device="cpu")
    jcov = dict(zip(("height", "length", "width"), JC.build_object_coverage(
        js, jov, visibility=vmap)))
    tcov = dict(zip(("height", "length", "width"), TC.build_object_coverage(
        ts, tov, visibility=vmap, device="cpu")))
    return {"base": base, "jax": (js, jvis, jrel, jcov),
            "port": (ts, tvis, trel, tcov), "hw": scenes[0].image_hw}


def _run(inputs, side, name, fn):
    """Run one engine call for `side` into its own directory; returns the
    written tree and the call's result."""
    root = inputs["base"] / name / side
    res = fn(str(root), *inputs[side],
             (JA if side == "jax" else TA).SyntheticImageProvider(
                 inputs["hw"]))
    return _tree(str(root)), res


def _counts(res):
    if isinstance(res, dict):
        return {k: (v.n_train, v.n_val) for k, v in res.items()}
    return (res.n_train, res.n_val)


def _assert_equal(inputs, name, call):
    jt, jres = _run(inputs, "jax", name, call["jax"])
    tt, tres = _run(inputs, "port", name, call["port"])
    assert sorted(tt) == sorted(jt) and jt
    for rel, data in jt.items():
        assert tt[rel] == data, rel
    assert _counts(tres) == _counts(jres)
    return jt


def _depth(mod, kind, variant, eval_mode, force_python):
    gen = getattr(mod, f"generate_depth_{kind}_to_jsonl")

    def call(root, store, vis, rel, cov, provider):
        dot = variant == "dot"
        return gen(store, vis, os.path.join(root, "out.jsonl"),
                   variant=variant, eval_mode=eval_mode,
                   image_provider=provider if dot else None,
                   image_output_dir=os.path.join(root, "images")
                   if dot else None,
                   config=mod.DepthEngineConfig(all_max_samples=40,
                                                max_n_points_per_image=2),
                   force_python=force_python)

    return call


@pytest.mark.parametrize("force_python", [False, True],
                         ids=["native", "python"])
@pytest.mark.parametrize("eval_mode", [False, True], ids=["train", "eval"])
@pytest.mark.parametrize("variant", ["coor", "dot"])
@pytest.mark.parametrize("kind", ["estimation", "comparison"])
def test_depth_engines_byte_equal(inputs, kind, variant, eval_mode,
                                  force_python):
    name = f"depth_{kind}_{variant}_{eval_mode}_{force_python}"
    tree = _assert_equal(inputs, name, {
        "jax": _depth(JD, kind, variant, eval_mode, force_python),
        "port": _depth(TD, kind, variant, eval_mode, force_python)})
    jpgs = [k for k in tree if k.endswith(".jpg")]
    assert bool(jpgs) == (variant == "dot")


def _corr(mod, dot, eval_mode, force_python):
    def call(root, store, vis, rel, cov, provider):
        cfg = mod.CorrespondenceConfig(overlap_min=0.1, overlap_max=100.0,
                                       interval=5.0)
        out = os.path.join(root, "out.jsonl")
        if dot:
            return mod.generate_dot_to_multichoice_to_jsonl(
                rel, store, vis, out, 30, os.path.join(root, "images"),
                image_provider=provider, config=cfg, eval_mode=eval_mode,
                force_python=force_python)
        return mod.generate_coor_to_coor_to_jsonl(
            rel, store, vis, out, 30, cfg, eval_mode=eval_mode,
            force_python=force_python)

    return call


@pytest.mark.parametrize("force_python", [False, True],
                         ids=["native", "python"])
@pytest.mark.parametrize("eval_mode", [False, True], ids=["train", "eval"])
@pytest.mark.parametrize("dot", [False, True],
                         ids=["coor_2_coor", "dot_2_multichoice"])
def test_correspondence_engines_byte_equal(inputs, dot, eval_mode,
                                           force_python):
    name = f"corr_{dot}_{eval_mode}_{force_python}"
    tree = _assert_equal(inputs, name, {
        "jax": _corr(JVC, dot, eval_mode, force_python),
        "port": _corr(TVC, dot, eval_mode, force_python)})
    assert bool([k for k in tree if k.endswith(".jpg")]) == dot


def test_correspondence_reads_a_dataframe_or_a_dict(inputs):
    """The port's engine on the JAX DataFrame writes what it writes from
    its own dict of columns; the dict holds the DataFrame's values in the
    four columns the engine reads."""
    pytest.importorskip("pandas")
    js, jvis, jrel, _ = inputs["jax"]
    ts, tvis, trel, _ = inputs["port"]
    assert isinstance(trel, dict)
    for c in ("scene_id", "image_id1", "image_id2", "overlap"):
        np.testing.assert_array_equal(trel[c], np.asarray(jrel[c]))
    cfg = TVC.CorrespondenceConfig(overlap_min=0.1, overlap_max=100.0,
                                   interval=5.0)
    base = inputs["base"] / "corr_df"
    outs = {}
    for tag, rel in (("dict", trel), ("frame", jrel)):
        TVC.generate_coor_to_coor_to_jsonl(
            rel, ts, tvis, str(base / tag / "out.jsonl"), 30, cfg)
        outs[tag] = _tree(str(base / tag))
    assert outs["dict"] == outs["frame"] and outs["dict"]


def _objects(mod, eval_mode, native, force_python):
    def call(root, store, vis, rel, cov, provider):
        return mod.generate(store, cov, root, "val" if eval_mode else
                            "train", eval_mode=eval_mode, use_native=native,
                            force_python=force_python)

    return call


@pytest.mark.parametrize("path", [(True, False), (True, True),
                                  (False, False)],
                         ids=["native", "python_vm", "dicts"])
@pytest.mark.parametrize("eval_mode", [False, True], ids=["train", "eval"])
def test_object_perception_byte_equal(inputs, eval_mode, path):
    native, force_python = path
    name = f"objects_{eval_mode}_{native}_{force_python}"
    tree = _assert_equal(inputs, name, {
        "jax": _objects(JOP, eval_mode, native, force_python),
        "port": _objects(TOP, eval_mode, native, force_python)})
    assert all(k.endswith(".jsonl") for k in tree)


def test_no_engine_reads_the_pitch_column():
    """Pitch is the one relation column the port holds within ulps rather
    than bits; no ported engine reads it."""
    import inspect

    from multi_spatialmllm_tpu_torch.engines import camera_movement as CM

    for mod in (TD, TVC, TOP):
        assert "pitch" not in inspect.getsource(mod), mod.__name__
    # camera movement reads it (tests/test_torch_camera_movement.py holds
    # its answers within the limit)
    assert "pitch" in inspect.getsource(CM)
