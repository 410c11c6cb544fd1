"""The port's camera-movement engine
(multi_spatialmllm_tpu_torch/engines/camera_movement.py) held against the
JAX engine on the CPU: the JSONL files byte-equal for all nine question
types, train and eval, through the native emitter (the port's loader
builds it at first use) and through the Python emitter; the same from the
raw relation table and from `PreparedRelations`; and the device path of
`compute_displacements` against the host one and the JAX device path."""

import numpy as np
import pytest
import torch

from multi_spatialmllm_tpu.core.scene import SceneStore as JStore
from multi_spatialmllm_tpu.core.synthetic import make_scene
from multi_spatialmllm_tpu.engines import camera_movement as JCM
from multi_spatialmllm_tpu.stages.frame_relations import build_frame_relations
from multi_spatialmllm_tpu.stages.visibility import compute_scene_visibility
from multi_spatialmllm_tpu_torch.core.scene import SceneStore as TStore
from multi_spatialmllm_tpu_torch.engines import camera_movement as TCM
from multi_spatialmllm_tpu_torch.ingest import native as TN

CFG = dict(overlap_min=0.1, overlap_max=100.0, interval=5.0)
N_TRAIN, N_VAL = 400, 60


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    # tests/test_engines.py's two scenes
    root = tmp_path_factory.mktemp("cm")
    scenes = [make_scene(scene_id=f"scene{i:04d}_00", seed=10 + i,
                         n_images=12, n_background=4000, n_objects=3)
              for i in range(2)]
    JStore.write(scenes, str(root / "scenes"))
    vis = {s.scene_id: compute_scene_visibility(s) for s in scenes}
    df = build_frame_relations(scenes, visibility=vis)
    table = {c: np.asarray(df[c]) for c in df.columns}
    return {"root": root, "df": df, "table": table,
            "jstore": JStore(str(root / "scenes")),
            "tstore": TStore(str(root / "scenes"))}


def test_copied_constants_and_config():
    assert TCM.QUESTION_TYPES == JCM.QUESTION_TYPES
    assert TCM.TRAIN_QUESTION_SAMPLES == JCM.TRAIN_QUESTION_SAMPLES
    assert TCM.VAL_QUESTION_SAMPLES == JCM.VAL_QUESTION_SAMPLES
    import dataclasses
    assert dataclasses.asdict(TCM.CameraMovementConfig()) == \
        dataclasses.asdict(JCM.CameraMovementConfig())


@pytest.mark.parametrize("emitter", ["native", "python"])
@pytest.mark.parametrize("qtype", JCM.QUESTION_TYPES)
def test_jsonl_byte_equal(env, tmp_path, qtype, emitter):
    force_python = emitter == "python"
    if not force_python:
        assert TN.native_available(), TN.build_error
    for eval_mode, n, split in ((False, N_TRAIN, "train"),
                                (True, N_VAL, "val")):
        j = tmp_path / f"j_{split}.jsonl"
        t = tmp_path / f"t_{split}.jsonl"
        rng = ("camera_movement", qtype, split)
        nj = JCM.generate_to_jsonl(
            env["df"], env["jstore"], qtype, n, str(j),
            JCM.CameraMovementConfig(**CFG),
            JCM.stream(0, *rng), eval_mode=eval_mode,
            force_python=force_python)
        nt = TCM.generate_to_jsonl(
            env["table"], env["tstore"], qtype, n, str(t),
            TCM.CameraMovementConfig(**CFG),
            TCM.stream(0, *rng), eval_mode=eval_mode,
            force_python=force_python)
        assert nt == nj > 0
        assert t.read_bytes() == j.read_bytes(), (qtype, split)


def test_generate_prepared_byte_equal(env, tmp_path):
    """`generate` (PreparedRelations shared by every type) over all nine
    types, train and val files."""
    counts = {q: 120 for q in JCM.QUESTION_TYPES}
    val = {q: 30 for q in JCM.QUESTION_TYPES}
    jo = JCM.generate(env["df"], env["df"], env["jstore"],
                      str(tmp_path / "j" / "train"), str(tmp_path / "j" / "val"),
                      counts, val, JCM.CameraMovementConfig(**CFG))
    to = TCM.generate(env["table"], env["table"], env["tstore"],
                      str(tmp_path / "t" / "train"), str(tmp_path / "t" / "val"),
                      counts, val, TCM.CameraMovementConfig(**CFG))
    assert set(to) == set(jo)
    for q in JCM.QUESTION_TYPES:
        assert (to[q].n_train, to[q].n_val) == (jo[q].n_train, jo[q].n_val)
        for split, name in (("train", f"{q}_train.jsonl"),
                            ("val", f"{q}_val.jsonl")):
            a = (tmp_path / "t" / split / name).read_bytes()
            b = (tmp_path / "j" / split / name).read_bytes()
            assert a == b and a, (q, split)


def test_device_displacements(env):
    prep = TCM.prepare_relations(env["table"], env["tstore"])
    E1 = prep.ext_flat[prep.ext_off[prep.scene_idx] + prep.i1]
    E2 = prep.ext_flat[prep.ext_off[prep.scene_idx] + prep.i2]
    host = TCM.compute_displacements(E1, E2, chunk=64)
    np.testing.assert_array_equal(host,
                                  JCM.compute_displacements(E1, E2, 64))
    dev = TCM.compute_displacements(E1, E2, chunk=64, device="cpu")
    jdev = JCM.compute_displacements(E1, E2, 64, device=True)
    # the device paths compose se3_inverse (closed form) with E2; XLA's
    # CPU code contracts its products into FMAs, the port does not
    np.testing.assert_allclose(dev, jdev, rtol=0, atol=1e-13)
    np.testing.assert_allclose(dev, host, rtol=0, atol=1e-13)
    assert dev.dtype == np.float64 and dev.shape == (len(E1), 3)


def test_device_path_refuses_a_missing_device(env):
    E = np.tile(np.eye(4), (2, 1, 1))
    with pytest.raises((RuntimeError, AssertionError)):
        TCM.compute_displacements(E, E, 8, device="cuda:7"
                                  if torch.cuda.is_available() else "cuda")
