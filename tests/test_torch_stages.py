"""The port's L3 stages (multi_spatialmllm_tpu_torch/stages/) held against
the JAX stages on the CPU, on tests/test_stages.py's own scenes: the
visibility bits and packed bytes equal in f64 and f32, single, chunked and
batched; the relation table's columns equal (pitch within the ulp limit
of tests/test_torch_geometry.py); the parquet files byte-equal."""

import functools

import numpy as np
import pandas as pd
import pytest
import torch

from multi_spatialmllm_tpu.core.synthetic import make_scene
from multi_spatialmllm_tpu.stages import frame_relations as JF
from multi_spatialmllm_tpu.stages import visibility as JV
from multi_spatialmllm_tpu_torch.stages import frame_relations as TF
from multi_spatialmllm_tpu_torch.stages import visibility as TV

from test_torch_geometry import PITCH_ULP

DTYPES = [np.float64, np.float32]


@pytest.fixture(scope="module")
def scene():
    # tests/test_stages.py:28
    return make_scene(seed=2, n_images=10, n_background=3000, n_objects=3)


@pytest.fixture(scope="module")
def scenes():
    # tests/test_stages.py's batched-visibility scenes, an odd shape among
    # them (:311)
    out = [make_scene(scene_id=f"vb{i}_00", seed=50 + i, n_images=10,
                      n_background=2000, n_objects=2) for i in range(3)]
    out.append(make_scene(scene_id="vb_odd_00", seed=60, n_images=6,
                          n_background=1500, n_objects=2))
    return out


@pytest.mark.parametrize("dt", DTYPES)
def test_scene_visibility_bits_equal(scene, dt):
    want = JV.compute_scene_visibility(scene, dt)
    got = TV.compute_scene_visibility(scene, dt, device="cpu")
    assert want.shape == (scene.num_images, scene.num_points)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("chunk", [4, 8, 16])   # 16 pads the image axis
def test_chunked_visibility_bits_equal(dt, chunk):
    s = make_scene(scene_id="vchunk_00", seed=77, n_images=14,
                   n_background=3000, n_objects=2)
    want = JV.compute_scene_visibility(s, dt, image_chunk=chunk)
    got = TV.compute_scene_visibility(s, dt, image_chunk=chunk,
                                      device="cpu")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, TV.compute_scene_visibility(s, dt, device="cpu"))


@pytest.mark.parametrize("dt", DTYPES)
def test_batched_visibility_bits_equal(scenes, dt):
    want = JV.compute_visibility_batch(scenes, dt, batch_size=2)
    got = TV.compute_visibility_batch(scenes, dt, batch_size=2,
                                      device="cpu")
    assert set(got) == set(want) == {s.scene_id for s in scenes}
    for sid in want:
        np.testing.assert_array_equal(got[sid], want[sid], err_msg=sid)


@pytest.mark.parametrize("dt", DTYPES)
def test_packed_program_bytes_equal(scene, dt):
    """The device program's packed output, byte for byte."""
    pts, pv = scene.padded_points(dt)
    ext, depth, iv = scene.padded_images(dt)
    K = scene.intrinsic.astype(dt)
    want = np.asarray(JV._visibility_fn(
        ext.shape[0], pts.shape[0], scene.depth_hw, scene.image_hw,
        np.dtype(dt).name)(pts, K, ext, depth, iv, pv))
    got = TV._visibility_packed(
        *(torch.from_numpy(a) for a in (pts, K, ext, depth.astype(np.int32),
                                        iv, pv)), scene.image_hw).numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_image_chunk_plan():
    assert TV.image_chunk_for(16, 1024, np.float64) is None
    assert TV.image_chunk_for(16, 1024, np.float64, image_chunk=8) == 8
    assert TV.image_chunk_for(16, 1024, np.float64, image_chunk=16) is None
    for dt, budget in ((np.float64, TV._PAIR_BUDGET_F64),
                       (np.float32, TV._PAIR_BUDGET_F32)):
        n = budget // 50
        assert TV.image_chunk_for(304, n, dt) == 48
        assert TV.image_chunk_for(48, n, dt) is None


def test_packbits_bytes_equal():
    mask = np.random.default_rng(0).random((3, 5, 256)) < 0.3
    want = np.asarray(JV._packbits(mask))
    got = TV._packbits(torch.from_numpy(mask)).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.packbits(mask, axis=-1))
    np.testing.assert_array_equal(TF._unpack_bits(torch.from_numpy(got),
                                                  250).numpy(),
                                  np.asarray(JF._unpack_bits(want, 250)))


def test_visibility_index_build_takes_the_compute_function(scene, tmp_path):
    compute = functools.partial(TV.compute_scene_visibility, device="cpu")
    warns = []
    index = TV.VisibilityIndex.build([scene], compute, warning_sink=warns.append)
    np.testing.assert_array_equal(index.matrix(scene.scene_id),
                                  JV.compute_scene_visibility(scene))
    # the JAX index written from the same matrix: same npz payload
    ref = JV.VisibilityIndex()
    ref.add_scene(scene.scene_id, scene.image_ids,
                  index.matrix(scene.scene_id))
    ref.save_npz(str(tmp_path / "j.npz"))
    index.save_npz(str(tmp_path / "t.npz"))
    j, t = np.load(tmp_path / "j.npz"), np.load(tmp_path / "t.npz")
    assert sorted(j.files) == sorted(t.files)
    for k in j.files:
        np.testing.assert_array_equal(t[k], j[k])
    back = TV.VisibilityIndex.load_npz(str(tmp_path / "t.npz"))
    np.testing.assert_array_equal(back.matrix(scene.scene_id),
                                  index.matrix(scene.scene_id))


def _assert_columns(got: dict, want, dt):
    assert list(got) == list(want.columns)
    for c in ("scene_id", "image_id1", "image_id2"):
        assert got[c].dtype == object
        assert got[c].tolist() == np.asarray(want[c]).tolist(), c
    for c in ("overlap", "distance", "yaw"):
        w = np.asarray(want[c])
        assert got[c].dtype == w.dtype, c
        np.testing.assert_array_equal(got[c], w, err_msg=c)
    limit = 2 * PITCH_ULP * np.spacing(np.dtype(dt).type(90.0))
    np.testing.assert_allclose(got["pitch"], np.asarray(want["pitch"]),
                               rtol=0, atol=limit)


@pytest.mark.parametrize("dt", DTYPES)
def test_relation_columns(scenes, dt):
    vis = JV.compute_visibility_batch(scenes, dt, batch_size=2)
    want = JF.build_frame_relations(scenes, dtype=dt, visibility=vis)
    got = TF.build_frame_relations(scenes, dtype=dt, visibility=vis,
                                   device="cpu")
    assert len(want) > 0
    _assert_columns(got, want, dt)
    # without precomputed visibility: per-scene relations
    got1 = TF.build_frame_relations(scenes[:1], dtype=dt, device="cpu")
    _assert_columns(got1, JF.build_frame_relations(scenes[:1], dtype=dt), dt)


def test_scene_relation_matrices(scene):
    vis = JV.compute_scene_visibility(scene)
    want = JF.compute_scene_relations(scene, vis=vis)
    got = TF.compute_scene_relations(scene, vis=vis, device="cpu")
    for k in ("overlap", "distance", "yaw"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_relation_parquet_bytes_equal(scenes, tmp_path):
    """Where every column is bit-equal, so are the files; the pitch column
    takes the JAX values here so that the writer alone is compared."""
    vis = JV.compute_visibility_batch(scenes, np.float64, batch_size=2)
    want = JF.build_frame_relations(scenes, visibility=vis)
    rels = JF._batched_scene_relations(scenes, vis, np.float64)
    records = [TF.scene_relation_records(s, rels[s.scene_id])
               for s in scenes]
    TF._write_parquet(records, str(tmp_path / "t" / "rel.parquet"))
    JF._relations_frame(
        [pd.DataFrame(r) for r in records],
        str(tmp_path / "j" / "rel.parquet"))
    for name in ("rel.parquet", "rel_nonzero.parquet"):
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes(), name
    assert len(want) == sum(len(r["overlap"]) for r in records)


def test_warnings_match(scenes, tmp_path):
    vis = JV.compute_visibility_batch(scenes, np.float64, batch_size=2)
    JF.build_frame_relations(scenes, visibility=vis,
                             warning_path=str(tmp_path / "j.txt"))
    TF.build_frame_relations(scenes, visibility=vis, device="cpu",
                             warning_path=str(tmp_path / "t.txt"))
    j, t = tmp_path / "j.txt", tmp_path / "t.txt"
    assert j.exists() == t.exists()
    if j.exists():
        assert t.read_text() == j.read_text()
