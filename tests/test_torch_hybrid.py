"""The port's hybrid visibility stage and its cross-scene pipelined
projection held against the JAX package on the CPU, on
tests/test_stages.py's own scenes (:359, :389, :519): the float32 pass's
`vis` bits equal to JAX's, its borderline mask within NEAR_SHARE of JAX's
share of flagged pairs, and the finished labels equal to the JAX hybrid's,
the JAX float64 stage's and the numpy oracle's bit for bit, chunked and
unchunked; `project_scenes_pipelined` equal to the sequential loop and to
the JAX generator (vis bits equal; relations at tests/test_torch_stages.py's
tolerances)."""

import numpy as np
import pytest
import torch

from multi_spatialmllm_tpu.core import geometry as JG
from multi_spatialmllm_tpu.core.synthetic import make_scene
from multi_spatialmllm_tpu.stages import frame_relations as JF
from multi_spatialmllm_tpu.stages import visibility as JV
from multi_spatialmllm_tpu_torch.core import geometry as TG
from multi_spatialmllm_tpu_torch.stages import frame_relations as TF
from multi_spatialmllm_tpu_torch.stages import visibility as TV

from test_stages import _numpy_visibility_oracle
from test_torch_geometry import PITCH_ULP

# the port's float32 coordinates round apart from XLA's HIGHEST-precision
# dot now and then (core/geometry.py), so a coordinate within a float32 ulp
# of a band's edge may be flagged by one side alone: the flagged shares
# agree within NEAR_SHARE of the pairs and the masks differ in at most
# NEAR_DIFF of them (measured on these scenes: shares 1.27-1.40%, apart by
# at most 4 of 63,488 pairs, 6.3e-5; 8-16 pairs differ, up to 2.5e-4).
# The finished labels are equal all the same.
NEAR_SHARE = 1e-4
NEAR_DIFF = 5e-4


def _hybrid_scene(seed):
    # tests/test_stages.py:359
    return make_scene(scene_id=f"hyb{seed:04d}_00", seed=seed, n_images=12,
                      n_background=3000, n_objects=3, n_invalid_poses=1)


def _borderline(mod, s, asarray):
    pts, pv = s.padded_points(np.float32)
    ext, depth, iv = s.padded_images(np.float32)
    depth = depth.astype(np.int32)
    vis, near = mod.visibility_and_borderline(
        *(asarray(a) for a in (pts, s.intrinsic.astype(np.float32), ext,
                                depth)),
        s.image_hw, asarray(iv), asarray(pv))
    return np.asarray(vis), np.asarray(near)


@pytest.mark.parametrize("seed", [3, 19, 77])
def test_float32_pass_and_borderline_mask(seed):
    import jax.numpy as jnp

    s = _hybrid_scene(seed)
    jvis, jnear = _borderline(JG, s, jnp.asarray)
    tvis, tnear = _borderline(TG, s, torch.from_numpy)
    np.testing.assert_array_equal(tvis, jvis)
    assert tnear.sum() > 0     # the fix-up path runs on these scenes
    assert abs(int(tnear.sum()) - int(jnear.sum())) <= NEAR_SHARE * tnear.size
    assert (tnear != jnear).sum() <= NEAR_DIFF * tnear.size
    # the padded pairs are never flagged
    assert not tnear[s.num_images:].any()
    assert not tnear[:, s.num_points:].any()


@pytest.mark.parametrize("seed", [3, 19, 77])
def test_hybrid_equals_jax_float64_and_oracle(seed):
    s = _hybrid_scene(seed)
    got = TV.compute_scene_visibility_hybrid(s, device="cpu")
    exact = _numpy_visibility_oracle(s)
    np.testing.assert_array_equal(got, exact)
    np.testing.assert_array_equal(got, JV.compute_scene_visibility_hybrid(s))
    np.testing.assert_array_equal(
        got, JV.compute_scene_visibility(s, np.float64))


@pytest.mark.parametrize("chunk", [None, 4, 8])
def test_hybrid_chunked(chunk):
    # tests/test_stages.py:389 (14 images: chunks of 8 pad the image axis)
    s = make_scene(scene_id="hybc0000_00", seed=5, n_images=14,
                   n_background=2500, n_objects=2)
    got = TV.compute_scene_visibility_hybrid(s, image_chunk=chunk,
                                             device="cpu")
    np.testing.assert_array_equal(got, _numpy_visibility_oracle(s))
    np.testing.assert_array_equal(
        got, JV.compute_scene_visibility_hybrid(s, image_chunk=chunk))
    handles = TV._hybrid_dispatch(s, image_chunk=chunk, device="cpu")
    assert len(handles.chunks) == (1 if chunk is None else -(-16 // chunk))


def test_hybrid_chunk_plan():
    """Chunks hold half the hybrid pair budget: a scene past it splits into
    image chunks, a multiple of 8 each."""
    budget = TV._PAIR_BUDGET_HYBRID // 2
    assert budget * TV._HYBRID_BYTES_PER_PAIR * 2 <= 32e9
    s = make_scene(scene_id="hybp0000_00", seed=1, n_images=40,
                   n_background=1000, n_objects=1)
    n_pad = s.padded_points(np.float32)[0].shape[0]
    old = TV._PAIR_BUDGET_HYBRID
    try:
        TV._PAIR_BUDGET_HYBRID = 2 * 16 * n_pad
        handles = TV._hybrid_dispatch(s, device="cpu")
        assert handles.chunk == 16 and len(handles.chunks) == 3
        np.testing.assert_array_equal(TV._hybrid_finalize(s, handles),
                                      _numpy_visibility_oracle(s))
    finally:
        TV._PAIR_BUDGET_HYBRID = old


def _pipeline_scenes():
    # tests/test_stages.py:519
    return [make_scene(scene_id=f"pp{i:04d}_00", seed=140 + i, n_images=10,
                       n_background=2000, n_objects=2, n_invalid_poses=1)
            for i in range(3)]


def _assert_relations(got, want, dt):
    assert set(got) == set(want)
    for k in ("overlap", "distance", "yaw"):
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    limit = 2 * PITCH_ULP * np.spacing(np.dtype(dt).type(90.0))
    np.testing.assert_allclose(got["pitch"], want["pitch"], rtol=0,
                               atol=limit)


@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_pipelined_equals_sequential_and_jax(dt):
    scenes = _pipeline_scenes()
    got = list(TF.project_scenes_pipelined(scenes, dtype=dt, device="cpu"))
    want = list(JF.project_scenes_pipelined(scenes, dtype=dt))
    assert [s.scene_id for s, _, _ in got] == [s.scene_id for s in scenes]
    for (s, vis, rel), (_, jvis, jrel) in zip(got, want):
        vis_seq = TV.compute_scene_visibility_hybrid(s, device="cpu")
        np.testing.assert_array_equal(vis, vis_seq)
        np.testing.assert_array_equal(vis, jvis)
        rel_seq = TF.compute_scene_relations(s, vis=vis_seq, dtype=dt,
                                             device="cpu")
        assert set(rel) == set(rel_seq)
        for k, v in rel_seq.items():
            np.testing.assert_array_equal(rel[k], v, err_msg=k)
        _assert_relations(rel, jrel, dt)


def test_pipelined_without_relations_one_and_no_scene():
    scenes = _pipeline_scenes()
    got = list(TF.project_scenes_pipelined(scenes[:2], with_relations=False,
                                           device="cpu"))
    assert [(s.scene_id, r) for s, _, r in got] == [
        (s.scene_id, None) for s in scenes[:2]]
    for s, vis, _ in got:
        np.testing.assert_array_equal(
            vis, TV.compute_scene_visibility_hybrid(s, device="cpu"))
    one = list(TF.project_scenes_pipelined(scenes[:1], device="cpu"))
    assert len(one) == 1 and one[0][2] is not None
    assert list(TF.project_scenes_pipelined([], device="cpu")) == []
