"""The port's geometry (multi_spatialmllm_tpu_torch/core/geometry.py) held
against the JAX functions on the CPU in float64 (x64 on, tests/conftest.py),
on the JAX stage tests' own scenes: visibility labels bit for bit in f64
and f32, the relation matrices bit for bit (pitch within its stated ulp
limit), the 4-term products against the JAX functions' own rounding.

Where the float path cannot be bit-equal, the test says why and holds it
to a stated limit: XLA's CPU code evaluates `se3_inverse`'s 3-term
products as FMA chains, where the port uses separate multiplies and adds
(so the card rounds as the CPU); and XLA computes pitch's `z / |z|` with
an `rsqrt` and an `atan2` that are not the correctly rounded ones."""

import jax
import numpy as np
import pytest
import torch

from multi_spatialmllm_tpu.core import geometry as JG
from multi_spatialmllm_tpu.core.synthetic import make_scene
from multi_spatialmllm_tpu_torch.core import geometry as TG

# pitch: each image's value within PITCH_ULP of its own ulp (largest seen
# over 3,800 poses of 40 synthetic scenes: 4), so a pair's difference
# within 2 * PITCH_ULP ulp of 90 degrees
PITCH_ULP = 4
# se3_inverse and what is built on it, against XLA's FMA chains (largest
# relative difference seen on the test scenes: 1.3e-15 for the inverse,
# 8.3e-12 for pixel coordinates; 2.7e-15 m absolute for camera depths)
INV_RTOL = 1e-14
PROJ_RTOL = 1e-10
DEPTH_ATOL = 1e-13


def _t(a):
    return torch.from_numpy(np.array(a))


SCENES = {
    # tests/test_stages.py's scene (its make_scene default poisons a pose)
    "stages": dict(seed=2, n_images=10, n_background=3000, n_objects=3),
    # the odd shape of test_stages.py's batched-visibility test
    "odd": dict(seed=60, n_images=6, n_background=1500, n_objects=2),
    "chunked": dict(seed=77, n_images=14, n_background=3000, n_objects=2),
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def scene(request):
    return make_scene(scene_id=f"geo_{request.param}_00",
                      **SCENES[request.param])


def _jax_visibility(scene, dt):
    pts, pv = scene.padded_points(dt)
    ext, depth, iv = scene.padded_images(dt)
    K = scene.intrinsic.astype(dt)
    fn = jax.jit(lambda p, k, e, d, i, v: JG.visibility_matrix(
        p, k, e, d, scene.image_hw, i, v))
    return np.asarray(fn(pts, K, ext, depth, iv, pv))


@pytest.mark.parametrize("dt", [np.float64, np.float32])
def test_visibility_matrix_bits_equal(scene, dt):
    pts, pv = scene.padded_points(dt)
    ext, depth, iv = scene.padded_images(dt)
    got = TG.visibility_matrix(
        _t(pts), _t(scene.intrinsic.astype(dt)), _t(ext),
        _t(depth.astype(np.int32)), scene.image_hw, _t(iv), _t(pv)).numpy()
    want = _jax_visibility(scene, dt)
    assert want.any() and not want[~iv].any()
    np.testing.assert_array_equal(got, want)


def test_batched_visibility_matrix_equals_single(scene):
    pts, pv = scene.padded_points(np.float64)
    ext, depth, iv = scene.padded_images(np.float64)
    args = [_t(pts), _t(scene.intrinsic), _t(ext),
            _t(depth.astype(np.int32))]
    single = TG.visibility_matrix(*args, scene.image_hw, _t(iv), _t(pv))
    two = [torch.stack([a, a]) for a in args]
    batched = TG.visibility_matrix(*two, scene.image_hw,
                                   torch.stack([_t(iv)] * 2),
                                   torch.stack([_t(pv)] * 2))
    assert torch.equal(batched[0], single) and torch.equal(batched[1], single)


def test_projection_and_occlusion_pieces(scene):
    pts, pv = scene.padded_points(np.float64)
    ext, depth, iv = scene.padded_images(np.float64)
    K = scene.intrinsic
    jxy, jd = jax.jit(JG.project_points)(pts[None], K[None], ext)
    txy, td = TG.project_points(_t(pts)[None], _t(K)[None], _t(ext))
    np.testing.assert_allclose(txy.numpy()[iv], np.asarray(jxy)[iv],
                               rtol=PROJ_RTOL, atol=1e-9)
    np.testing.assert_allclose(td.numpy()[iv], np.asarray(jd)[iv],
                               rtol=0, atol=DEPTH_ATOL)
    # the masks from the JAX coordinates: bit-equal
    jxy, jd = np.asarray(jxy), np.asarray(jd)
    want = np.asarray(JG.in_bounds_mask(jxy, scene.image_hw)
                      & JG.depth_occlusion_mask(jxy, jd, depth,
                                                scene.image_hw))
    got = TG.point_visibility_mask(_t(jxy), _t(jd),
                                   _t(depth.astype(np.int32)),
                                   scene.image_hw).numpy()
    np.testing.assert_array_equal(got, want)


def test_depth_index_rounds_half_to_even_at_exact_boundaries():
    """x * (wd / w) lands on exact .5 values: round half to even, as
    jnp.round, and the scale multiplies after (wd / w) as in the JAX
    code."""
    depth_map = np.arange(4 * 8, dtype=np.int32).reshape(4, 8) + 1000
    xy = np.array([[[0.5, 0.5], [1.0, 1.0], [3.0, 3.0], [5.0, 2.0],
                    [15.0, 7.0], [-3.0, 9.0]]])
    d = np.full((1, 6), 0.5)
    want = np.asarray(JG.depth_occlusion_mask(xy, d, depth_map, (8, 16)))
    got = TG.depth_occlusion_mask(_t(xy), _t(d), _t(depth_map),
                                  (8, 16)).numpy()
    np.testing.assert_array_equal(got, want)


def _inputs(scene):
    ext, _, iv = scene.padded_images(np.float64)
    return ext[iv]


def test_se3_inverse_and_relative_pose(scene):
    ext = _inputs(scene)
    other = ext[::-1].copy()
    np.testing.assert_allclose(TG.se3_inverse(_t(ext)).numpy(),
                               np.asarray(JG.se3_inverse(ext)),
                               rtol=INV_RTOL, atol=1e-15)
    np.testing.assert_allclose(TG.rigid_inverse(_t(ext)).numpy(),
                               np.asarray(JG.rigid_inverse(ext)),
                               rtol=INV_RTOL, atol=1e-15)
    np.testing.assert_allclose(
        TG.relative_pose(_t(ext), _t(other)).numpy(),
        np.asarray(JG.relative_pose(ext, other)), rtol=INV_RTOL, atol=1e-15)
    np.testing.assert_allclose(
        TG.displacement_in_frame1(_t(ext), _t(other)).numpy(),
        np.asarray(JG.displacement_in_frame1(ext, other)),
        rtol=INV_RTOL, atol=1e-15)
    # the 4x4 products are bit-equal: XLA's dot sums them in index order
    np.testing.assert_array_equal(
        TG.compose(_t(ext), _t(other), _t(ext)).numpy(),
        np.asarray(jax.jit(JG.compose)(ext, other, ext)))


def test_unproject_pixels_bits_equal(scene):
    px = np.stack(np.meshgrid(np.arange(0, scene.image_hw[1], 7),
                              np.arange(0, scene.image_hw[0], 5)),
                  -1).reshape(-1, 2)
    dm = scene.depth_maps[0].astype(np.int32)
    E = scene.extrinsics[scene.valid_image_mask()][0]
    jw, jv = JG.unproject_pixels(px, dm, scene.intrinsic, E,
                                 scene.axis_align, mask_hw=scene.image_hw)
    tw, tv = TG.unproject_pixels(_t(px), _t(dm), _t(scene.intrinsic), _t(E),
                                 _t(scene.axis_align),
                                 mask_hw=scene.image_hw)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tw.numpy()[tv.numpy()],
                                  np.asarray(jw)[np.asarray(jv)])


def _ulp(a, dt):
    return np.spacing(np.abs(a).astype(dt))


@pytest.mark.parametrize("dt", [np.float64, np.float32])
def test_yaw_bits_equal_pitch_within_its_ulp_limit(dt):
    ext = np.concatenate([
        _inputs(make_scene(scene_id=f"yp{i}_00", seed=100 + i, n_images=96,
                           n_background=10, n_objects=1))
        for i in range(4)]).astype(dt)
    jy, jp = jax.jit(JG.yaw_pitch_deg)(ext)
    ty, tp = TG.yaw_pitch_deg(_t(ext))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    gap = np.abs(tp.numpy() - np.asarray(jp)) / _ulp(np.asarray(jp), dt)
    assert gap.max() <= PITCH_ULP, gap.max()


@pytest.mark.parametrize("dt", [np.float64, np.float32])
def test_pairwise_frame_relations(scene, dt):
    vis = _jax_visibility(scene, dt)
    ext, _, iv = scene.padded_images(dt)
    want = {k: np.asarray(v) for k, v in jax.jit(
        JG.pairwise_frame_relations)(vis, ext, iv).items()}
    got = {k: v.numpy() for k, v in TG.pairwise_frame_relations(
        _t(vis), _t(ext), _t(iv)).items()}
    for k in ("overlap", "distance", "yaw"):
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    limit = 2 * PITCH_ULP * np.spacing(dt(90.0))
    np.testing.assert_allclose(got["pitch"], want["pitch"], rtol=0,
                               atol=limit)


def test_overlap_nan_for_an_empty_union_and_zero_for_invalid():
    vis = np.zeros((4, 40), dtype=bool)
    vis[0, :10] = vis[1, 5:20] = True          # image 2 and 3 see nothing
    iv = np.array([True, True, True, False])
    want = np.asarray(JG.overlap_percentage_matrix(vis, iv))
    got = TG.overlap_percentage_matrix(_t(vis), _t(iv)).numpy()
    assert np.isnan(want[2, 2]) and want[3, 0] == 0.0
    np.testing.assert_array_equal(got, want)


def test_overlap_refuses_counts_past_f32_exactness():
    vis = torch.empty(2, 1 << 24, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="2\\^24"):
        TG.overlap_percentage_matrix(vis)


def test_overlap_matmul_restores_tf32_setting():
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        TG.overlap_percentage_matrix(torch.ones(3, 16, dtype=torch.bool))
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def test_wrap_and_centers():
    yaw = np.array([-359.0, -180.5, -180.0, 0.0, 180.0, 180.5, 359.0])
    np.testing.assert_array_equal(TG.wrap_yaw_deg(_t(yaw)).numpy(),
                                  np.asarray(JG.wrap_yaw_deg(yaw)))
    E = np.random.default_rng(0).normal(size=(3, 4, 4))
    np.testing.assert_array_equal(TG.camera_center(_t(E)).numpy(),
                                  np.asarray(JG.camera_center(E)))
    p = np.random.default_rng(1).normal(size=(5, 3))
    np.testing.assert_array_equal(TG.to_homogeneous(_t(p)).numpy(),
                                  np.asarray(JG.to_homogeneous(p)))
