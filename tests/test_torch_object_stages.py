"""The port's object-visibility (M3) and coverage (M4) stages held against
the JAX stages on the CPU: the `V @ onehot` counts and the per-segment
min/max/count intervals are bit-equal with equal dtypes (float32 counts;
float64 extrema with +-inf for empty segments; int32 interval counts), on
point counts that are not a multiple of 8, with segment 0, an object no
image sees, an object with no points, and visibility from f64 and f32;
the pickles and the warning file that `build_object_visibility` and
`build_object_coverage` write are byte-equal. Tolerance: exact
throughout."""

import numpy as np
import pytest

from multi_spatialmllm_tpu.core.synthetic import make_scene
from multi_spatialmllm_tpu.stages import coverage as JC
from multi_spatialmllm_tpu.stages import object_visibility as JO
from multi_spatialmllm_tpu.stages import visibility as JV
from multi_spatialmllm_tpu_torch.stages import coverage as TC
from multi_spatialmllm_tpu_torch.stages import object_visibility as TO


def _hidden_object_scene():
    """A scene whose last object sits outside every camera's view: its
    segment is empty in every image (+-inf extrema, zero counts), while
    its points still count toward the object."""
    s = make_scene(scene_id="hide0000_00", seed=9, n_images=9,
                   n_background=2001, n_objects=3)
    mask = s.object_point_mask(s.num_objects - 1)
    s.points_unaligned[mask, :3] += 1000.0
    s.points_aligned[mask, :3] += 1000.0
    return s


def _pointless_object_scene():
    """A scene whose first object has lost its points to segment 0: both
    stages skip it, object visibility with a warning."""
    s = make_scene(scene_id="none0000_00", seed=5, n_images=8,
                   n_background=1500, n_objects=3)
    s.instance_ids[s.object_point_mask(0)] = 0
    return s


SCENES = {
    # N = 2001 + 3 * 300: not a multiple of 8
    "odd": lambda: make_scene(scene_id="odd0000_00", seed=3, n_images=10,
                              n_background=2001, n_objects=3),
    "hidden": _hidden_object_scene,
    "pointless": _pointless_object_scene,
    "demo": lambda: make_scene(scene_id="demo0000_00", seed=0, n_images=12,
                               n_background=4000),
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def case(request):
    scene = SCENES[request.param]()
    vis = {dt: JV.compute_scene_visibility(scene, dt)
           for dt in (np.float64, np.float32)}
    return request.param, scene, vis


@pytest.mark.parametrize("dt", [np.float64, np.float32])
def test_object_counts_bit_equal(case, dt):
    name, scene, vis = case
    want = np.asarray(JO.object_image_counts(scene, vis[dt]))
    got = TO.object_image_counts(scene, vis[dt], device="cpu")
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == (scene.num_images, scene.num_objects)
    np.testing.assert_array_equal(got, want)
    if name == "hidden":
        assert not got[:, -1].any()


@pytest.mark.parametrize("dt", [np.float64, np.float32])
def test_coverage_intervals_bit_equal(case, dt):
    name, scene, vis = case
    want = [np.asarray(a) for a in
            JC.object_coverage_intervals(scene, vis[dt])]
    got = TC.object_coverage_intervals(scene, vis[dt], device="cpu")
    o = scene.num_objects + 1
    shapes = [(scene.num_images, 3, o), (scene.num_images, 3, o),
              (scene.num_images, o)]
    for g, w, dtype, shape in zip(got, want,
                                  (np.float64, np.float64, np.int32),
                                  shapes):
        assert g.dtype == w.dtype == dtype and g.shape == w.shape == shape
        np.testing.assert_array_equal(g, w)
    mins, maxs, cnt = got
    assert cnt[:, 0].any()              # segment 0 (unannotated) is seen
    empty = cnt == 0
    assert empty.any()
    assert np.all(mins.transpose(0, 2, 1)[empty] == np.inf)
    assert np.all(maxs.transpose(0, 2, 1)[empty] == -np.inf)
    if name == "hidden":
        assert empty[:, -1].all()


def test_object_ids_outside_the_segments_are_dropped():
    """An instance id past the last segment counts nowhere, as
    jax.nn.one_hot and jax.ops.segment_min drop it."""
    scene = make_scene(scene_id="ids0000_00", seed=4, n_images=8,
                       n_background=1000, n_objects=2)
    vis = JV.compute_scene_visibility(scene)
    scene.instance_ids[:50] = scene.num_objects + 5
    np.testing.assert_array_equal(
        TO.object_image_counts(scene, vis, device="cpu"),
        np.asarray(JO.object_image_counts(scene, vis)))
    for g, w in zip(TC.object_coverage_intervals(scene, vis, device="cpu"),
                    JC.object_coverage_intervals(scene, vis)):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_counts_refuse_inexact_widths():
    import torch

    with pytest.raises(ValueError, match="2\\^24"):
        TO._count_kernel(torch.zeros((1, 1), dtype=torch.uint8),
                         torch.zeros(1, dtype=torch.int32), 1 << 24, 2)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    base = tmp_path_factory.mktemp("objstages")
    scenes = [SCENES[k]() for k in sorted(SCENES)]
    vis = {s.scene_id: JV.compute_scene_visibility(s) for s in scenes}
    out = {}
    for tag, O, C, kw in (("jax", JO, JC, {}),
                          ("port", TO, TC, {"device": "cpu"})):
        d = base / tag
        d.mkdir()
        ov = O.build_object_visibility(
            scenes, output_pkl=str(d / "object_visibility.pkl"),
            warning_path=str(d / "object_visibility_warning.txt"),
            visibility=vis, **kw)
        C.build_object_coverage(scenes, ov, output_dir=str(d),
                                visibility=vis, seed=3, **kw)
        out[tag] = d
    return out


@pytest.mark.parametrize("name", [
    "object_visibility.pkl", "object_visibility_warning.txt",
    "train_object_coverage_height.pkl", "train_object_coverage_length.pkl",
    "train_object_coverage_width.pkl"])
def test_stage_files_byte_equal(built, name):
    got = (built["port"] / name).read_bytes()
    assert got == (built["jax"] / name).read_bytes()
    assert got


def test_stages_compute_visibility_when_not_given():
    """Without a visibility map both stages compute it on `device`."""
    scene = SCENES["odd"]()
    ov_j = JO.build_object_visibility([scene])
    ov_t = TO.build_object_visibility([scene], device="cpu")
    assert ov_t == ov_j
    assert TC.build_object_coverage([scene], ov_t, device="cpu") == \
        JC.build_object_coverage([scene], ov_j)
