"""The port's box, IoU, AABB, outlier and sharpness ops
(multi_spatialmllm_tpu_torch/core/boxes.py) held against the JAX package's
(core/boxes.py) on the CPU, on the inputs of tests/test_boxes.py's eight
cases: equal results (float64 arithmetic in the same order; masks equal),
and the hand values and oracles those cases check."""

import jax.numpy as jnp
import numpy as np
import torch

from multi_spatialmllm_tpu.core import boxes as JB
from multi_spatialmllm_tpu_torch.core import boxes as TB


def _both(fn, *args):
    """(port, JAX) results of `fn` on numpy (or Python) arguments."""
    def conv(a, to):
        return to(a) if isinstance(a, np.ndarray) else a

    got = getattr(TB, fn)(*(conv(a, torch.from_numpy) for a in args))
    want = getattr(JB, fn)(*(conv(a, jnp.asarray) for a in args))
    return np.asarray(got), np.asarray(want)


def test_box_corners():
    boxes = np.asarray([[0.0, 0.0, 0.0, 2.0, 2.0, 2.0, 9.0],
                        [1.5, -2.0, 0.25, 0.5, 3.0, 1.0, 7.0]])
    got, want = _both("box_corners", boxes)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got[0, 0], [-1, -1, -1])
    np.testing.assert_allclose(got[0, 7], [1, 1, 1])


def test_iou_2d():
    m1 = np.zeros((4, 4), bool)
    m1[:2] = True
    m2 = np.zeros((4, 4), bool)
    m2[1:3] = True
    got, want = _both("iou_2d", m1, m2)
    np.testing.assert_allclose(got, want, rtol=1e-7)
    np.testing.assert_allclose(got, 4 / 12, rtol=1e-7)
    empty = np.zeros((2, 2), bool)
    assert float(_both("iou_2d", empty, empty)[0]) == 0.0


def test_iou_3d():
    b1 = np.asarray([0.0, 0.0, 0.0, 2.0, 2.0, 2.0])
    for b2, value in ((np.asarray([1.0, 0.0, 0.0, 2.0, 2.0, 2.0]), 4 / 12),
                      (np.asarray([10.0, 0.0, 0.0, 2.0, 2.0, 2.0]), 0.0),
                      (b1, 1.0)):
        got, want = _both("iou_3d", b1, b2)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(got, value)


def test_aabb_with_padding(rng):
    pts = rng.normal(size=(50, 3))
    pad = np.concatenate([pts, np.full((14, 3), 1e9)])
    valid = np.concatenate([np.ones(50, bool), np.zeros(14, bool)])
    got, want = _both("aabb", pad, valid)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_both("aabb", pts)[0],
                                  _both("aabb", pts)[1])
    lo, hi = pts.min(0), pts.max(0)
    np.testing.assert_allclose(got[:3], (lo + hi) / 2, atol=1e-12)
    np.testing.assert_allclose(got[3:], hi - lo, atol=1e-12)


def test_coverage_extent(rng):
    pts = rng.normal(size=(32, 3))
    valid = rng.random(32) < 0.5
    got, want = _both("coverage_extent", pts, valid, 1)
    np.testing.assert_array_equal(got, want)
    ys = pts[valid, 1]
    np.testing.assert_allclose(got, ys.max() - ys.min(), atol=1e-12)
    none, _ = _both("coverage_extent", pts, np.zeros(32, bool), 0)
    assert float(none) == -np.inf


def test_truncated_outlier_mask(rng):
    pts = rng.normal(size=(100, 3))
    for t in ((0.1, 0.05, 0.0), (0.0, 0.0, 0.0), (0.5, 0.1, 0.1),
              (0.2, 0.3, 0.01)):
        got, want = _both("truncated_outlier_mask", pts, *t)
        np.testing.assert_array_equal(got, want)
    got, _ = _both("truncated_outlier_mask", pts, 0.1, 0.05, 0.0)
    keep = np.ones(100, bool)
    for axis, t in ((0, 0.1), (1, 0.05)):
        cut = int(t * 100)
        ok = np.zeros(100, bool)
        ok[np.argsort(pts[:, axis])[cut:-cut]] = True
        keep &= ok
    np.testing.assert_array_equal(got, keep)


def test_statistical_outlier_mask(rng):
    cluster = rng.normal(size=(64, 3)) * 0.1
    pts = np.concatenate([cluster, np.array([[50.0, 50.0, 50.0]])])
    got, want = _both("statistical_outlier_mask", pts, 10, 1.0)
    np.testing.assert_array_equal(got, want)
    assert not got[-1]
    assert got[:-1].mean() > 0.8


def test_laplacian_sharpness(rng):
    import cv2

    img = (rng.random((32, 40)) * 255).astype(np.uint8)
    got, want = _both("laplacian_sharpness", img.astype(np.float64))
    np.testing.assert_allclose(got, want, rtol=1e-12)
    np.testing.assert_allclose(got, cv2.Laplacian(img, cv2.CV_64F).var(),
                               rtol=1e-10)
    got32, want32 = _both("laplacian_sharpness", img.astype(np.float32))
    assert got32.dtype == np.float32
    np.testing.assert_allclose(got32, want32, rtol=1e-5)
