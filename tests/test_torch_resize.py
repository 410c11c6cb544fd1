"""The port's cv2-free INTER_AREA (models/resize.py) and its preprocessing
against cv2 and the JAX package: `resize_area` is pixel-equal to
`cv2.resize(..., interpolation=cv2.INTER_AREA)` on each of cv2's three
code paths (whole-factor block means, fractional area weights, the
generic fixed-point path where an axis grows), and `tile_image`'s tiles
equal the JAX package's (which resizes with cv2) for the frame sizes the
model meets. The bound is zero: every case is exact."""

import cv2
import numpy as np
import pytest

from multi_spatialmllm_tpu.models import preprocess as JP
from multi_spatialmllm_tpu_torch.models import preprocess as TPP
from multi_spatialmllm_tpu_torch.models.resize import resize_area

# (source h, w): a ScanNet frame, a 640 x 480 camera, a 1920 x 1440 one,
# and a source whose 3 x 2 grid and thumbnail are whole factors
SOURCES = [(968, 1296), (480, 640), (1440, 1920), (896, 1344)]
# the shapes tile_image asks for from those sources
TARGETS = [(896, 1344), (448, 448)]


def _frame(h, w, seed, cn=3):
    rng = np.random.default_rng(seed)
    shape = (h, w, cn) if cn > 1 else (h, w)
    if seed % 2:
        return rng.integers(0, 256, size=shape, dtype=np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (96 + 80 * np.sin(xx / 37.0 + seed) * np.cos(yy / 23.0))
    img = base[..., None] + rng.normal(0, 6, size=(h, w, cn))
    return np.clip(img, 0, 255).astype(np.uint8).reshape(shape)


def _cv2(img, hw):
    return cv2.resize(img, (hw[1], hw[0]), interpolation=cv2.INTER_AREA)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("target", TARGETS, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("source", SOURCES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_tile_shapes_equal_cv2(source, target, seed):
    img = _frame(*source, seed)
    np.testing.assert_array_equal(resize_area(img, target), _cv2(img, target))


@pytest.mark.parametrize("path", ["fast", "area", "generic"])
def test_each_code_path_equals_cv2(path):
    """A sweep of random sizes and channel counts on one of cv2's paths:
    whole factors (2 x 2 rounds half up, others half to even), fractional
    shrinks, and sizes where an axis grows."""
    rng = np.random.default_rng({"fast": 1, "area": 2, "generic": 3}[path])
    for t in range(120):
        cn = (1, 3, 4)[t % 3]
        if path == "fast":
            dh, dw = rng.integers(1, 40, 2)
            fy, fx = rng.integers(1, 5, 2)
            if fy == fx == 1:
                fx = 2
            h, w = dh * fy, dw * fx
        elif path == "area":
            dh, dw = rng.integers(1, 60, 2)
            h = dh + rng.integers(0, 3 * dh)
            w = dw + rng.integers(1, 3 * dw + 1)
        else:
            h, w = rng.integers(1, 70, 2)
            dh = h + rng.integers(1, 60)
            dw = rng.integers(1, 130)
        img = _frame(int(h), int(w), t, cn)
        want = _cv2(img, (int(dh), int(dw)))
        got = resize_area(img, (int(dh), int(dw)))
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want, err_msg=f"{(h, w, dh, dw)}")


def test_two_by_two_rounds_half_up_and_three_rounds_half_even():
    img = np.array([[0, 1, 1, 1], [1, 1, 0, 0]], np.uint8)   # sums 3 and 2
    np.testing.assert_array_equal(resize_area(img, (1, 2)), _cv2(img, (1, 2)))
    img = np.array([[1, 0, 0, 0, 1, 1]], np.uint8)          # 1/3, 2/3
    np.testing.assert_array_equal(resize_area(img, (1, 2)), _cv2(img, (1, 2)))


@pytest.mark.parametrize("resize_hw", [None, (968, 1296)],
                         ids=["serve", "reference"])
@pytest.mark.parametrize("source", SOURCES + [(300, 200), (448, 448)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_tile_image_equals_the_jax_package(source, resize_hw):
    """tile_image on an RGB frame: the same float32 tiles as the JAX
    package's, at the serve/train config (no fixed resize) and at the
    reference's 968 x 1296 training size."""
    img = _frame(*source, sum(source))
    cfg_t = TPP.PreprocessConfig(resize_hw=resize_hw)
    cfg_j = JP.PreprocessConfig(resize_hw=resize_hw)
    got = TPP.tile_image(img, cfg_t)
    want = JP.tile_image(img, cfg_j)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_resize_refuses_what_it_does_not_take():
    with pytest.raises(ValueError):
        resize_area(np.zeros((4, 4), np.float32), (2, 2))
    with pytest.raises(ValueError):
        resize_area(np.zeros((4, 4), np.uint8), (0, 2))
    img = _frame(5, 7, 1)
    out = resize_area(img, (5, 7))
    np.testing.assert_array_equal(out, img)
