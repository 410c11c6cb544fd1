"""OpenCV's uint8 `INTER_AREA` resize in numpy, without cv2.

`resize_area(img, (h, w))` gives the pixels of `cv2.resize(img, (w, h),
interpolation=cv2.INTER_AREA)` for a uint8 `[H, W]` or `[H, W, C]` image,
through the same three code paths as OpenCV's imgproc/resize.cpp:

- **both axes shrink by whole factors** (`is_area_fast`): a block mean.
  At 2 x 2 it rounds half up, `(sum + 2) >> 2`; at other factors it is the
  int sum times the float `1 / area`, rounded half to even.
- **both axes shrink, at least one by a fraction**: `computeResizeAreaTab`'s
  float weights (each source cell's covered share over the cell width),
  summed in float32 along x in table order, then along y, then rounded
  half to even (`saturate_cast<uchar>`).
- **an axis grows**: the generic separable path with area-mode
  coefficients in 11-bit fixed point (`INTER_RESIZE_COEF_BITS`): the
  horizontal pass is exact integer arithmetic, and the vertical pass is
  the SIMD kernel `VResizeLinearVec_32s8u`, which every pixel goes
  through: `((b0 * (s0 >> 4)) >> 16) + ((b1 * (s1 >> 4)) >> 16)`, rounded
  by `(x + 2) >> 2` and saturated.

`tests/test_torch_resize.py` holds it pixel-equal to cv2 5.0.0 over the
shapes `tile_image` produces and a sweep of random sizes. `area_path`
makes the choice of path, and `card_tables` hands it with its tables to
the card's tiling kernel (ops/csrc/tile_frames.cu).
"""

from __future__ import annotations

import math

import numpy as np

_DBL_EPSILON = np.finfo(np.float64).eps
_COEF_SCALE = 2048                     # 1 << INTER_RESIZE_COEF_BITS
BLOCK, AREA, GENERIC = 0, 1, 2         # the paths, numbered as the card's


def _area_table(ssize: int, dsize: int, scale: float):
    """computeResizeAreaTab as [dsize, k] source indices and float32
    weights; a destination with fewer than k entries is padded at its end
    with weight 0 (adding +0.0 to a float sum leaves it unchanged)."""
    rows = []
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx2 = min(math.floor(fsx2), ssize - 1)
        sx1 = min(math.ceil(fsx1), sx2)
        entry = []
        if sx1 - fsx1 > 1e-3:
            entry.append((sx1 - 1, (sx1 - fsx1) / cell))
        entry.extend((sx, 1.0 / cell) for sx in range(sx1, sx2))
        if fsx2 - sx2 > 1e-3:
            entry.append((sx2, min(min(fsx2 - sx2, 1.0), cell) / cell))
        rows.append(entry)
    k = max(len(e) for e in rows)
    idx = np.zeros((dsize, k), np.int64)
    wgt = np.zeros((dsize, k), np.float32)
    for d, entry in enumerate(rows):
        for j, (s, a) in enumerate(entry):
            idx[d, j] = s
            wgt[d, j] = np.float32(a)
    return idx, wgt


def _area(src: np.ndarray, hw, scale_y: float, scale_x: float) -> np.ndarray:
    h, w = src.shape[:2]
    yi, yw = _area_table(h, hw[0], scale_y)
    xi, xw = _area_table(w, hw[1], scale_x)
    s = src.astype(np.float32)
    buf = np.zeros((h, hw[1], s.shape[2]), np.float32)
    for j in range(xi.shape[1]):
        buf += s[:, xi[:, j]] * xw[:, j, None]
    out = np.zeros((hw[0], hw[1], s.shape[2]), np.float32)
    for j in range(yi.shape[1]):
        out += buf[yi[:, j]] * yw[:, j, None, None]
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def _area_fast(src: np.ndarray, hw, iy: int, ix: int) -> np.ndarray:
    dh, dw = hw
    blocks = src[:dh * iy, :dw * ix].astype(np.int32).reshape(
        dh, iy, dw, ix, src.shape[2])
    total = blocks.sum(axis=(1, 3), dtype=np.int32)
    if ix == 2 and iy == 2:
        return ((total + 2) >> 2).astype(np.uint8)
    scaled = total.astype(np.float32) * (np.float32(1) / np.float32(ix * iy))
    return np.clip(np.rint(scaled), 0, 255).astype(np.uint8)


def _generic_coefs(ssize: int, dsize: int):
    """Area-mode source index and 11-bit weights of each destination index
    (resize.cpp, the generic path's coefficient loop). At the last source
    index the weights are 2048 and 0, which is cv2's `S[sx] * ONE` past
    xmax."""
    inv = dsize / ssize
    scale = 1.0 / inv
    d = np.arange(dsize)
    s = np.floor(d * scale).astype(np.int64)
    f = ((d + 1) - (s + 1) * inv).astype(np.float32)
    f = np.where(f <= 0, np.float32(0), f - np.floor(f)).astype(np.float32)
    last = s >= ssize - 1
    s = np.where(last, ssize - 1, s)
    f = np.where(last, np.float32(0), f)
    a0 = np.rint((np.float32(1) - f) * np.float32(_COEF_SCALE))
    a1 = np.rint(f * np.float32(_COEF_SCALE))
    return s, a0.astype(np.int32), a1.astype(np.int32)


def _generic(src: np.ndarray, hw) -> np.ndarray:
    h, w, cn = src.shape
    sx, ax0, ax1 = _generic_coefs(w, hw[1])
    sy, by0, by1 = _generic_coefs(h, hw[0])
    s = src.astype(np.int32)
    rows = (s[:, sx] * ax0[:, None]
            + s[:, np.minimum(sx + 1, w - 1)] * ax1[:, None])
    r0 = rows[sy] >> 4
    r1 = rows[np.minimum(sy + 1, h - 1)] >> 4
    out = (((r0 * by0[:, None, None]) >> 16)
           + ((r1 * by1[:, None, None]) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def area_path(h: int, w: int, dh: int, dw: int):
    """Which of cv2's three paths resizes `h x w` to `dh x dw`, with what
    it takes: `(BLOCK, (iy, ix))`, `(AREA, (scale_y, scale_x))` or
    `(GENERIC, None)`. The same size is a 1 x 1 block mean: each pixel
    as it is."""
    scale_x, scale_y = 1.0 / (dw / w), 1.0 / (dh / h)
    if scale_x >= 1 and scale_y >= 1:
        ix, iy = round(scale_x), round(scale_y)
        if (abs(scale_x - ix) < _DBL_EPSILON
                and abs(scale_y - iy) < _DBL_EPSILON):
            return BLOCK, (iy, ix)
        return AREA, (scale_y, scale_x)
    return GENERIC, None


def card_tables(h: int, w: int, dh: int, dw: int):
    """The resize as the card's kernel (ops/csrc/tile_frames.cu) reads it:
    a header `[path, dh, dw, a, b]` and one int32 array, the y table then
    the x table (None for a block mean, whose header holds `iy, ix`).

    - `AREA`: `a, b` = ky, kx; each axis `[d, k]` source indices then
      `[d, k]` float32 weight bits (`_area_table`).
    - `GENERIC`: `a = b = 0`; each axis `[d, 4]`: the two source indices
      and their 11-bit weights (`_generic_coefs`)."""
    path, arg = area_path(h, w, dh, dw)
    if path == BLOCK:
        return [path, dh, dw, *arg], None
    if path == AREA:
        (yi, yw), (xi, xw) = (_area_table(h, dh, arg[0]),
                              _area_table(w, dw, arg[1]))
        tabs = [yi.astype(np.int32), yw.view(np.int32),
                xi.astype(np.int32), xw.view(np.int32)]
        return ([path, dh, dw, yi.shape[1], xi.shape[1]],
                np.concatenate([t.ravel() for t in tabs]))
    tabs = []
    for ssize, dsize in ((h, dh), (w, dw)):
        s, a0, a1 = _generic_coefs(ssize, dsize)
        tabs.append(np.stack([s, np.minimum(s + 1, ssize - 1), a0, a1],
                             axis=1).astype(np.int32).ravel())
    return [path, dh, dw, 0, 0], np.concatenate(tabs)


def resize_area(img: np.ndarray, hw: tuple[int, int]) -> np.ndarray:
    """`cv2.resize(img, (hw[1], hw[0]), interpolation=cv2.INTER_AREA)` for
    a uint8 `[H, W]` or `[H, W, C]` image."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"resize_area takes uint8 [H, W] or [H, W, C], got "
                         f"{img.dtype}{list(img.shape)}")
    dh, dw = int(hw[0]), int(hw[1])
    h, w = img.shape[:2]
    if dh <= 0 or dw <= 0 or h == 0 or w == 0:
        raise ValueError(f"resize_area: {h} x {w} -> {dh} x {dw}")
    if (h, w) == (dh, dw):
        return img.copy()
    src = img if img.ndim == 3 else img[..., None]
    path, arg = area_path(h, w, dh, dw)
    if path == BLOCK:
        out = _area_fast(src, (dh, dw), *arg)
    elif path == AREA:
        out = _area(src, (dh, dw), *arg)
    else:
        out = _generic(src, (dh, dw))
    return out if img.ndim == 3 else out[..., 0]
