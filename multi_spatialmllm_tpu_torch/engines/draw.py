"""cv2's filled circle without cv2.

`circle(img, center, radius, color)` paints the pixels of
`cv2.circle(img, center, radius, color, -1)` (shift 0, LINE_8): OpenCV's
integer midpoint `Circle` in imgproc/src/drawing.cpp, which fills the
horizontal spans of the four octant pairs as the error term walks from
(radius, 0) to the diagonal, clipping each span at the image's edges as
that code does. Any radius and any centre, on or off the image.
"""

from __future__ import annotations

import numpy as np


def circle(img: np.ndarray, center: tuple[int, int], radius: int,
           color) -> np.ndarray:
    """Fill the circle in place on a [H, W] or [H, W, C] uint8 image and
    return the image."""
    height, width = img.shape[:2]
    cx, cy = int(center[0]), int(center[1])
    radius = int(radius)
    if radius < 0:
        raise ValueError(f"radius must be >= 0, got {radius}")
    color = np.asarray(color, np.uint8)[: img.shape[2] if img.ndim == 3
                                         else 1]
    if img.ndim == 2:
        color = color[0]
    inside = (radius <= cx < width - radius) and (radius <= cy < height - radius)

    def hline(y, x1, x2):
        img[y, x1: x2 + 1] = color

    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        y11, y12, y21, y22 = cy - dy, cy + dy, cy - dx, cy + dx
        x11, x12, x21, x22 = cx - dx, cx + dx, cx - dy, cx + dy
        if inside:
            hline(y11, x11, x12)
            hline(y12, x11, x12)
            hline(y21, x21, x22)
            hline(y22, x21, x22)
        elif x11 < width and x12 >= 0 and y21 < height and y22 >= 0:
            x11, x12 = max(x11, 0), min(x12, width - 1)
            if 0 <= y11 < height:
                hline(y11, x11, x12)
            if 0 <= y12 < height:
                hline(y12, x11, x12)
            if x21 < width and x22 >= 0:
                x21, x22 = max(x21, 0), min(x22, width - 1)
                if 0 <= y21 < height:
                    hline(y21, x21, x22)
                if 0 <= y22 < height:
                    hline(y22, x21, x22)
        dy += 1
        err += plus
        plus += 2
        mask = -1 if err > 0 else 0      # (err <= 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2
    return img
