"""Seeded camera frames at ScanNet's colour size, written as JPEG files.

The frames are the benchmark's inputs: the program reads the files
through its own image reader (its native JPEG decoder), and the reference
reads the same bytes through Pillow (`read_jpeg` below). A frame is smooth
colour fields plus texture and noise, so tiling and resizing see
natural-looking content.
"""

from __future__ import annotations

import os

import numpy as np

SCANNET_HW = (968, 1296)        # ScanNet's colour frames, height x width
JPEG_QUALITY = 95               # cv2.imwrite's default JPEG quality


def make_frame(rng: np.random.Generator, hw=SCANNET_HW) -> np.ndarray:
    """RGB uint8 `[H, W, 3]`: a few low-frequency waves a channel, edges
    and noise."""
    h, w = hw
    y = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None]
    x = np.linspace(0.0, 1.0, w, dtype=np.float32)[None, :]
    img = np.empty((h, w, 3), np.float32)
    for c in range(3):
        acc = np.full((h, w), 128.0, np.float32)
        for _ in range(4):
            fy, fx, ph = rng.uniform(0.5, 6.0), rng.uniform(0.5, 6.0), \
                rng.uniform(0, 2 * np.pi)
            acc += rng.uniform(10, 40) * np.sin(2 * np.pi * (fy * y + fx * x)
                                                + ph)
        img[..., c] = acc
    # a few flat boxes (furniture-like edges)
    for _ in range(6):
        y0, x0 = rng.integers(0, h - 64), rng.integers(0, w - 64)
        y1, x1 = y0 + rng.integers(32, h // 3), x0 + rng.integers(32, w // 3)
        img[y0:y1, x0:x1] = rng.uniform(20, 235, size=3)
    img += rng.normal(0.0, 6.0, size=img.shape).astype(np.float32)
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def write_jpeg(path: str, img: np.ndarray) -> None:
    """RGB JPEG at `JPEG_QUALITY`, written by Pillow (libjpeg-turbo)."""
    from PIL import Image

    Image.fromarray(img).save(path, format="JPEG", quality=JPEG_QUALITY)


def read_jpeg(path: str) -> np.ndarray:
    """RGB uint8 `[H, W, 3]` of a JPEG file, decoded by Pillow."""
    from PIL import Image

    with Image.open(path) as im:
        if im.format != "JPEG":
            raise ValueError(f"{path}: not a JPEG")
        return np.asarray(im.convert("RGB")).copy()


def write_pool(root: str, seed: int, n: int) -> list[str]:
    """`n` frames from `seed` under `root` -> their file names."""
    rng = np.random.default_rng(seed)
    names = []
    for i in range(n):
        name = f"frame_{i:03d}.jpg"
        write_jpeg(os.path.join(root, name), make_frame(rng))
        names.append(name)
    return names
