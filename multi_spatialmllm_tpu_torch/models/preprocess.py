"""Image preprocessing for the multi-frame MLLM (the port's copy of
multi_spatialmllm_tpu/models/preprocess.py): InternVL-2 dynamic
aspect-ratio tiling into 448x448 tiles plus a thumbnail, normalised with
the ImageNet mean and std, on the host in numpy.

Resizing is OpenCV's INTER_AREA, as the JAX package's, done in numpy by
models/resize.py (pixel-equal to `cv2.resize`), so no OpenCV is needed; an
image already at the target size is returned as it is.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..utils.profiling import span
from .resize import resize_area

# ImageNet normalization used by InternViT-style encoders.
MEAN = np.asarray([0.485, 0.456, 0.406], dtype=np.float32)
STD = np.asarray([0.229, 0.224, 0.225], dtype=np.float32)


@dataclasses.dataclass(frozen=True)
class PreprocessConfig:
    tile_size: int = 448
    max_tiles: int = 6
    use_thumbnail: bool = True
    resize_hw: tuple[int, int] | None = (968, 1296)  # reference train size


def candidate_grids(max_tiles: int) -> list[tuple[int, int]]:
    """All (cols, rows) grids with 1 <= cols*rows <= max_tiles."""
    grids = []
    for n in range(1, max_tiles + 1):
        for cols in range(1, n + 1):
            if n % cols == 0:
                grids.append((cols, n // cols))
    return sorted(set(grids), key=lambda g: g[0] * g[1])


def select_grid(width: int, height: int, max_tiles: int,
                tile_size: int) -> tuple[int, int]:
    """Pick the tile grid whose aspect ratio best matches the image
    (InternVL's dynamic-preprocess closest-ratio rule; ties broken toward
    more area when the image is large enough)."""
    aspect = width / height
    best, best_diff = (1, 1), float("inf")
    area = width * height
    for cols, rows in candidate_grids(max_tiles):
        diff = abs(aspect - cols / rows)
        if diff < best_diff or (
            diff == best_diff
            and area > 0.5 * tile_size * tile_size * cols * rows
            and cols * rows > best[0] * best[1]
        ):
            best, best_diff = (cols, rows), diff
    return best


def _resize(image: np.ndarray, hw: tuple[int, int]) -> np.ndarray:
    if tuple(image.shape[:2]) == tuple(hw):
        return image
    return resize_area(image, hw)


def tile_image(image: np.ndarray, config: PreprocessConfig | None = None
               ) -> np.ndarray:
    """RGB uint8 `[H, W, 3]` -> normalized float32 tiles
    `[n_tiles, tile, tile, 3]` (grid tiles + optional thumbnail)."""
    with span("msm.image.tile"):
        return _tile_image(image, config or PreprocessConfig())


def _tile_image(image: np.ndarray, config: PreprocessConfig) -> np.ndarray:
    if config.resize_hw is not None:
        image = _resize(image, config.resize_hw)
    h, w = image.shape[:2]
    cols, rows = select_grid(w, h, config.max_tiles, config.tile_size)
    resized = _resize(image, (rows * config.tile_size,
                              cols * config.tile_size))
    tiles = []
    for r in range(rows):
        for c in range(cols):
            t = resized[r * config.tile_size:(r + 1) * config.tile_size,
                        c * config.tile_size:(c + 1) * config.tile_size]
            tiles.append(t)
    if config.use_thumbnail and len(tiles) > 1:
        tiles.append(_resize(image, (config.tile_size, config.tile_size)))
    stack = np.stack(tiles).astype(np.float32) / 255.0
    return (stack - MEAN) / STD
