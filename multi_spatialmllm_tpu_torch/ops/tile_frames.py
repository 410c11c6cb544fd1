"""A frame's InternVL tiles on the card (`csrc/tile_frames.cu`).

`tile_frame` takes the RGB uint8 `[H, W, 3]` numpy frame that
`models/preprocess.tile_image` takes and gives the same float32
`[n, tile, tile, 3]` numpy array, bit for bit: the frame goes up through
pinned memory, one launch of `tile_frame` resizes it (OpenCV's INTER_AREA,
the grid and the thumbnail), crops the tiles and normalises them, and the
tiles come back through pinned memory. A fixed `resize_hw` other than the
frame's size takes one launch of `resize_frame` before it.

Each thread works on its own stream of the device (made at its first
call), so tiling in a feed thread never queues behind a train step on the
default stream, and waits on that stream alone. The resizes' index and
weight tables (`models/resize.card_tables`) are cached on the device by
source and target size.

`tile_frame` needs a CUDA device; `models/preprocess.tile_image` takes the
numpy path for a model on the CPU and where there is no card. Nothing here
falls back.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import numpy as np
import torch

from ..models.resize import card_tables
from ._build import CudaKernel, ptr

# a resize's header [path, dh, dw, a, b] (host memory, read at the launch)
_Header = ctypes.c_int * 5
_HEADER = ctypes.POINTER(ctypes.c_int)
TILE_FRAME = CudaKernel("tile_frame", [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int,         # src, h, w
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int,         # out, tile, cols
    ctypes.c_int, ctypes.c_int,                          # n_grid, n_tiles
    _HEADER, ctypes.c_void_p,                            # grid header, table
    _HEADER, ctypes.c_void_p,                            # thumbnail's
    ctypes.POINTER(ctypes.c_float),                      # mean[3], std[3]
], source="tile_frames")
RESIZE_FRAME = CudaKernel("resize_frame", [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int,         # src, h, w
    ctypes.c_void_p, _HEADER, ctypes.c_void_p,           # dst, header, table
], source="tile_frames")


def build() -> None:
    """Build and load the library now (its lazy build takes no lock: call
    this before threads tile at once)."""
    TILE_FRAME.build()
    RESIZE_FRAME.build()


@functools.lru_cache(maxsize=256)
def _resize(device: int, h: int, w: int, dh: int, dw: int):
    """(header, device table or None) of the resize h x w -> dh x dw; the
    table's copy has finished when this returns, so any stream may read
    it."""
    header, table = card_tables(h, w, dh, dw)
    if table is not None:
        table = torch.from_numpy(table).to(torch.device("cuda", device))
        torch.cuda.current_stream(device).synchronize()
    return _Header(*header), table


class _Staging:
    """One thread's stream on one device and its pinned buffers (grown to
    the largest frame and tiles it has moved; reused once the stream has
    been waited on)."""

    def __init__(self, device: int):
        self.stream = torch.cuda.Stream(device)
        self.buffers: dict[str, torch.Tensor] = {}

    def pinned(self, key: str, nbytes: int) -> torch.Tensor:
        buf = self.buffers.get(key)
        if buf is None or buf.numel() < nbytes:
            buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
            self.buffers[key] = buf
        return buf[:nbytes]


_local = threading.local()


def _staging(device: int) -> _Staging:
    by_device = getattr(_local, "by_device", None)
    if by_device is None:
        by_device = _local.by_device = {}
    if device not in by_device:
        by_device[device] = _Staging(device)
    return by_device[device]


def tile_on_device(src: torch.Tensor, hw: tuple[int, int], rows: int,
                   cols: int, tile: int, thumbnail: bool, mean_std
                   ) -> torch.Tensor:
    """The tiles of a uint8 `[h, w, 3]` frame on the card, as a float32
    `[n, tile, tile, 3]` tensor on its device, launched on the current
    stream: a `rows x cols` grid and, if `thumbnail`, the thumbnail, after
    a resize to `hw` where the frame has another size. `mean_std` is a
    `ctypes.c_float * 6` of the normalisation's mean and std."""
    h, w = src.shape[:2]
    device = src.device.index
    if (h, w) != tuple(hw):
        mid = torch.empty(*hw, 3, dtype=torch.uint8, device=src.device)
        header, table = _resize(device, h, w, *hw)
        RESIZE_FRAME(ptr(src), h, w, ptr(mid), header, ptr(table))
        src, (h, w) = mid, hw
    n_grid = rows * cols
    n = n_grid + int(thumbnail)
    grid_header, grid_table = _resize(device, h, w, rows * tile, cols * tile)
    thumb_header, thumb_table = (_resize(device, h, w, tile, tile)
                                 if thumbnail else (None, None))
    out = torch.empty(n, tile, tile, 3, dtype=torch.float32,
                      device=src.device)
    TILE_FRAME(ptr(src), h, w, ptr(out), tile, cols, n_grid, n,
               grid_header, ptr(grid_table), thumb_header, ptr(thumb_table),
               mean_std)
    return out


def tile_frame(image: np.ndarray, hw: tuple[int, int], rows: int, cols: int,
               tile: int, thumbnail: bool, mean: np.ndarray, std: np.ndarray,
               device: torch.device | None = None) -> np.ndarray:
    """`tile_on_device` for a numpy frame on the CUDA `device` (None, or
    one without an index: the current one), on this thread's stream, back
    as a new C-contiguous float32 numpy array."""
    image = np.ascontiguousarray(image)
    if (image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3
            or not image.size):
        raise ValueError(f"tile_frame takes a uint8 [H, W, 3] frame, got "
                         f"{image.dtype}{list(image.shape)}")
    h, w = image.shape[:2]
    index = device.index if device is not None else None
    if index is None:
        index = torch.cuda.current_device()
    staging = _staging(index)
    n = rows * cols + int(thumbnail)
    with torch.cuda.device(index), torch.cuda.stream(staging.stream):
        up = staging.pinned("frame", image.nbytes)
        up.numpy()[:] = image.reshape(-1)
        src = up.to(torch.device("cuda", index), non_blocking=True)
        tiles = tile_on_device(
            src.view(h, w, 3), hw, rows, cols, tile, thumbnail,
            (ctypes.c_float * 6)(*mean.tolist(), *std.tolist()))
        down = staging.pinned("tiles", tiles.numel() * 4).view(torch.float32)
        down.copy_(tiles.view(-1), non_blocking=True)
        staging.stream.synchronize()
    return down.numpy().reshape(n, tile, tile, 3).copy()
