"""ScanNet `.sens` RGB-D stream decoder (L1 #3).

Replacement for `spatial_engine/utils/scannet_utils/extract_posed_images.py`
with a streaming design: the reference materializes every frame's bytes via
per-byte `struct.unpack("c"*n)` calls even for skipped frames
(extract_posed_images.py:39-48); here headers are parsed with fixed-layout
reads and skipped frames are `seek`-ed over, so a frame_skip=5 extraction
touches ~1/5 of the file payload. zlib inflate of the kept depth frames can
be delegated to the native C++ helper (ingest/native) when built.

Stream layout (ScanNet sensor format v4):
  header: version u32, sensor-name (u64 len + bytes), 4x 4x4 f32 matrices
  (color/depth intrinsic+extrinsic), color/depth compression i32, color
  w/h u32, depth w/h u32, depth_shift f32, num_frames u64.
  frame: 4x4 f32 camera-to-world, color/depth timestamps u64, color/depth
  byte counts u64, color bytes (jpeg), depth bytes (zlib ushort).
"""

from __future__ import annotations

import dataclasses
import os
import struct
import zlib
from typing import Callable, Iterator

import numpy as np

from ..core.io import mkdir_or_exist

COMPRESSION_TYPE_COLOR = {-1: "unknown", 0: "raw", 1: "png", 2: "jpeg"}
COMPRESSION_TYPE_DEPTH = {-1: "unknown", 0: "raw_ushort", 1: "zlib_ushort",
                          2: "occi_ushort"}
SUPPORTED_VERSION = 4


@dataclasses.dataclass
class SensHeader:
    sensor_name: str
    intrinsic_color: np.ndarray
    extrinsic_color: np.ndarray
    intrinsic_depth: np.ndarray
    extrinsic_depth: np.ndarray
    color_compression: str
    depth_compression: str
    color_hw: tuple[int, int]
    depth_hw: tuple[int, int]
    depth_shift: float
    num_frames: int


@dataclasses.dataclass
class SensFrame:
    index: int
    camera_to_world: np.ndarray
    timestamp_color: int
    timestamp_depth: int
    color_jpeg: bytes
    depth_zlib: bytes

    def depth_mm(self, depth_hw: tuple[int, int],
                 inflate: Callable[[bytes], bytes] = zlib.decompress
                 ) -> np.ndarray:
        raw = inflate(self.depth_zlib)
        return np.frombuffer(raw, dtype=np.uint16).reshape(depth_hw)

    def color_bgr(self) -> np.ndarray:
        from .image import COLOR, imdecode   # cv2.IMREAD_COLOR, no cv2

        return imdecode(self.color_jpeg, COLOR)


def _read_mat4(f) -> np.ndarray:
    return np.frombuffer(f.read(64), dtype="<f4").reshape(4, 4).astype(
        np.float64)


def read_header(f) -> SensHeader:
    version = struct.unpack("<I", f.read(4))[0]
    if version != SUPPORTED_VERSION:
        raise ValueError(f"unsupported .sens version {version}")
    strlen = struct.unpack("<Q", f.read(8))[0]
    name = f.read(strlen).decode("ascii", "replace")
    ic, ec, idp, edp = (_read_mat4(f) for _ in range(4))
    color_c, depth_c = struct.unpack("<ii", f.read(8))
    cw, ch, dw, dh = struct.unpack("<IIII", f.read(16))
    depth_shift = struct.unpack("<f", f.read(4))[0]
    num_frames = struct.unpack("<Q", f.read(8))[0]
    return SensHeader(
        sensor_name=name, intrinsic_color=ic, extrinsic_color=ec,
        intrinsic_depth=idp, extrinsic_depth=edp,
        color_compression=COMPRESSION_TYPE_COLOR[color_c],
        depth_compression=COMPRESSION_TYPE_DEPTH[depth_c],
        color_hw=(ch, cw), depth_hw=(dh, dw),
        depth_shift=depth_shift, num_frames=num_frames,
    )


def iter_frames(path: str, frame_skip: int = 1) -> Iterator[SensFrame]:
    """Stream frames, seeking over skipped payloads."""
    with open(path, "rb") as f:
        header = read_header(f)
        for i in range(header.num_frames):
            keep = i % frame_skip == 0
            pose_bytes = f.read(64)
            ts_c, ts_d, n_color, n_depth = struct.unpack("<QQQQ", f.read(32))
            if keep:
                color = f.read(n_color)
                depth = f.read(n_depth)
                yield SensFrame(
                    index=i,
                    camera_to_world=np.frombuffer(
                        pose_bytes, dtype="<f4").reshape(4, 4)
                    .astype(np.float64),
                    timestamp_color=ts_c, timestamp_depth=ts_d,
                    color_jpeg=color, depth_zlib=depth,
                )
            else:
                f.seek(n_color + n_depth, os.SEEK_CUR)


def read_sens(path: str, frame_skip: int = 1):
    """(header, [frames]) — loads the kept frames into memory."""
    with open(path, "rb") as f:
        header = read_header(f)
    frames = list(iter_frames(path, frame_skip))
    return header, frames


def export_posed_images(
    sens_path: str,
    output_dir: str,
    frame_skip: int = 1,
    inflate: Callable[[bytes], bytes] | None = None,
) -> int:
    """Write the reference posed_images layout: `NNNNN.jpg`, 16-bit
    `NNNNN.png` depth, `NNNNN.txt` pose, `intrinsic.txt`
    (extract_posed_images.py:113-158 output contract). Returns the number
    of exported frames. Frame files are numbered by *kept* order, matching
    the reference (`index_to_str(f)` over the kept list, :134-136)."""
    from .png import imwrite_png   # cv2.imwrite's bytes, without cv2

    if inflate is None:
        from .native import zlib_inflate

        inflate = zlib_inflate
    mkdir_or_exist(output_dir)
    with open(sens_path, "rb") as f:
        header = read_header(f)
    np.savetxt(os.path.join(output_dir, "intrinsic.txt"),
               header.intrinsic_color, fmt="%f")
    count = 0
    for frame in iter_frames(sens_path, frame_skip):
        stem = f"{count:05d}"
        with open(os.path.join(output_dir, f"{stem}.jpg"), "wb") as jf:
            jf.write(frame.color_jpeg)
        depth = frame.depth_mm(header.depth_hw, inflate)
        imwrite_png(os.path.join(output_dir, f"{stem}.png"), depth)
        np.savetxt(os.path.join(output_dir, f"{stem}.txt"),
                   frame.camera_to_world, fmt="%f")
        count += 1
    return count


def write_sens(path: str, header: SensHeader, frames: list[SensFrame]):
    """Serialize a .sens stream (fixtures/tests; inverse of read_sens)."""
    with open(path, "wb") as f:
        f.write(struct.pack("<I", SUPPORTED_VERSION))
        name = header.sensor_name.encode("ascii")
        f.write(struct.pack("<Q", len(name)))
        f.write(name)
        for m in (header.intrinsic_color, header.extrinsic_color,
                  header.intrinsic_depth, header.extrinsic_depth):
            f.write(np.asarray(m, dtype="<f4").tobytes())
        inv_c = {v: k for k, v in COMPRESSION_TYPE_COLOR.items()}
        inv_d = {v: k for k, v in COMPRESSION_TYPE_DEPTH.items()}
        f.write(struct.pack("<ii", inv_c[header.color_compression],
                            inv_d[header.depth_compression]))
        f.write(struct.pack("<IIII", header.color_hw[1], header.color_hw[0],
                            header.depth_hw[1], header.depth_hw[0]))
        f.write(struct.pack("<f", header.depth_shift))
        f.write(struct.pack("<Q", len(frames)))
        for fr in frames:
            f.write(np.asarray(fr.camera_to_world, dtype="<f4").tobytes())
            f.write(struct.pack("<QQQQ", fr.timestamp_color,
                                fr.timestamp_depth, len(fr.color_jpeg),
                                len(fr.depth_zlib)))
            f.write(fr.color_jpeg)
            f.write(fr.depth_zlib)
