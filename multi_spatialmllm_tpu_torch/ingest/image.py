"""`cv2.imread` and `cv2.imdecode` for the JPEG and PNG files of the data
engine and the model, without cv2.

The format is chosen by the file's magic bytes: JPEG through the native
codec (ingest/jpeg.py), PNG through ingest/png.py; anything else raises.
`COLOR` gives three 8-bit BGR channels as `cv2.IMREAD_COLOR` does: a grey
JPEG is repeated into three channels and an EXIF orientation is applied as
cv2 applies it. `UNCHANGED` gives the file's own channels and depth.
"""

from __future__ import annotations

import struct

import numpy as np

from . import jpeg, png
from .png import COLOR, UNCHANGED

JPEG_MAGIC = b"\xff\xd8\xff"


def jpeg_exif_orientation(data: bytes) -> int:
    """The EXIF orientation of a JPEG's first APP1 Exif segment (1 where
    there is none), read from the markers before the first scan."""
    pos = 2
    while pos + 4 <= len(data) and data[pos] == 0xFF:
        marker = data[pos + 1]
        if marker == 0xFF:                 # fill byte
            pos += 1
            continue
        if marker == 0xDA or marker == 0xD9:   # SOS, EOI: no more headers
            break
        n = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        seg = data[pos + 4:pos + 2 + n]
        if marker == 0xE1 and seg.startswith(b"Exif\x00\x00"):
            return png.exif_orientation(seg[6:])
        pos += 2 + n
    return 1


def imdecode(buf, flags: int = COLOR) -> np.ndarray:
    """`cv2.imdecode(buf, flags)` for a JPEG or PNG file's bytes, flags
    COLOR (1) or UNCHANGED (-1)."""
    data = buf.tobytes() if isinstance(buf, np.ndarray) else bytes(buf)
    if data.startswith(png.SIGNATURE):
        return png.imread_png(data, flags)
    if not data.startswith(JPEG_MAGIC):
        raise ValueError("neither a JPEG nor a PNG file")
    if flags not in (COLOR, UNCHANGED):
        raise ValueError(f"imdecode: flags {flags} (UNCHANGED -1 or "
                         f"COLOR 1)")
    img = jpeg.imdecode(data)
    if flags == UNCHANGED:
        return img
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=2)
    return png.apply_orientation(img, jpeg_exif_orientation(data))


def imread(path: str, flags: int = COLOR) -> np.ndarray:
    """`cv2.imread(path, flags)` for a JPEG or PNG file; a missing file
    raises FileNotFoundError (cv2 returns None)."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        return imdecode(data, flags)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None


def color_size(buf) -> tuple[int, int]:
    """(height, width) of `cv2.imdecode(buf, cv2.IMREAD_COLOR)` from the
    file's headers alone (no pixel decode): the frame size, swapped where
    an EXIF orientation transposes the image."""
    data = buf.tobytes() if isinstance(buf, np.ndarray) else bytes(buf)
    if data.startswith(png.SIGNATURE):
        return png.imread_png(data, COLOR).shape[:2]
    if not data.startswith(JPEG_MAGIC):
        raise ValueError("neither a JPEG nor a PNG file")
    h, w = jpeg.jpeg_size(data)
    return (w, h) if jpeg_exif_orientation(data) in (5, 6, 7, 8) else (h, w)
