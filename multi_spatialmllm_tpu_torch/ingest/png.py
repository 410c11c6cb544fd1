"""PNG reading and writing equal to OpenCV's, without cv2.

`imencode_png` gives the bytes of `cv2.imencode(".png", img)` at cv2's
defaults, which go through libpng 1.6 and zlib: an IHDR, the image data
with the Sub filter on every row (None where the image is one pixel wide,
as libpng drops the filters that need a left neighbour), deflated at level
1, memLevel 8, `Z_RLE`, with libpng's window (the smallest that holds the
filtered data plus 262 bytes, under 16 KiB of data) and its trimmed zlib
header, cut into IDAT chunks of 8,192 bytes, then IEND; no ancillary chunk.
The deflate stream is Python's `zlib`, so the bytes are cv2's where both
link the same zlib (`zlib.ZLIB_RUNTIME_VERSION`).

`imread_png` decodes non-interlaced 8- and 16-bit grey, grey+alpha, RGB
and RGBA files with any filter types and IDAT chunking, to the pixels of
`cv2.imread(path, cv2.IMREAD_UNCHANGED)` (`UNCHANGED`) or of
`cv2.imread(path)` (`COLOR`: three 8-bit BGR channels, the low byte of a
16-bit sample dropped, alpha dropped, grey repeated, and an eXIf
orientation applied as cv2 applies it). Palette images, bit depths below 8,
interlaced files and transparency chunks raise ValueError.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

UNCHANGED, COLOR = -1, 1          # cv2.IMREAD_UNCHANGED, cv2.IMREAD_COLOR

SIGNATURE = b"\x89PNG\r\n\x1a\n"
IDAT_BYTES = 8192                 # libpng's PNG_ZBUF_SIZE
_COLOR_TYPES = {1: 0, 3: 2, 4: 6}  # channels -> PNG colour type
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _window_bits(size: int) -> int:
    """libpng's deflate window for `size` bytes of filtered data
    (pngwutil.c, png_deflate_claim)."""
    bits = 15
    if size <= 16384:
        half = 1 << (bits - 1)
        while size + 262 <= half:
            half >>= 1
            bits -= 1
    return bits


def _optimize_cmf(z: bytearray, size: int) -> None:
    """libpng's optimize_cmf: the zlib header names the smallest window
    that holds `size` bytes (the stream itself is unchanged)."""
    if size > 16384:
        return
    cmf = z[0]
    if (cmf & 0x0F) != 8 or (cmf & 0xF0) > 0x70:
        return
    cinfo = cmf >> 4
    half = 1 << (cinfo + 7)
    if size > half:
        return
    while True:
        half >>= 1
        cinfo -= 1
        if not (cinfo > 0 and size <= half):
            break
    cmf = (cmf & 0x0F) | (cinfo << 4)
    z[0] = cmf
    flg = z[1] & 0xE0
    z[1] = flg + 0x1F - ((cmf << 8) + flg) % 0x1F


def imencode_png(img: np.ndarray) -> bytes:
    """The bytes of `cv2.imencode(".png", img)` for a uint8 or uint16
    image of shape [H, W] (grey), [H, W, 3] (BGR) or [H, W, 4] (BGRA)."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"PNG takes uint8 or uint16, got {img.dtype}")
    cn = 1 if img.ndim == 2 else (img.shape[2] if img.ndim == 3 else 0)
    if cn not in _COLOR_TYPES:
        raise ValueError(f"PNG takes [H, W], [H, W, 3] or [H, W, 4], got "
                         f"{list(img.shape)}")
    h, w = img.shape[:2]
    if not (0 < h < 2**31 and 0 < w < 2**31):
        raise ValueError(f"PNG cannot hold a {h} x {w} image")
    px = img if cn == 1 else img[..., [2, 1, 0, 3][:cn]]   # BGR(A) -> RGB(A)
    raw = np.ascontiguousarray(
        px, px.dtype.newbyteorder(">")).reshape(h, -1).view(np.uint8)
    bpp = cn * img.dtype.itemsize
    rows = np.empty((h, raw.shape[1] + 1), np.uint8)
    if w == 1:
        rows[:, 0] = 0                           # None
        rows[:, 1:] = raw
    else:
        rows[:, 0] = 1                           # Sub
        rows[:, 1:bpp + 1] = raw[:, :bpp]
        np.subtract(raw[:, bpp:], raw[:, :-bpp], out=rows[:, bpp + 1:])
    data = rows.tobytes()
    co = zlib.compressobj(1, zlib.DEFLATED, _window_bits(len(data)), 8,
                          zlib.Z_RLE)
    z = bytearray(co.compress(data) + co.flush())
    _optimize_cmf(z, len(data))
    parts = [SIGNATURE, _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, img.dtype.itemsize * 8, _COLOR_TYPES[cn], 0, 0,
        0))]
    for i in range(0, len(z), IDAT_BYTES):
        parts.append(_chunk(b"IDAT", bytes(z[i:i + IDAT_BYTES])))
    parts.append(_chunk(b"IEND", b""))
    return b"".join(parts)


def imwrite_png(path: str, img: np.ndarray) -> None:
    """Write `imencode_png(img)` to `path` (cv2.imwrite's bytes)."""
    data = imencode_png(img)
    with open(path, "wb") as f:
        f.write(data)


def _unfilter(data: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """[h, stride] uint8 rows from the filtered stream (PNG filter types
    0-4). Runs of None/Sub rows are undone together in numpy; Average and
    Paeth rows, which cv2 never writes, byte by byte."""
    if len(data) < h * (stride + 1):
        raise ValueError("PNG: image data too short")
    rows = np.frombuffer(data, np.uint8, h * (stride + 1)).reshape(
        h, stride + 1)
    kinds = rows[:, 0]
    if kinds.max(initial=0) > 4:
        raise ValueError(f"PNG: unknown filter type {int(kinds.max())}")
    out = rows[:, 1:].copy()
    w = stride // bpp
    y = 0
    while y < h:
        kind = int(kinds[y])
        if kind in (0, 1):
            end = y + 1
            while end < h and kinds[end] in (0, 1):
                end += 1
            sub = np.flatnonzero(kinds[y:end] == 1) + y
            if len(sub):
                lanes = out[sub].reshape(len(sub), w, bpp)
                out[sub] = np.cumsum(lanes, axis=1, dtype=np.uint8).reshape(
                    len(sub), stride)
            y = end
            continue
        prev = out[y - 1] if y else np.zeros(stride, np.uint8)
        if kind == 2:                               # Up
            out[y] += prev
        else:
            cur = out[y].tolist()
            up = prev.tolist()
            for i in range(stride):
                left = cur[i - bpp] if i >= bpp else 0
                if kind == 3:                       # Average
                    cur[i] = (cur[i] + ((left + up[i]) >> 1)) & 0xFF
                else:                               # Paeth
                    ul = up[i - bpp] if i >= bpp else 0
                    p = left + up[i] - ul
                    pa, pb, pc = abs(p - left), abs(p - up[i]), abs(p - ul)
                    pred = (left if pa <= pb and pa <= pc
                            else up[i] if pb <= pc else ul)
                    cur[i] = (cur[i] + pred) & 0xFF
            out[y] = cur
        y += 1
    return out


def exif_orientation(tiff: bytes) -> int:
    """The Orientation tag (0x0112) of IFD0 in a TIFF-structured EXIF
    block, or 1 where there is none."""
    if len(tiff) < 8 or tiff[:2] not in (b"II", b"MM"):
        return 1
    e = "<" if tiff[:2] == b"II" else ">"
    off = struct.unpack(e + "I", tiff[4:8])[0]
    if off + 2 > len(tiff):
        return 1
    n = struct.unpack(e + "H", tiff[off:off + 2])[0]
    for k in range(n):
        p = off + 2 + 12 * k
        if p + 12 > len(tiff):
            break
        tag, typ = struct.unpack(e + "HH", tiff[p:p + 4])
        if tag == 0x0112 and typ == 3:
            return struct.unpack(e + "H", tiff[p + 8:p + 10])[0]
    return 1


def apply_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """cv2's ApplyExifOrientation: the EXIF orientations 2-8 as flips and
    transposes (1 and unknown values leave the image as it is)."""
    t = np.swapaxes(img, 0, 1) if orientation in (5, 6, 7, 8) else img
    if orientation in (2, 3, 6, 7):        # left-right
        t = t[:, ::-1]
    if orientation in (3, 4, 7, 8):        # top-bottom
        t = t[::-1]
    return np.ascontiguousarray(t)


def _read_bytes(buf_or_path) -> bytes:
    if isinstance(buf_or_path, (str, os.PathLike)):
        with open(buf_or_path, "rb") as f:
            return f.read()
    if isinstance(buf_or_path, np.ndarray):
        return buf_or_path.tobytes()
    return bytes(buf_or_path)


def imread_png(buf_or_path, flags: int = UNCHANGED) -> np.ndarray:
    """Decode a PNG file (a path, or its bytes) as `cv2.imread` does with
    `flags` UNCHANGED (-1) or COLOR (1)."""
    if flags not in (UNCHANGED, COLOR):
        raise ValueError(f"imread_png: flags {flags} (UNCHANGED -1 or "
                         f"COLOR 1)")
    data = _read_bytes(buf_or_path)
    if not data.startswith(SIGNATURE):
        raise ValueError("not a PNG file")
    pos, header, idat, orientation = 8, None, [], 1
    while True:
        if pos + 12 > len(data):
            raise ValueError("PNG: truncated before IEND")
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = data[pos + 8 + n:pos + 12 + n]
        if len(body) != n or len(crc) != 4:
            raise ValueError(f"PNG: truncated {kind!r} chunk")
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + body) & 0xFFFFFFFF:
            raise ValueError(f"PNG: bad CRC in {kind!r}")
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        elif kind in (b"PLTE", b"tRNS"):
            raise ValueError(f"PNG: {kind.decode()} (palette or "
                             f"transparency) is not supported")
        elif kind == b"eXIf":
            orientation = exif_orientation(body)
    if header is None or not idat:
        raise ValueError("PNG: no IHDR or no IDAT")
    w, h, depth, ctype, comp, filt, interlace = header
    if ctype not in _CHANNELS:
        raise ValueError(f"PNG: colour type {ctype} is not supported")
    if depth not in (8, 16):
        raise ValueError(f"PNG: bit depth {depth} is not supported")
    if comp or filt or interlace:
        raise ValueError("PNG: interlaced or non-standard files are not "
                         "supported")
    cn = _CHANNELS[ctype]
    bpp = cn * depth // 8
    rows = _unfilter(zlib.decompress(b"".join(idat)), h, w * bpp, bpp)
    img = rows.view(">u2" if depth == 16 else np.uint8).reshape(h, w, cn)
    if flags == COLOR:
        if depth == 16:
            img = (img >> 8).astype(np.uint8)
        img = (np.repeat(img[..., :1], 3, axis=2) if cn <= 2
               else img[..., 2::-1])
        return apply_orientation(img, orientation)
    img = img.astype(np.uint16 if depth == 16 else np.uint8)
    if cn == 1:
        return np.ascontiguousarray(img[..., 0])
    if cn == 2:                           # grey+alpha -> BGRA
        return np.ascontiguousarray(img[..., [0, 0, 0, 1]])
    return np.ascontiguousarray(img[..., [2, 1, 0, 3][:cn]])
