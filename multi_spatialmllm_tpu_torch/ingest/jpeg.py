"""JPEG decoding and encoding equal to OpenCV's, without cv2.

ctypes bindings to the native codec (ingest/native/src/jpeg_codec.cpp),
which reproduces libjpeg-turbo at the defaults cv2 uses: `imdecode` gives
the pixels of `cv2.imdecode(buf, cv2.IMREAD_UNCHANGED)` and `imencode` the
bytes of `cv2.imencode(".jpg", bgr, [cv2.IMWRITE_JPEG_QUALITY, quality])`.
Every call releases the interpreter lock (ctypes), so threads that decode
and encode frames run in parallel. There is no cv2 fallback: each function
raises where the native library cannot be built.
"""

from __future__ import annotations

import ctypes

import numpy as np

from . import native

_ERRCAP = 256


def _lib():
    lib = native._load()
    if lib is None:
        raise RuntimeError(
            f"the native JPEG codec is unavailable ({native.build_error})")
    if not getattr(lib, "_has_codec", False):
        lib.msm_codec_info.restype = ctypes.c_int
        lib.msm_codec_info.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.c_char_p, ctypes.c_int]
        lib.msm_codec_decode.restype = ctypes.c_int
        lib.msm_codec_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_long,
            ctypes.c_char_p, ctypes.c_int]
        lib.msm_codec_encode.restype = ctypes.c_long
        lib.msm_codec_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_long]
        lib._has_codec = True
    return lib


def _bytes(buf) -> bytes:
    return buf.tobytes() if isinstance(buf, np.ndarray) else bytes(buf)


def _info(lib, data: bytes) -> tuple[int, int, int]:
    h, w, nc = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(_ERRCAP)
    if lib.msm_codec_info(data, len(data), ctypes.byref(h), ctypes.byref(w),
                          ctypes.byref(nc), err, _ERRCAP):
        raise ValueError(f"JPEG: {err.value.decode()}")
    return h.value, w.value, nc.value


def jpeg_size(buf) -> tuple[int, int]:
    """(height, width) from the frame header."""
    h, w, _ = _info(_lib(), _bytes(buf))
    return h, w


def imdecode(buf) -> np.ndarray:
    """uint8 [H, W, 3] in BGR order (or [H, W] for a greyscale file), equal
    to `cv2.imdecode(buf, cv2.IMREAD_UNCHANGED)`. Baseline and extended
    sequential Huffman 8-bit files, 4:2:0, 4:2:2, 4:4:4 and greyscale;
    progressive, arithmetic-coded, lossless or 12-bit input raises
    ValueError naming what it met."""
    lib = _lib()
    data = _bytes(buf)
    h, w, nc = _info(lib, data)
    out = np.empty((h, w, 3) if nc == 3 else (h, w), np.uint8)
    err = ctypes.create_string_buffer(_ERRCAP)
    if lib.msm_codec_decode(data, len(data), out.ctypes.data, out.size, err,
                            _ERRCAP):
        raise ValueError(f"JPEG: {err.value.decode()}")
    return out


def imencode(bgr: np.ndarray, quality: int = 95) -> bytes:
    """The bytes of `cv2.imencode(".jpg", bgr, [cv2.IMWRITE_JPEG_QUALITY,
    quality])` for a uint8 [H, W, 3] BGR image: baseline 4:2:0, the
    standard Huffman tables, a JFIF header, no restart markers."""
    img = np.ascontiguousarray(bgr)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"imencode takes uint8 [H, W, 3] BGR, got "
                         f"{img.dtype}{list(img.shape)}")
    h, w = img.shape[:2]
    if not (0 < h <= 65535 and 0 < w <= 65535):
        raise ValueError(f"JPEG cannot hold a {h} x {w} image")
    lib = _lib()
    cap = h * w * 3 + 4096
    while True:
        out = np.empty(cap, np.uint8)
        n = lib.msm_codec_encode(img.ctypes.data, h, w, int(quality),
                                 out.ctypes.data, cap)
        if n > 0:
            return out[:n].tobytes()
        if n == 0:
            raise RuntimeError(f"the native encoder refused a {h} x {w} image")
        cap = -n   # short: the encoder reports the size it needs


def imwrite(path: str, bgr: np.ndarray, quality: int = 95) -> None:
    """Write `imencode(bgr, quality)` to `path` (cv2.imwrite's bytes)."""
    data = imencode(bgr, quality)
    with open(path, "wb") as f:
        f.write(data)
