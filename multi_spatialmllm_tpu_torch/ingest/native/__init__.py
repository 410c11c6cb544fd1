"""ctypes bindings for the native ingestion helpers (libmsm_native.so).

The C++ library (src/msm_native.cpp, built by build.sh) provides single and
multithreaded-batch zlib inflate for .sens depth streams. The inflate has
no fallback: where the library cannot be built, or a stream is rejected,
it raises, so an ingest run never times Python's inflate in its place.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile

import numpy as np

_DIR = os.path.dirname(__file__)
_BUILD_DIR = os.path.join(_DIR, "_build")
_SOURCES = ("build.sh", "src/msm_native.cpp", "src/jsonl_emit.cpp",
            "src/jpeg_encode.cpp", "src/jpeg_codec.cpp", "src/ryu_tables.h")
_lib = None
build_error: str | None = None   # why the library could not be built


def library_path(native_dir: str = _DIR) -> str:
    """`_build/libmsm_native-<digest>.so`: the digest covers every source
    of `native_dir` and its build.sh (which holds the compiler flags), so
    an edit to either names a new library and a stale build never loads."""
    h = hashlib.sha256()
    for rel in _SOURCES:
        with open(os.path.join(native_dir, rel), "rb") as f:
            h.update(rel.encode() + b"\0" + f.read() + b"\0")
    return os.path.join(_BUILD_DIR,
                        f"libmsm_native-{h.hexdigest()[:16]}.so")


def build(force: bool = False) -> str:
    """Compile the shared library (idempotent). Concurrent processes each
    write a temporary file and rename it into place."""
    path = library_path()
    if force or not os.path.exists(path):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run(["bash", os.path.join(_DIR, "build.sh"), tmp],
                           check=True, capture_output=True, text=True)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return path


def _load():
    """The library, built at first use; None where it cannot be built
    (the reason is kept in `build_error`)."""
    global _lib, build_error
    if _lib is not None:
        return _lib
    if build_error is not None:
        return None
    try:
        path = build()
    except subprocess.CalledProcessError as e:
        build_error = f"build.sh exit {e.returncode}: {e.stderr}"
        return None
    except OSError as e:
        build_error = f"build.sh could not run: {e}"
        return None
    lib = ctypes.CDLL(path)
    lib.msm_inflate.restype = ctypes.c_int
    lib.msm_inflate.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_size_t)]
    lib.msm_inflate_batch.restype = ctypes.c_int
    lib.msm_inflate_batch.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_size_t), ctypes.POINTER(ctypes.c_size_t),
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_size_t), ctypes.POINTER(ctypes.c_size_t),
        ctypes.POINTER(ctypes.c_size_t), ctypes.c_size_t, ctypes.c_int]
    try:
        lib.msm_jpeg_encode.restype = ctypes.c_long
        lib.msm_jpeg_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_long]
        lib.msm_jpeg_prepare.restype = ctypes.c_int64
        lib.msm_jpeg_prepare.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.msm_jpeg_encode_spliced.restype = ctypes.c_long
        lib.msm_jpeg_encode_spliced.argtypes = [
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_long]
        lib.msm_jpeg_encode_spliced_cols.restype = ctypes.c_long
        lib.msm_jpeg_encode_spliced_cols.argtypes = [
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long]
        lib.msm_jpeg_release.restype = None
        lib.msm_jpeg_release.argtypes = [ctypes.c_int64]
        lib._has_jpeg = True
    except AttributeError:  # stale .so from before the jpeg engine
        lib._has_jpeg = False
    try:  # multi-interval span splice (added after _cols; optional)
        lib.msm_jpeg_encode_spliced_spans.restype = ctypes.c_long
        lib.msm_jpeg_encode_spliced_spans.argtypes = [
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_long]
        lib._has_jpeg_spans = lib._has_jpeg
    except AttributeError:
        lib._has_jpeg_spans = False
    _lib = lib
    return lib


def native_available() -> bool:
    return _load() is not None


def zlib_inflate(data: bytes, expected_size: int | None = None) -> bytes:
    """Inflate one stream with the native library (raises where it
    cannot be built or rejects the stream)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the native inflate is unavailable "
                           f"({build_error})")
    cap = expected_size if expected_size else max(16, len(data) * 20)
    while True:
        dst = ctypes.create_string_buffer(cap)
        out_len = ctypes.c_size_t(0)
        rc = lib.msm_inflate(data, len(data), dst, cap,
                             ctypes.byref(out_len))
        if rc == 0:
            return dst.raw[: out_len.value]
        if rc == -5 and expected_size is None:  # Z_BUF_ERROR: grow
            cap *= 4
            continue
        raise ValueError(f"the native inflate rejected the stream "
                         f"(error {rc})")


def zlib_inflate_batch(
    streams: list[bytes],
    expected_size: int,
    n_threads: int | None = None,
) -> list[bytes]:
    """Inflate many same-capacity streams concurrently (depth frames all
    decompress to depth_h*depth_w*2 bytes); raises where the library
    cannot be built or rejects a stream."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the native inflate is unavailable "
                           f"({build_error})")
    if n_threads is None:
        n_threads = min(os.cpu_count() or 4, 16)
    n = len(streams)
    src = b"".join(streams)
    src_offsets = (ctypes.c_size_t * n)()
    src_lens = (ctypes.c_size_t * n)()
    dst_offsets = (ctypes.c_size_t * n)()
    dst_caps = (ctypes.c_size_t * n)()
    out_lens = (ctypes.c_size_t * n)()
    off = 0
    for i, s in enumerate(streams):
        src_offsets[i] = off
        src_lens[i] = len(s)
        dst_offsets[i] = i * expected_size
        dst_caps[i] = expected_size
        off += len(s)
    dst = ctypes.create_string_buffer(n * expected_size)
    lib.msm_inflate_batch(
        src, src_offsets, src_lens, dst, dst_offsets, dst_caps, out_lens,
        n, n_threads)
    view = memoryview(dst)  # zero-copy; dst.raw would copy the whole buffer
    sentinel = ctypes.c_size_t(-1).value
    out = []
    for i in range(n):
        if out_lens[i] == sentinel:
            raise ValueError(f"the native inflate rejected stream {i} of "
                             f"{n}")
        start = i * expected_size
        out.append(bytes(view[start: start + out_lens[i]]))
    return out


def inflate_depth_frames(streams: list[bytes],
                         depth_hw: tuple[int, int]) -> np.ndarray:
    """`[n, Hd, Wd]` uint16 depth stack from zlib-ushort frame payloads."""
    expected = depth_hw[0] * depth_hw[1] * 2
    raw = zlib_inflate_batch(streams, expected)
    return np.stack([
        np.frombuffer(r, dtype=np.uint16).reshape(depth_hw) for r in raw])


# ---------------------------------------------------------------------------
# JPEG splice encoder (src/jpeg_encode.cpp) — the annotated engines'
# throughput path: a source frame is encoded ONCE with one restart
# interval per 16px MCU row; each annotated sample re-encodes only the
# dirty rows and memcpy-splices the rest (byte-aligned by spec).
# ---------------------------------------------------------------------------


def jpeg_available() -> bool:
    lib = _load()
    return lib is not None and lib._has_jpeg


def jpeg_encode(bgr: np.ndarray, quality: int = 95) -> bytes | None:
    """Full encode of a [H, W, 3] uint8 BGR image; None if unavailable.
    An output buffer the encoder reports short is retried at the size it
    reports."""
    lib = _load()
    if lib is None or not lib._has_jpeg:
        return None
    img = np.ascontiguousarray(bgr)
    h, w = img.shape[:2]
    cap = h * w * 4 + (1 << 16)
    while True:
        out = np.empty(cap, np.uint8)
        n = lib.msm_jpeg_encode(img.ctypes.data, h, w, quality,
                                out.ctypes.data, cap)
        if n >= 0:
            break
        cap = -n   # short: the encoder reports the size it needs
    if n == 0:
        return None
    return out[:n].tobytes()


class JpegSpliceCache:
    """Bounded cache of prepared (per-row-segmented) source frames.

    `encode(key, base, annotated, y0, y1)` returns the JPEG bytes of
    `annotated`, re-encoding only MCU rows intersecting [y0, y1) when
    `base` was already prepared under `key` — bit-identical to a full
    native encode of `annotated` (splice invariant, test-asserted).
    Thread-safe: a racing eviction degrades that call to a full encode.
    """

    def __init__(self, max_entries: int = 256, quality: int = 95):
        import threading

        self.max_entries = max_entries
        self.quality = quality
        self._handles: dict = {}
        self._lock = threading.Lock()
        self._tls = threading.local()  # reused output buffers

    def _out_buf(self, cap: int) -> np.ndarray:
        buf = getattr(self._tls, "buf", None)
        if buf is None or buf.size < cap:
            buf = np.empty(cap, np.uint8)
            self._tls.buf = buf
        return buf

    def _handle_for(self, key, base: np.ndarray) -> int:
        with self._lock:
            hdl = self._handles.get(key)
        if hdl is not None:
            return hdl
        lib = _load()
        img = np.ascontiguousarray(base)
        hdl = lib.msm_jpeg_prepare(img.ctypes.data, img.shape[0],
                                   img.shape[1], self.quality)
        if hdl == 0:  # prepare failed: never cache a dead handle
            return 0
        with self._lock:
            if key in self._handles:  # racing prepare: keep the first
                lib.msm_jpeg_release(hdl)
                return self._handles[key]
            if len(self._handles) >= self.max_entries:
                old_key = next(iter(self._handles))
                lib.msm_jpeg_release(self._handles.pop(old_key))
            self._handles[key] = hdl
        return hdl

    def encode(self, key, base: np.ndarray, annotated: np.ndarray,
               y0: int, y1: int) -> bytes | None:
        lib = _load()
        if lib is None or not lib._has_jpeg:
            return None
        hdl = self._handle_for(key, base)
        img = np.ascontiguousarray(annotated)
        h, w = img.shape[:2]
        cap = h * w * 4 + (1 << 16)
        out = np.empty(cap, np.uint8)
        n = lib.msm_jpeg_encode_spliced(hdl, img.ctypes.data, int(y0),
                                        int(y1), out.ctypes.data, cap)
        if n == 0:  # handle evicted concurrently: full encode
            return jpeg_encode(img, self.quality)
        if n < 0:
            return None
        return out[:n].tobytes()

    def _col_arrays(self, h: int, spans):
        """(x0s, x1s) int32 [mcu_h] from (y0, y1, x0, x1) pixel spans —
        per MCU row, the union x-range of the spans covering it."""
        mcu_h = (h + 15) // 16
        x0s = np.empty(mcu_h, np.int32); x0s.fill(-1)
        x1s = np.empty(mcu_h, np.int32); x1s.fill(-1)
        for y0, y1, x0, x1 in spans:
            r0 = max(0, int(y0)) // 16
            r1 = min((int(y1) + 15) // 16, mcu_h)
            # clamp x0 to 0: negative (left-edge-clipped) spans must not
            # reach the native side, where x0 < 0 means "row clean"
            x0 = max(0, int(x0))
            for r in range(r0, r1):
                if x0s[r] < 0:
                    x0s[r], x1s[r] = x0, int(x1)
                else:
                    x0s[r] = min(x0s[r], x0)
                    x1s[r] = max(x1s[r], int(x1))
        return x0s, x1s

    @staticmethod
    def _span_array(spans) -> np.ndarray:
        """Contiguous int32 [n, 4] of (y0, y1, x0, x1) pixel rects for
        the native span-splice entry point."""
        sp = np.array(list(spans), np.int32)
        return np.ascontiguousarray(sp.reshape(-1, 4))

    def encode_cols(self, key, base: np.ndarray, annotated: np.ndarray,
                    spans) -> bytes | None:
        """Bit-granular column splice: `spans` is a list of
        (y0, y1, x0, x1) dirty pixel rectangles; only the 16x16 MCUs they
        intersect are re-encoded (a dot touches ~2-3 of a 640px row's 40
        MCUs — ~6x less work than even the row splice). `annotated` only
        needs valid pixels on the dirty MCU rows (callers may pass a
        scratch whose clean rows are stale), so on ANY native failure
        (evicted/dead handle, short output cap) this returns None — the
        caller must fall back with a fully-valid frame, never with
        `annotated`."""
        lib = _load()
        if lib is None or not lib._has_jpeg:
            return None
        hdl = self._handle_for(key, base)
        img = np.ascontiguousarray(annotated)
        h, w = base.shape[:2]
        cap = h * w * 4 + (1 << 16)
        out = self._out_buf(cap)
        if lib._has_jpeg_spans:
            # per-row MCU interval LISTS (multi-dot rows re-encode each
            # dot's MCUs, not the union span between them)
            sp = self._span_array(spans)
            n = lib.msm_jpeg_encode_spliced_spans(
                hdl, img.ctypes.data, sp.ctypes.data, sp.shape[0],
                out.ctypes.data, out.size)
        else:
            x0s, x1s = self._col_arrays(h, spans)
            n = lib.msm_jpeg_encode_spliced_cols(
                hdl, img.ctypes.data, x0s.ctypes.data, x1s.ctypes.data,
                out.ctypes.data, out.size)
        if n <= 0:
            return None
        return out[:n].tobytes()

    def encode_cols_band(self, key, base: np.ndarray, band: np.ndarray,
                         band_y0: int, spans) -> bytes | None:
        """`encode_cols` with only the band rows
        [band_y0, band_y0 + band.shape[0]) materialized (must cover every
        dirty MCU row; the native side only reads those)."""
        lib = _load()
        if lib is None or not lib._has_jpeg:
            return None
        hdl = self._handle_for(key, base)
        band = np.ascontiguousarray(band)
        h, w = base.shape[:2]
        mcu_h = (h + 15) // 16
        lo = hi = None
        for y0, y1, _, _ in spans:
            r0 = max(0, int(y0)) // 16
            r1 = min((int(y1) + 15) // 16, mcu_h)
            if r1 > r0:
                lo = r0 if lo is None else min(lo, r0)
                hi = r1 if hi is None else max(hi, r1)
        if lo is not None:
            plo, phi = lo * 16, min(hi * 16, h)
            if not (band_y0 <= plo and band_y0 + band.shape[0] >= phi):
                raise ValueError((band_y0, band.shape, plo, phi))
        virtual = band.ctypes.data - band_y0 * w * 3
        cap = h * w * 4 + (1 << 16)
        out = self._out_buf(cap)
        if lib._has_jpeg_spans:
            sp = self._span_array(spans)
            n = lib.msm_jpeg_encode_spliced_spans(
                hdl, virtual, sp.ctypes.data, sp.shape[0],
                out.ctypes.data, out.size)
        else:
            x0s, x1s = self._col_arrays(h, spans)
            n = lib.msm_jpeg_encode_spliced_cols(
                hdl, virtual, x0s.ctypes.data, x1s.ctypes.data,
                out.ctypes.data, out.size)
        if n <= 0:
            return None
        return out[:n].tobytes()

    def close(self) -> None:
        lib = _load()
        with self._lock:
            if lib is not None and lib._has_jpeg:
                for hdl in self._handles.values():
                    lib.msm_jpeg_release(hdl)
            self._handles.clear()


# Note: this build VM exposes a single CPU core, so the measured batch
# speedup here is ~1x; on production TPU-host VMs (dozens of cores) the
# batched inflate scales with n_threads (pure C, GIL released by ctypes).
