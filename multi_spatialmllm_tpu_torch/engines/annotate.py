"""Host-side image annotation for the "dot" engine variants, the port of
multi_spatialmllm_tpu/engines/annotate.py without cv2: the glyphs come from
stored renders (engines/_glyphs.py, made by scripts/gen_glyphs.py) and the
writer encodes only through the native JPEG encoder, raising where that
library cannot be built.

The reference annotates with OpenCV inside the per-sample loop
(depth_estimation_dot_engine.py:162-173, depth_comparison_dot_engine.py
:332-346, visual_correspondence_qa_engine_dot_2_multichoice.py:357-397).
Annotation is I/O-bound host work; this module keeps the exact drawing
semantics (circle radius 10, letter offsets, distinct-color retry rule) and
decouples image *sourcing* behind a provider so engines run on reference
data, scene packs, or synthetic images alike.
"""

from __future__ import annotations

import functools
import os
import weakref
from typing import Protocol

import numpy as np

from ..core.io import mkdir_or_exist
from . import _glyphs

# BGR predefined fallback palette (reference: red, green, blue, black, white
# in RGB tuples; OpenCV drawing uses them as-is).
PREDEFINED_COLORS = [
    (255, 0, 0), (0, 255, 0), (0, 0, 255), (0, 0, 0), (255, 255, 255)
]


def generate_distinct_colors(n: int, rng: np.random.Generator,
                             max_retries: int = 10) -> list[tuple]:
    """Random colors pairwise separated by Manhattan distance > 300, with a
    predefined-palette fallback (depth_estimation_coor_engine.py:22-33)."""
    colors: list[tuple] = []
    retries = 0
    while len(colors) < n and retries < max_retries:
        # three separate scalar draws — the exact stream order the dict
        # and fast emission paths both rely on for byte parity
        r = int(rng.integers(0, 256))
        g = int(rng.integers(0, 256))
        b = int(rng.integers(0, 256))
        for e in colors:
            if abs(r - e[0]) + abs(g - e[1]) + abs(b - e[2]) <= 300:
                break
        else:
            colors.append((r, g, b))
        retries += 1
    if len(colors) < n:
        pick = rng.choice(len(PREDEFINED_COLORS), size=n - len(colors),
                          replace=False)
        colors += [PREDEFINED_COLORS[int(i)] for i in pick]
    return colors


def _stored(table: dict, key, what: str):
    """An entry of engines/_glyphs.py; a glyph that is not stored raises
    (nothing is rendered here)."""
    try:
        return table[key]
    except KeyError:
        raise KeyError(
            f"{what} {key!r} is not stored in engines/_glyphs.py (stored: "
            f"{sorted(table)}); add it with scripts/gen_glyphs.py") from None


def _canvas(rows: tuple) -> np.ndarray:
    return np.array([np.frombuffer(bytes.fromhex(r), np.uint8)
                     for r in rows])


@functools.lru_cache(maxsize=8)
def _letter_metrics(font_scale: float, thickness: int):
    """cv2.getTextSize of a letter ("A"-"D" share Hershey metrics) —
    constant per (scale, thickness), queried once per annotated dot."""
    (tw, th), baseline = _stored(
        _glyphs.LETTERS, ("A", font_scale, thickness), "letter")[0]
    return tw, th, baseline


# -- glyph-mask stamping ----------------------------------------------------
# cv2 glyph rasterization is translation-invariant (integer geometry,
# fixed-point stroke coverage), so a glyph drawn ONCE by cv2 onto a
# scratch canvas characterizes every later draw of the same glyph:
#   - cv2.circle(..., -1) fills pure color -> a boolean "touched" mask,
#     stamp = masked assignment, cropped to the image like cv2's clipping.
#   - cv2.putText edge pixels are coverage-blended; rendering color=255 on
#     a zero canvas recovers the per-pixel coverage a (0..255) exactly, and
#     OpenCV's blend is d = (base*(255-a) + color*a + 127) // 255 per
#     channel (saturated pixels a==255 are plain fills) — verified
#     bit-exact against cv2.putText over 4,800 randomized renders.
# The dot engines draw the same few glyphs (radius-10 circle, letters)
# thousands of times per second; the numpy stamp replaces a per-draw cv2
# dispatch. (tests/test_jpeg_native.py asserts pixel equality vs cv2.)

@functools.lru_cache(maxsize=32)
def _circle_mask(radius: int) -> tuple[np.ndarray, int]:
    pad, rows = _stored(_glyphs.CIRCLES, radius, "circle radius")
    return _canvas(rows).astype(bool), pad


@functools.lru_cache(maxsize=64)
def _letter_glyph(letter: str, font_scale: float, thickness: int):
    """(full_mask, partial_mask, coverage, org_x, org_y): the pixels
    cv2.putText fills solid, the coverage-blended edge pixels with their
    0..255 coverage, and the putText org's position inside the canvas
    (padded so the glyph incl. stroke overdraw never clips)."""
    _, (org_x, org_y), rows = _stored(
        _glyphs.LETTERS, (letter, font_scale, thickness), "letter")
    cov = _canvas(rows).astype(np.int32)
    return (cov == 255, (cov > 0) & (cov < 255), cov, org_x, org_y)


def _stamp(image: np.ndarray, x0: int, y0: int, mask: np.ndarray,
           color) -> None:
    h, w = image.shape[:2]
    mh, mw = mask.shape
    sy0, sx0 = max(0, -y0), max(0, -x0)
    sy1, sx1 = min(mh, h - y0), min(mw, w - x0)
    if sy1 <= sy0 or sx1 <= sx0:
        return
    sub = mask if (sy0 == 0 and sx0 == 0 and sy1 == mh and sx1 == mw) \
        else mask[sy0:sy1, sx0:sx1]
    image[y0 + sy0:y0 + sy1, x0 + sx0:x0 + sx1][sub] = color


def draw_dot(image: np.ndarray, xy: tuple[int, int], color, radius: int = 10):
    mask, pad = _circle_mask(radius)
    _stamp(image, int(xy[0]) - pad, int(xy[1]) - pad, mask, color)


def draw_lettered_dot(
    image: np.ndarray,
    xy: tuple[int, int],
    letter: str,
    color,
    radius: int = 10,
    text_offset: tuple[int, int] = (15, 15),
    font_scale: float = 1.0,
    thickness: int = 2,
):
    x, y = int(xy[0]), int(xy[1])
    draw_dot(image, (x, y), color, radius)
    full, part, cov, px, py = _letter_glyph(letter, font_scale, thickness)
    x0, y0 = x + text_offset[0] - px, y + text_offset[1] - py
    h, w = image.shape[:2]
    mh, mw = full.shape
    sy0, sx0 = max(0, -y0), max(0, -x0)
    sy1, sx1 = min(mh, h - y0), min(mw, w - x0)
    if sy1 <= sy0 or sx1 <= sx0:
        return
    reg = image[y0 + sy0:y0 + sy1, x0 + sx0:x0 + sx1]
    fsub = full[sy0:sy1, sx0:sx1]
    reg[fsub] = color
    psub = part[sy0:sy1, sx0:sx1]
    if psub.any():
        a = cov[sy0:sy1, sx0:sx1][psub][:, None]
        base_px = reg[psub].astype(np.int32)
        col = np.asarray(color, np.int32)
        reg[psub] = ((base_px * (255 - a) + col * a + 127) // 255
                     ).astype(np.uint8)


class ImageProvider(Protocol):
    """Returns the BGR color image for (scene_id, image_id)."""

    def __call__(self, scene_id: str, image_id: str) -> np.ndarray: ...


class _BoundedImageCache:
    """FIFO-bounded decoded-image cache, safe under AnnotationPool's
    worker threads. Annotated engines sample the same source image many
    times (max_n_points_per_image / per-pair draws); caching the decode
    amortizes it. Callers must .copy() before drawing (every engine
    already does)."""

    def __init__(self, max_entries: int):
        import threading

        self.max_entries = max_entries
        self._cache: dict[tuple[str, str], np.ndarray] = {}
        self._lock = threading.Lock()

    def get_or_load(self, key: tuple[str, str], load) -> np.ndarray:
        with self._lock:
            img = self._cache.get(key)
        if img is None:
            img = load()  # concurrent double-loads are harmless
            with self._lock:
                if key not in self._cache and \
                        len(self._cache) >= self.max_entries:
                    self._cache.pop(next(iter(self._cache)))
                self._cache[key] = img
        return img


class DirImageProvider:
    """Reads `{root}/{scene_id}/{image_id}.jpg` (reference posed_images
    layout, info_handler.py:126-131), with a bounded decode cache
    (default 256 entries ~ 230 MB of 480x640 frames)."""

    def __init__(self, root: str, cache_entries: int = 256):
        self.root = root
        self._cache = _BoundedImageCache(cache_entries)

    def __call__(self, scene_id: str, image_id: str) -> np.ndarray:
        def load():
            from ..ingest.image import imread   # cv2.imread, without cv2

            path = os.path.join(self.root, scene_id, f"{image_id}.jpg")
            return imread(path)

        return self._cache.get_or_load((scene_id, image_id), load)


class SyntheticImageProvider:
    """Deterministic pseudo-images for tests/benchmarks (no dataset).

    Frames are CAMERA-LIKE (smooth gradients + blocky structure + mild
    sensor noise), not uniform noise: JPEG encode cost scales with
    entropy, and the reference's published rates are measured on real
    ScanNet frames — benchmarking the annotated engines on pure noise
    would overstate their encode cost ~2x against that baseline."""

    def __init__(self, image_hw: tuple[int, int], cache_entries: int = 256):
        self.image_hw = image_hw
        self._cache = _BoundedImageCache(cache_entries)

    def __call__(self, scene_id: str, image_id: str) -> np.ndarray:
        def load():
            h, w = self.image_hw
            seed = abs(hash((scene_id, image_id))) % (2**32)
            rng = np.random.default_rng(seed)
            yy, xx = np.mgrid[0:h, 0:w]
            a, b, c = rng.integers(2, 7, size=3)
            img = np.stack([(yy // a + xx // b) % 256,
                            (xx // c) % 256,
                            ((yy + xx) // (a + b)) % 256], -1).astype(np.int16)
            # a few flat rectangles (furniture/wall patches)
            for _ in range(6):
                y0 = int(rng.integers(0, h)); x0 = int(rng.integers(0, w))
                hh = int(rng.integers(h // 8, h // 2))
                ww = int(rng.integers(w // 8, w // 2))
                img[y0:y0 + hh, x0:x0 + ww] = rng.integers(0, 256, size=3)
            img += rng.integers(-8, 8, size=img.shape, dtype=np.int16)
            return np.ascontiguousarray(
                img.clip(0, 255).astype(np.uint8))

        return self._cache.get_or_load((scene_id, image_id), load)


def save_annotated(image: np.ndarray, image_output_dir: str,
                   relative_path: str) -> str:
    """Write an annotated jpg under the engine's image output dir; returns
    the relative path recorded in the sample's `image` list."""
    from ..ingest import jpeg   # cv2.imwrite's bytes, without cv2

    full = os.path.join(image_output_dir, relative_path)
    mkdir_or_exist(os.path.dirname(full))
    jpeg.imwrite(full, image, 95)
    return relative_path


class AnnotatedJpegWriter:
    """Draw + encode + write for the dot engines, with the native JPEG
    splice encoder when available.

    The reference re-encodes a full JPEG per annotated sample
    (depth_estimation_dot_engine.py:162-173); encode dominates its rate.
    The native path (ingest/native/src/jpeg_encode.cpp) amortizes that:
    each SOURCE frame is encoded once into byte-aligned per-MCU-row
    segments (restart markers), and each sample re-encodes only the
    ~2-4 rows its circle/letters touch — 3-6x per-sample on one core,
    more with threads. Encoded bytes come from this repo's baseline
    encoder, NOT cv2/libjpeg-turbo: decoded pixels match cv2's quality-95
    output (test-asserted pixel parity, tests/test_jpeg_native.py) but
    the byte streams differ. There is no cv2 fallback: a writer raises
    where the native library cannot be built, and a splice that returns
    nothing (a short output cap, a prepared frame lost to eviction) is
    redone as a whole-frame native encode, whose bytes equal the
    splice's.
    """

    # ONE process-wide prepared-frame cache: campaigns reuse source frames
    # across samples, engine calls, and engines (estimation + comparison +
    # correspondence all annotate the same posed_images), so the per-frame
    # prepare cost amortizes across all of them. Bounded (native handles
    # hold ~0.1-0.4 MB of row segments each); thread-safe.
    _shared_cache = None

    @classmethod
    def _shared(cls):
        if cls._shared_cache is None:
            from ..ingest.native import JpegSpliceCache

            cls._shared_cache = JpegSpliceCache(max_entries=256)
        return cls._shared_cache

    def __init__(self, image_provider: ImageProvider,
                 image_output_dir: str):
        from ..ingest import native

        if not native.jpeg_available():
            raise RuntimeError(
                "the native JPEG encoder is unavailable "
                f"({native.build_error or 'no jpeg entry points'}); the "
                "annotated engines write no JPEG through cv2")
        self.provider = image_provider
        self.out_dir = image_output_dir
        self._splice = self._shared()
        # per-writer fast-path caches (annotation is per-sample host work;
        # profiling shows ~25% of a steady pass is fs metadata + repeated
        # cache-key CRCs): created output dirs, and the prepared-frame
        # cache key memoized per live base array (identity-checked via
        # weakref, so provider evictions/reloads can never alias).
        self._dirs: set[str] = set()
        self._keys: dict[int, tuple] = {}

    def _write_bytes(self, rel_path: str, buf) -> None:
        full = os.path.join(self.out_dir, rel_path)
        d = os.path.dirname(full)
        if d not in self._dirs:
            mkdir_or_exist(d)
            self._dirs.add(d)
        fd = os.open(full, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
        try:
            view = memoryview(buf)
            while view:
                view = view[os.write(fd, view):]
        finally:
            os.close(fd)

    def _key_for(self, scene_id: str, image_id: str, base) -> tuple:
        ent = self._keys.get(id(base))
        if ent is not None and ent[0]() is base:
            return ent[1]
        key = self._cache_key(scene_id, image_id, base)
        if len(self._keys) > 512:  # id() reuse after gc: bound + refresh
            self._keys.clear()
        self._keys[id(base)] = (weakref.ref(base), key)
        return key

    @staticmethod
    def _text_extent(y: int, text_offset=(15, 15), font_scale=1.0,
                     thickness=2) -> tuple[int, int, int]:
        """(top_y, bottom_y, width) of a letter at baseline y+offset."""
        tw, th, baseline = _letter_metrics(font_scale, thickness)
        base_y = y + text_offset[1]
        return (base_y - th - thickness, base_y + baseline + thickness,
                tw + thickness)

    def write_dot(self, scene_id: str, image_id: str, xy, color,
                  rel_path: str, radius: int = 10) -> None:
        base = self.provider(scene_id, image_id)
        x, y = int(xy[0]), int(xy[1])
        span = (y - radius - 1, y + radius + 2,
                x - radius - 1, x + radius + 2)

        def draw(img, dy):
            draw_dot(img, (x, y - dy), color, radius)

        self._draw_and_save(scene_id, image_id, base, draw, [span],
                            rel_path)

    def write_lettered_dots(self, scene_id: str, image_id: str,
                            dots, rel_path: str, radius: int = 10,
                            text_offset=(15, 15)) -> None:
        """`dots`: iterable of (xy, letter, color); one output image."""
        dots = list(dots)
        base = self.provider(scene_id, image_id)
        spans = []
        for xy, letter, color in dots:
            x, y = int(xy[0]), int(xy[1])
            ty0, ty1, tw = self._text_extent(y, text_offset)
            spans.append((min(y - radius - 1, ty0 - 1),
                          max(y + radius + 2, ty1 + 1),
                          min(x - radius - 1, x + text_offset[0] - 1),
                          max(x + radius + 2,
                              x + text_offset[0] + tw + 2)))

        def draw(img, dy):
            for xy, letter, color in dots:
                draw_lettered_dot(img, (int(xy[0]), int(xy[1]) - dy),
                                  letter, color, radius,
                                  text_offset=text_offset)

        if len(dots) > 1 and self._splice is not None:
            # scattered dots: only the dirty MCU rows are copied into a
            # reusable per-thread scratch (the encoder never reads clean
            # rows), then a bit-granular column splice re-encodes only
            # the MCUs the dots/letters actually touch.
            img = self._scratch_like(base)
            h = base.shape[0]
            for y0, y1, _, _ in spans:
                lo = max(0, int(y0)) // 16 * 16
                hi = min((int(y1) + 15) // 16 * 16, h)
                if hi > lo:
                    img[lo:hi] = base[lo:hi]
            draw(img, 0)
            buf = self._splice.encode_cols(
                self._key_for(scene_id, image_id, base), base, img,
                spans)
            if buf is None:
                # native failure (evicted handle / short cap): the
                # scratch's clean rows are STALE — rebuild a fully-valid
                # frame
                img = base.copy()
                draw(img, 0)
                buf = self._encode_whole(img)
            self._write_bytes(rel_path, buf)
            return
        self._draw_and_save(scene_id, image_id, base, draw, spans,
                            rel_path)

    def _draw_and_save(self, scene_id, image_id, base, draw, spans,
                       rel_path) -> None:
        """Fast path: copy only the dirty MCU-row band, draw with the
        band's y offset, and column-splice-encode it (the native side
        only reads the dirty MCUs). The band shares its top/bottom edge
        with the image exactly when the annotation is clamped there, so
        cv2's clipping semantics are identical to a full-frame draw.
        Falls back to a whole-frame draw + encode when the spans miss the
        frame's rows or the splice returns nothing."""
        h = base.shape[0]
        y0 = min(s[0] for s in spans)
        y1 = max(s[1] for s in spans)
        r0 = max(0, int(y0)) // 16
        r1 = min((int(y1) + 15) // 16, (h + 15) // 16)
        lo, hi = r0 * 16, min(r1 * 16, h)
        if hi > lo:
            band = base[lo:hi].copy()
            draw(band, lo)
            buf = self._splice.encode_cols_band(
                self._key_for(scene_id, image_id, base), base, band,
                lo, spans)
            if buf is not None:
                self._write_bytes(rel_path, buf)
                return
        img = base.copy()
        draw(img, 0)
        self._save(scene_id, image_id, base, img, y0, y1, rel_path)

    def _scratch_like(self, base) -> np.ndarray:
        """Reusable per-thread full-frame buffer (contents stale outside
        the rows the caller refreshes — the splice encoder only reads
        dirty rows)."""
        import threading

        tls = getattr(self, "_tls", None)
        if tls is None:
            tls = self._tls = threading.local()
        buf = getattr(tls, "scratch", None)
        if buf is None or buf.shape != base.shape or buf.dtype != base.dtype:
            buf = tls.scratch = np.empty_like(base)
        return buf

    @staticmethod
    def _cache_key(scene_id, image_id, base) -> tuple:
        """Process-wide cache key: ids alone could collide across
        providers (tests build several synthetic stores with the same
        scene ids), so include the shape and a sampled-content CRC."""
        import zlib

        return (scene_id, image_id, base.shape,
                zlib.crc32(np.ascontiguousarray(base[::97]).tobytes()))

    def _save(self, scene_id, image_id, base, img, y0, y1,
              rel_path) -> None:
        buf = self._splice.encode(self._key_for(scene_id, image_id, base),
                                  base, img, y0, y1)
        if buf is None:  # output cap short: a whole-frame native encode
            buf = self._encode_whole(img)
        self._write_bytes(rel_path, buf)

    def _encode_whole(self, img: np.ndarray) -> bytes:
        """Native encode of a fully drawn frame, its buffer grown to the
        size the encoder asks for: the bytes a splice with room enough
        would have written (the splice invariant)."""
        from ..ingest.native import jpeg_encode

        buf = jpeg_encode(img, self._splice.quality)
        if buf is None:
            raise RuntimeError(
                f"the native JPEG encoder refused a {img.shape} frame")
        return buf

    def close(self) -> None:
        # the prepared-frame cache is process-wide (see _shared) — it
        # outlives individual writers on purpose; nothing to free here.
        pass


class AnnotationPool:
    """Parallel decode+draw+encode for the annotated engines.

    The dot variants are annotation-bound (bench: ~3 ms cv2 JPEG encode
    per 480x640 sample); cv2 releases the GIL during decode/encode, so a
    thread pool scales them near-linearly with cores. Engines compute
    every rng-dependent value (colors, coordinates, paths) synchronously
    in row order — the submitted closure only does image work — so output
    bytes are identical to inline execution. On a single-core host
    (workers=1) it degrades to inline calls with zero overhead.
    """

    def __init__(self, workers: int | None = None):
        if workers is None:
            # at least 4 even on a single-core host: the annotated path
            # is disk-write bound (~0.3 ms per 100 KB JPEG on this VM)
            # and both file writes and the native splice encode (ctypes)
            # release the GIL, so extra threads overlap I/O + encode
            # with the next samples' python (measured 1.6K/s vs 1.2K
            # inline for depth dot on ONE core; byte-identity under any
            # worker count is keyed-ordering-guaranteed + test-asserted)
            workers = max(4, os.cpu_count() or 1)
        self._executor = None
        self._futures: list = []
        self._by_key: dict = {}
        if workers > 1:
            from concurrent.futures import ThreadPoolExecutor

            self._executor = ThreadPoolExecutor(max_workers=workers)

    def submit(self, fn, key=None) -> None:
        """Run fn on the pool. Tasks sharing a key (e.g. the output image
        path) execute in submission order, so duplicate targets behave
        exactly like the inline engines (last write wins) instead of
        racing concurrent encoders on one file."""
        if self._executor is None:
            fn()
            return
        if key is None:
            self._futures.append(self._executor.submit(fn))
            return
        prev = self._by_key.get(key)

        def chained(prev=prev, fn=fn):
            if prev is not None:
                prev.result()
            fn()

        fut = self._executor.submit(chained)
        self._by_key[key] = fut
        self._futures.append(fut)

    def close(self) -> None:
        """Wait for every pending write; re-raises the first failure."""
        if self._executor is not None:
            for f in self._futures:
                f.result()
            self._executor.shutdown()
            self._futures.clear()
            self._by_key.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
