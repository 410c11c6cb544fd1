"""The port's annotation layer (multi_spatialmllm_tpu_torch/engines/
annotate.py) without cv2: each stored glyph equals what cv2 renders now
(through the JAX module's own renderers), the dot and lettered-dot stamps
are pixel-equal to the JAX module's on random placements and on
placements clipped at every edge, a glyph that is not stored raises, a
writer without the native encoder raises rather than writing through cv2,
and a splice whose output cap is short is redone natively with the bytes
a splice with room writes. Tolerance: exact (pixels, bytes)."""

import numpy as np
import pytest

from multi_spatialmllm_tpu.engines import annotate as JA
from multi_spatialmllm_tpu_torch.engines import _glyphs
from multi_spatialmllm_tpu_torch.engines import annotate as TA
from multi_spatialmllm_tpu_torch.ingest import native as TN

LETTERS = sorted(k for k in _glyphs.LETTERS)


def test_glyph_module_names_its_generator_and_cv2():
    assert "scripts/gen_glyphs.py" in _glyphs.__doc__
    assert f"OpenCV {_glyphs.CV2_VERSION}" in _glyphs.__doc__
    assert sorted(_glyphs.CIRCLES) == [10]
    assert LETTERS == [(c, 1.0, 2) for c in "ABCD"]


@pytest.mark.parametrize("radius", sorted(_glyphs.CIRCLES))
def test_stored_circle_equals_cv2(radius):
    pytest.importorskip("cv2")
    want, wpad = JA._circle_mask(radius)
    got, gpad = TA._circle_mask(radius)
    assert gpad == wpad and got.dtype == want.dtype == bool
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("key", LETTERS)
def test_stored_letter_equals_cv2(key):
    pytest.importorskip("cv2")
    want = JA._letter_glyph(*key)
    got = TA._letter_glyph(*key)
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[3:] == want[3:]
    assert TA._letter_metrics(*key[1:]) == JA._letter_metrics(*key[1:])


def test_stored_module_equals_a_fresh_render(tmp_path):
    """The generator, run now, writes the module that is stored."""
    cv2 = pytest.importorskip("cv2")
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", "gen_glyphs.py")
    spec = importlib.util.spec_from_file_location("gen_glyphs", path)
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    assert cv2.__version__ == _glyphs.CV2_VERSION
    with open(_glyphs.__file__) as f:
        assert f.read() == gen.module_text(cv2)


@pytest.mark.parametrize("call,match", [
    (lambda: TA._circle_mask(7), "circle radius 7"),
    (lambda: TA._letter_glyph("E", 1.0, 2), "letter"),
    (lambda: TA._letter_glyph("A", 0.5, 2), "letter"),
    (lambda: TA._letter_metrics(1.0, 3), "letter"),
])
def test_unstored_glyph_raises(call, match):
    with pytest.raises(KeyError, match=match) as e:
        call()
    assert "stored" in str(e.value) and "gen_glyphs.py" in str(e.value)


def _placements(h, w, rng, n=40):
    """Random placements plus ones clipped at each edge and corner, and
    some wholly outside the frame."""
    out = [(int(rng.integers(0, w)), int(rng.integers(0, h)))
           for _ in range(n)]
    for x in (-25, -9, 0, 3, w // 2, w - 4, w - 1, w + 9, w + 30):
        for y in (-40, -9, 0, 2, h // 2, h - 3, h - 1, h + 9, h + 30):
            out.append((x, y))
    return out


def test_draw_dot_pixel_equal():
    pytest.importorskip("cv2")
    rng = np.random.default_rng(0)
    h, w = 96, 128
    base = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    for xy in _placements(h, w, rng):
        color = tuple(int(c) for c in rng.integers(0, 256, 3))
        a, b = base.copy(), base.copy()
        JA.draw_dot(a, xy, color)
        TA.draw_dot(b, xy, color)
        np.testing.assert_array_equal(b, a, err_msg=str(xy))


def test_draw_lettered_dot_pixel_equal():
    pytest.importorskip("cv2")
    rng = np.random.default_rng(1)
    h, w = 96, 128
    base = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    for i, xy in enumerate(_placements(h, w, rng)):
        letter = "ABCD"[i % 4]
        color = tuple(int(c) for c in rng.integers(0, 256, 3))
        a, b = base.copy(), base.copy()
        JA.draw_lettered_dot(a, xy, letter, color)
        TA.draw_lettered_dot(b, xy, letter, color)
        np.testing.assert_array_equal(b, a, err_msg=f"{letter} {xy}")


def test_glyphs_load_without_cv2(monkeypatch):
    """With cv2 unimportable the stamps still draw (they read stored
    data): cleared caches are refilled from engines/_glyphs.py."""
    import sys

    monkeypatch.setitem(sys.modules, "cv2", None)
    for fn in (TA._circle_mask, TA._letter_glyph, TA._letter_metrics):
        fn.cache_clear()
    img = np.zeros((64, 64, 3), np.uint8)
    TA.draw_lettered_dot(img, (20, 20), "C", (10, 200, 30))
    assert img.any()


def test_writer_without_the_native_encoder_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(TN, "jpeg_available", lambda: False)
    monkeypatch.setattr(TN, "build_error", "build.sh exit 1: no g++")
    provider = TA.SyntheticImageProvider((96, 128))
    with pytest.raises(RuntimeError, match="no g\\+\\+.*cv2"):
        TA.AnnotatedJpegWriter(provider, str(tmp_path))
    assert not any(tmp_path.iterdir())


def _write_all(out_dir):
    """One of each writer call: a dot, a one-letter dot (band splice) and
    several lettered dots (scratch splice), some clipped at an edge."""
    provider = TA.SyntheticImageProvider((96, 128))
    w = TA.AnnotatedJpegWriter(provider, str(out_dir))
    w.write_dot("s0", "00001", (30, 40), (255, 0, 0), "a/dot.jpg")
    w.write_dot("s0", "00001", (126, 95), (0, 255, 0), "a/edge.jpg")
    w.write_lettered_dots("s0", "00002", [((60, 20), "A", (0, 0, 255))],
                          "b/one.jpg")
    w.write_lettered_dots(
        "s0", "00002",
        [((10, 10), "A", (1, 2, 3)), ((100, 50), "B", (200, 100, 0)),
         ((40, 90), "C", (9, 99, 199)), ((127, 0), "D", (255, 255, 0))],
        "b/four.jpg")
    return {p.relative_to(out_dir): p.read_bytes()
            for p in out_dir.rglob("*.jpg")}


class _ShortCap:
    """The native library, with the first output buffer of every encode
    cut to 64 bytes: the row splice's always, a full encode's when it is
    the default size (its retry at the size the encoder asks for passes)."""

    def __init__(self, real):
        self.real = real

    def __getattr__(self, name):
        return getattr(self.real, name)

    def msm_jpeg_encode_spliced(self, hdl, img, y0, y1, out, cap):
        return self.real.msm_jpeg_encode_spliced(hdl, img, y0, y1, out, 64)

    def msm_jpeg_encode(self, img, h, w, quality, out, cap):
        if cap == h * w * 4 + (1 << 16):
            cap = 64
        return self.real.msm_jpeg_encode(img, h, w, quality, out, cap)


def test_short_cap_is_retried_natively(monkeypatch, tmp_path):
    """Every splice entry point handed a buffer too short returns nothing;
    the writer then encodes the drawn frame whole through the native
    encoder, whose buffer grows to the size it reports. The files equal
    those of a run with room enough."""
    want = _write_all(tmp_path / "room")
    assert len(want) == 4

    small = np.empty(64, np.uint8)
    monkeypatch.setattr(TN.JpegSpliceCache, "_out_buf",
                        lambda self, cap: small)
    calls = []
    encode = TN.jpeg_encode
    monkeypatch.setattr(TN, "jpeg_encode", lambda img, q=95: calls.append(
        img.shape) or encode(img, q))
    monkeypatch.setattr(TN, "_load", lambda real=TN._load(): _ShortCap(real))
    got = _write_all(tmp_path / "short")
    assert got == want
    assert len(calls) == 4      # every file went through the retry


def test_jpeg_encode_grows_a_short_cap(monkeypatch):
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
    full = TN.jpeg_encode(img)
    monkeypatch.setattr(TN, "_load", lambda real=TN._load(): _ShortCap(real))
    assert full and TN.jpeg_encode(img) == full
