"""The port's PNG codec (ingest/png.py) against cv2: `imencode_png` gives
the bytes of `cv2.imencode(".png")` and `imread_png` the pixels of
`cv2.imread(path, -1)` and `cv2.imread(path)`, on cv2's files and on files
written here with every filter type; `ingest/image.py` applies the EXIF
orientation of JPEG and PNG files as cv2's IMREAD_COLOR does."""

import struct
import zlib

import cv2
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from multi_spatialmllm_tpu_torch.ingest import image as TI
from multi_spatialmllm_tpu_torch.ingest import png as TP

SIZES = [(1, 1), (1, 7), (7, 1), (2, 3), (17, 33), (48, 64), (90, 91),
         (120, 160), (240, 320), (480, 640)]
CHANNELS = [1, 3, 4]
DTYPES = [np.uint8, np.uint16]


def _image(dtype, cn, hw, kind, seed=0):
    h, w = hw
    shape = (h, w) if cn == 1 else (h, w, cn)
    top = np.iinfo(dtype).max
    if kind == "noise":
        return np.random.default_rng(seed).integers(
            0, top, size=shape, dtype=dtype, endpoint=True)
    yy, xx = np.mgrid[0:h, 0:w]
    v = (yy * 3 + xx * 5) % top
    if cn > 1:
        v = np.stack([(v + 40 * c) % top for c in range(cn)], -1)
    return v.astype(dtype)


def _cv2_bytes(img):
    ok, buf = cv2.imencode(".png", img)
    assert ok
    return buf.tobytes()


@pytest.mark.parametrize("kind", ["noise", "smooth"])
@pytest.mark.parametrize("hw", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("cn", CHANNELS)
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.__name__)
def test_encode_equals_cv2(dtype, cn, hw, kind):
    img = _image(dtype, cn, hw, kind)
    assert TP.imencode_png(img) == _cv2_bytes(img)


def test_encode_window_and_idat_chunks_follow_libpng():
    """Around libpng's 16 KiB window threshold (the zlib header's window
    is trimmed to the data), and at sizes cut into several 8,192-byte IDAT
    chunks, the bytes are cv2's."""
    for w in range(60, 70):                   # 2 * (w*2+1) rows near 16 KiB
        for h in (1, 2, 63, 64, 65):
            img = _image(np.uint16, 1, (h, w), "noise", seed=w * 100 + h)
            assert TP.imencode_png(img) == _cv2_bytes(img), (h, w)
    img = _image(np.uint8, 3, (968, 1296), "noise")
    data = TP.imencode_png(img)
    assert data == _cv2_bytes(img)
    assert data.count(b"IDAT") > 100


@settings(max_examples=25, deadline=None)
@given(h=st.integers(1, 70), w=st.integers(1, 70),
       cn=st.sampled_from(CHANNELS), wide=st.booleans(),
       seed=st.integers(0, 2**31), smooth=st.booleans())
def test_encode_equals_cv2_hypothesis(h, w, cn, wide, seed, smooth):
    img = _image(np.uint16 if wide else np.uint8, cn, (h, w),
                 "smooth" if smooth else "noise", seed)
    assert TP.imencode_png(img) == _cv2_bytes(img)


@pytest.mark.parametrize("flags", [-1, 1], ids=["unchanged", "color"])
@pytest.mark.parametrize("cn", CHANNELS)
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.__name__)
def test_read_cv2_files_equals_cv2(tmp_path, dtype, cn, flags):
    for hw in ((1, 1), (5, 1), (37, 53), (480, 640)):
        img = _image(dtype, cn, hw, "noise", seed=hw[0])
        path = str(tmp_path / "x.png")
        cv2.imwrite(path, img)
        want = cv2.imread(path, flags)
        got = TP.imread_png(path, flags)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            TP.imread_png(TP.imencode_png(img), flags), want)


def _filter_rows(raw: np.ndarray, bpp: int, kinds) -> bytes:
    """PNG's five filters applied by hand, row y with kinds[y]."""
    out = []
    prev = np.zeros(raw.shape[1], np.int64)
    for y, kind in enumerate(kinds):
        cur = raw[y].astype(np.int64)
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if kind == 0:
            f = cur
        elif kind == 1:
            f = cur - left
        elif kind == 2:
            f = cur - prev
        elif kind == 3:
            f = cur - (left + prev) // 2
        else:
            p = left + prev - ul
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, ul))
            f = cur - pred
        out.append(bytes([kind]) + (f & 0xFF).astype(np.uint8).tobytes())
        prev = cur
    return b"".join(out)


def _png(w, h, depth, ctype, payload, idat_size=None, extra=b""):
    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    z = zlib.compress(payload)
    n = idat_size or len(z)
    return (TP.SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0,
                                         0, 0))
            + extra
            + b"".join(chunk(b"IDAT", z[i:i + n])
                       for i in range(0, len(z), n))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("ctype,cn", [(0, 1), (2, 3), (4, 2), (6, 4)],
                         ids=["grey", "rgb", "grey_alpha", "rgba"])
@pytest.mark.parametrize("depth", [8, 16])
def test_read_every_filter_type_equals_cv2(tmp_path, ctype, cn, depth):
    """Files cv2 never writes: rows filtered None, Sub, Up, Average and
    Paeth in turn, the stream cut into 97-byte IDAT chunks."""
    rng = np.random.default_rng(depth + ctype)
    h, w = 23, 19
    dt = np.dtype(">u2") if depth == 16 else np.dtype(np.uint8)
    px = rng.integers(0, 2**depth, size=(h, w * cn)).astype(dt)
    raw = px.view(np.uint8).reshape(h, -1)
    kinds = [y % 5 for y in range(h)]
    path = str(tmp_path / "f.png")
    with open(path, "wb") as f:
        f.write(_png(w, h, depth, ctype,
                     _filter_rows(raw, cn * depth // 8, kinds), 97))
    for flags in (-1, 1):
        want = cv2.imread(path, flags)
        got = TP.imread_png(path, flags)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_unsupported_files_raise():
    raw = bytes(1 + 4) * 4
    for ctype, depth, extra, what in (
            (3, 8, b"", "colour type 3"), (0, 4, b"", "bit depth 4")):
        with pytest.raises(ValueError, match=what):
            TP.imread_png(_png(4, 4, depth, ctype, raw, extra=extra))
    data = bytearray(_png(4, 4, 8, 0, raw))
    data[28] = 1                                    # interlace method
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29]))
                              & 0xFFFFFFFF)
    with pytest.raises(ValueError, match="interlaced"):
        TP.imread_png(bytes(data))
    data = bytearray(_png(4, 4, 8, 0, raw))
    data[20] ^= 1                                   # IHDR's CRC no longer
    with pytest.raises(ValueError, match="CRC"):
        TP.imread_png(bytes(data))
    with pytest.raises(ValueError):
        TP.imencode_png(np.zeros((4, 4), np.float32))
    with pytest.raises(ValueError):
        TP.imencode_png(np.zeros((4, 4, 2), np.uint8))


def _exif(orientation):
    return (b"II*\x00" + struct.pack("<I", 8) + struct.pack("<H", 1)
            + struct.pack("<HHIHH", 0x0112, 3, 1, orientation, 0)
            + struct.pack("<I", 0))


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_as_cv2(tmp_path, orientation):
    """cv2's IMREAD_COLOR applies a JPEG's APP1 and a PNG's eXIf
    orientation (UNCHANGED does not); image.py does the same, and
    `color_size` reads the oriented size from the headers."""
    rng = np.random.default_rng(orientation)
    img = rng.integers(0, 255, (16, 24, 3), dtype=np.uint8)
    jpg = cv2.imencode(".jpg", img)[1].tobytes()
    app1 = b"Exif\x00\x00" + _exif(orientation)
    jpg = jpg[:2] + b"\xff\xe1" + struct.pack(">H", len(app1) + 2) + app1 \
        + jpg[2:]
    body = _exif(orientation)
    chunk = (struct.pack(">I", len(body)) + b"eXIf" + body
             + struct.pack(">I", zlib.crc32(b"eXIf" + body) & 0xFFFFFFFF))
    png = TP.imencode_png(img)
    png = png[:33] + chunk + png[33:]
    for name, data in (("x.jpg", jpg), ("x.png", png)):
        path = str(tmp_path / name)
        with open(path, "wb") as f:
            f.write(data)
        for flags in (1, -1):
            want = cv2.imread(path, flags)
            got = TI.imread(path, flags)
            assert got.shape == want.shape, (name, flags)
            np.testing.assert_array_equal(got, want)
        assert TI.color_size(data) == cv2.imread(path).shape[:2]


def test_grey_jpeg_reads_as_three_channels(tmp_path):
    g = np.random.default_rng(5).integers(0, 255, (33, 47), dtype=np.uint8)
    path = str(tmp_path / "g.jpg")
    cv2.imwrite(path, g)
    for flags in (1, -1):
        want = cv2.imread(path, flags)
        got = TI.imread(path, flags)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="neither"):
        TI.imdecode(b"GIF89a....")
