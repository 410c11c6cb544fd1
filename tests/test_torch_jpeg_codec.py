"""The port's native JPEG codec (multi_spatialmllm_tpu_torch/ingest/jpeg.py)
against OpenCV: `imencode` byte-equal to `cv2.imencode(".jpg", ...)` at
cv2's default and at qualities 50-100, `imdecode` pixel-equal to
`cv2.imdecode(..., IMREAD_UNCHANGED)` over noise and smooth frames from
1 x 1 to 512 x 512 and over cv2's 4:2:2, 4:4:4, greyscale and
restart-marker encodes, a hypothesis case over random sizes, refusals
named, mutated files decoded or refused, and the stored golden digests
(what the card is held to) equal to a fresh run of cv2 and to the
codec."""

import base64
import importlib.util
import json
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from multi_spatialmllm_tpu_torch.ingest import jpeg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "gen_jpeg_golden", os.path.join(REPO, "scripts", "gen_jpeg_golden.py"))
golden = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(golden)

SIZES = golden.SIZES
QUALITIES = golden.QUALITIES


def _cv2_encode(img, q=None, extra=()):
    params = [] if q is None else [cv2.IMWRITE_JPEG_QUALITY, q]
    ok, buf = cv2.imencode(".jpg", img, params + list(extra))
    assert ok
    return buf.tobytes()


def _cv2_decode(data):
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)


@pytest.mark.parametrize("kind", golden.KINDS)
@pytest.mark.parametrize("hw", SIZES, ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_encode_and_decode_equal_cv2(hw, kind):
    img = golden.frame(kind, *hw, seed=hw[0] * 7 + hw[1])
    for q in QUALITIES:
        want = _cv2_encode(img, q)
        got = jpeg.imencode(img) if q is None else jpeg.imencode(img, q)
        assert got == want, (q, len(got), len(want))
        dec = jpeg.imdecode(want)
        assert dec.dtype == np.uint8 and dec.shape == img.shape
        np.testing.assert_array_equal(dec, _cv2_decode(want), err_msg=str(q))
        assert jpeg.jpeg_size(want) == hw


@pytest.mark.parametrize("name,extra", [
    ("4:2:2", (cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
               cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422)),
    ("4:4:4", (cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
               cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444)),
    ("restart interval 2", (cv2.IMWRITE_JPEG_RST_INTERVAL, 2)),
    ("optimised Huffman tables", (cv2.IMWRITE_JPEG_OPTIMIZE, 1)),
    ("greyscale", None),
])
def test_decoder_takes_cv2s_other_encodes(name, extra):
    for hw in ((1, 1), (2, 3), (5, 4), (16, 16), (61, 97), (64, 96),
               (33, 17)):
        img = golden.frame("smooth", *hw, seed=3)
        if extra is None:
            data = _cv2_encode(cv2.cvtColor(img, cv2.COLOR_BGR2GRAY))
        else:
            data = _cv2_encode(img, extra=extra)
        want = _cv2_decode(data)
        got = jpeg.imdecode(data)
        assert got.shape == want.shape, (name, hw)
        np.testing.assert_array_equal(got, want, err_msg=f"{name} {hw}")
        assert jpeg.jpeg_size(data) == hw


@settings(max_examples=25, deadline=None, database=None)
@given(h=st.integers(1, 80), w=st.integers(1, 80),
       q=st.integers(0, 100), seed=st.integers(0, 2**31 - 1),
       smooth=st.booleans())
def test_random_sizes_equal_cv2(h, w, q, seed, smooth):
    img = golden.frame("smooth" if smooth else "noise", h, w, seed)
    want = _cv2_encode(img, q)
    assert jpeg.imencode(img, q) == want
    np.testing.assert_array_equal(jpeg.imdecode(want), _cv2_decode(want))


def test_imwrite_writes_cv2s_bytes(tmp_path):
    img = golden.frame("noise", 61, 97, seed=5)
    jpeg.imwrite(str(tmp_path / "a.jpg"), img)
    cv2.imwrite(str(tmp_path / "b.jpg"), img)
    assert (tmp_path / "a.jpg").read_bytes() == \
        (tmp_path / "b.jpg").read_bytes()


@pytest.mark.parametrize("what,make", [
    ("progressive", lambda img: _cv2_encode(
        img, extra=(cv2.IMWRITE_JPEG_PROGRESSIVE, 1))),
    ("not a JPEG", lambda img: b"\x89PNG\r\n\x1a\n" + bytes(32)),
    ("12-bit", lambda img: _twelve_bit(_cv2_encode(img))),
    ("arithmetic-coded", lambda img: _sof(_cv2_encode(img), 0xC9)),
    ("lossless", lambda img: _sof(_cv2_encode(img), 0xC3)),
    ("bad DC Huffman table", lambda img: _dc_symbol(_cv2_encode(img), 0x20)),
])
def test_refusals_name_what_they_met(what, make):
    data = make(golden.frame("smooth", 16, 16, seed=1))
    with pytest.raises(ValueError, match=what):
        jpeg.imdecode(data)


def _sof(data: bytes, marker: int) -> bytes:
    i = data.index(b"\xff\xc0")
    return data[:i + 1] + bytes([marker]) + data[i + 2:]


def _dc_symbol(data: bytes, value: int) -> bytes:
    i = data.index(b"\xff\xc4") + 5 + 16   # the first DC table's first value
    return data[:i] + bytes([value]) + data[i + 1:]


def test_mutated_files_decode_or_raise():
    """Bytes changed, cut or dropped anywhere: each file decodes or raises
    ValueError (the decoder's reads and writes stay in bounds)."""
    rng = np.random.default_rng(0)
    img = golden.frame("smooth", 61, 97, seed=4)
    seeds = [_cv2_encode(img), _cv2_encode(img, extra=(
        cv2.IMWRITE_JPEG_RST_INTERVAL, 1))]
    for k in range(2000):
        b = bytearray(seeds[k % 2])
        for _ in range(int(rng.integers(1, 6))):
            i = int(rng.integers(len(b)))
            op = int(rng.integers(3))
            if op == 0:
                b[i] = int(rng.integers(256))
            elif op == 1:
                del b[i:i + int(rng.integers(1, 8))]
            else:
                del b[max(i, 2):]
        try:
            out = jpeg.imdecode(bytes(b))
        except ValueError:
            continue
        assert out.dtype == np.uint8 and out.ndim in (2, 3)


def _twelve_bit(data: bytes) -> bytes:
    i = data.index(b"\xff\xc0") + 4   # the SOF's precision byte
    return data[:i] + b"\x0c" + data[i + 1:]


def test_encoder_refuses_other_layouts():
    with pytest.raises(ValueError, match="uint8"):
        jpeg.imencode(np.zeros((4, 4), np.uint8))
    with pytest.raises(ValueError, match="uint8"):
        jpeg.imencode(np.zeros((4, 4, 3), np.float32))
    with pytest.raises(ValueError, match="cannot hold"):
        jpeg.imencode(np.zeros((0, 4, 3), np.uint8))


def test_golden_file_is_what_cv2_gives_now():
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "gen_jpeg_golden.py"),
         "--check"], capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_codec_matches_every_golden_digest():
    """What the card checks, here: the codec's bytes and pixels against the
    stored digests, with no cv2 call."""
    with open(golden.OUT) as f:
        stored = json.load(f)
    assert len(stored["cases"]) == (len(SIZES) * len(golden.KINDS)
                                    * len(QUALITIES))
    for c in stored["cases"]:
        img = golden.frame(c["kind"], c["h"], c["w"], c["seed"])
        data = (jpeg.imencode(img) if c["quality"] is None
                else jpeg.imencode(img, c["quality"]))
        assert golden.sha(data) == c["encode"], c
        assert golden.pixels_sha(jpeg.imdecode(data)) == c["decode"], c
    for o in stored["other"]:
        dec = jpeg.imdecode(base64.b64decode(o["jpeg"]))
        assert golden.pixels_sha(dec) == o["decode"], o["name"]
