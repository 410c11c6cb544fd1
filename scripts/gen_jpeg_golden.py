"""Generate multi_spatialmllm_tpu_torch/ingest/_jpeg_golden.json: SHA-256
digests of what OpenCV gives for seeded frames, so that a machine without
cv2 can show that the native codec (ingest/jpeg.py) equals it.

For each case of the grid (the sizes 1x1 to 512x512, a noise and a smooth
frame each, cv2's default quality and 50, 75, 90, 95 and 100) the file
holds the digest of `cv2.imencode(".jpg", frame, [IMWRITE_JPEG_QUALITY,
q])` and of `cv2.imdecode(those bytes, IMREAD_UNCHANGED)`'s pixels. It also
stores, whole, cv2's 4:2:2, 4:4:4 and greyscale encodes of a 61 x 97 frame
with the digests of their decodes, which the native encoder does not make.
`frame(kind, h, w, seed)` draws the frames with numpy alone; the smoke run
on the card imports it from here.

Run it with the cv2 the file names to regenerate:

    python scripts/gen_jpeg_golden.py            # write the file
    python scripts/gen_jpeg_golden.py --check    # exit 1 if it differs
"""

from __future__ import annotations

import argparse
import base64
import hashlib
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "multi_spatialmllm_tpu_torch", "ingest",
                   "_jpeg_golden.json")
SIZES = ((1, 1), (8, 8), (16, 16), (61, 97), (64, 96), (360, 640),
         (512, 512))
KINDS = ("noise", "smooth")
QUALITIES = (None, 50, 75, 90, 95, 100)   # None: cv2's default
OTHER_HW = (61, 97)


def frame(kind: str, h: int, w: int, seed: int) -> np.ndarray:
    """A seeded uint8 [h, w, 3] BGR frame: uniform noise, or smooth
    gradients with a little noise."""
    rng = np.random.default_rng(seed)
    noise = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    if kind == "noise":
        return noise
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1),
                     (xx + yy) * 255 // max(h + w - 2, 1)], -1)
    return np.clip(base + noise.astype(np.int64) // 32 - 4, 0,
                   255).astype(np.uint8)


def sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def pixels_sha(img: np.ndarray) -> str:
    return sha(f"{img.shape}".encode() + np.ascontiguousarray(img).tobytes())


def cases():
    """(kind, h, w, seed, quality) over the grid."""
    for i, (h, w) in enumerate(SIZES):
        for j, kind in enumerate(KINDS):
            for q in QUALITIES:
                yield kind, h, w, 1000 + 10 * i + j, q


def golden(cv2) -> dict:
    out = {"cv2": cv2.__version__,
           "jpeg": [ln.split(":", 1)[1].strip()
                    for ln in cv2.getBuildInformation().splitlines()
                    if ln.strip().startswith("JPEG:")][0],
           "cases": [], "other": []}
    for kind, h, w, seed, q in cases():
        img = frame(kind, h, w, seed)
        params = [] if q is None else [cv2.IMWRITE_JPEG_QUALITY, q]
        ok, buf = cv2.imencode(".jpg", img, params)
        if not ok:
            raise RuntimeError(f"cv2.imencode failed: {kind} {h}x{w} q{q}")
        dec = cv2.imdecode(buf, cv2.IMREAD_UNCHANGED)
        out["cases"].append({"kind": kind, "h": h, "w": w, "seed": seed,
                             "quality": q, "encode": sha(buf.tobytes()),
                             "decode": pixels_sha(dec)})
    h, w = OTHER_HW
    img = frame("smooth", h, w, 7)
    for name, src, params in (
            ("4:2:2", img, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                            cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422]),
            ("4:4:4", img, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                            cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444]),
            ("grey", cv2.cvtColor(img, cv2.COLOR_BGR2GRAY), [])):
        ok, buf = cv2.imencode(".jpg", src, params)
        dec = cv2.imdecode(buf, cv2.IMREAD_UNCHANGED)
        out["other"].append({"name": name,
                             "jpeg": base64.b64encode(buf.tobytes()).decode(),
                             "decode": pixels_sha(dec)})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help="compare the stored file with a fresh run of cv2")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    import cv2

    text = json.dumps(golden(cv2), indent=1) + "\n"
    if args.check:
        with open(args.out) as f:
            same = f.read() == text
        print("stored digests equal cv2's" if same
              else "stored digests differ from cv2's")
        return 0 if same else 1
    with open(args.out, "w") as f:
        f.write(text)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
