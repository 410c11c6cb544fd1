"""Generate multi_spatialmllm_tpu_torch/engines/_glyphs.py: the glyphs that
the annotated ("dot") QA engines stamp into frames, rendered once by OpenCV
and stored as data.

The engines draw few glyphs, thousands of times a second, by stamping a
mask (engines/annotate.py): a filled circle of radius 10, and the letters
"A"-"D" in FONT_HERSHEY_SIMPLEX at scale 1.0 and thickness 2 (the
depth-comparison dot engine and the correspondence dot-to-multichoice
engine letter their dots; depth_perception.py:582,812,
visual_correspondence.py:356,474). OpenCV's rasterisation of a glyph does
not depend on where it is drawn, so one render characterises every draw.
The port's annotation layer reads these stored renders and never imports
cv2, which the card's installation lacks.

For each glyph the module stores what cv2 gives on a padded zero canvas:
  * the circle: the canvas of `cv2.circle(canvas, (pad, pad), r, 255, -1)`
    as 0/255 bytes, and its pad (r + 2);
  * a letter: the coverage canvas of `cv2.putText(..., color=255)` (255 is
    a solid pixel, 1-254 an edge pixel's blend weight; the full and
    partial masks are `cov == 255` and `0 < cov < 255`), the putText org
    inside the canvas, and `cv2.getTextSize` ((width, height), baseline).

Run it with the cv2 the module names in its header to regenerate:

    python scripts/gen_glyphs.py            # write the module
    python scripts/gen_glyphs.py --check    # exit 1 if it differs
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "multi_spatialmllm_tpu_torch", "engines",
                   "_glyphs.py")
CIRCLE_RADII = (10,)
LETTERS = ("A", "B", "C", "D")
FONTS = ((1.0, 2),)   # (font_scale, thickness) of FONT_HERSHEY_SIMPLEX


def _rows(canvas: np.ndarray) -> tuple:
    return tuple(bytes(r).hex() for r in canvas.astype(np.uint8))


def render_circle(cv2, radius: int):
    pad = radius + 2
    canvas = np.zeros((2 * pad + 1, 2 * pad + 1), np.uint8)
    cv2.circle(canvas, (pad, pad), radius, 255, -1)
    return pad, canvas


def render_letter(cv2, letter: str, font_scale: float, thickness: int):
    (tw, th), baseline = cv2.getTextSize(
        letter, cv2.FONT_HERSHEY_SIMPLEX, font_scale, thickness)
    pad = thickness + 4
    canvas = np.zeros((th + baseline + 2 * pad, tw + 2 * pad), np.uint8)
    cv2.putText(canvas, letter, (pad, pad + th), cv2.FONT_HERSHEY_SIMPLEX,
                font_scale, 255, thickness)
    return ((tw, th), baseline), (pad, pad + th), canvas


def _check_unclipped(canvas: np.ndarray, what) -> None:
    if (canvas[0].any() or canvas[-1].any() or canvas[:, 0].any()
            or canvas[:, -1].any()):
        raise SystemExit(f"{what} touches its canvas edge")


def module_text(cv2) -> str:
    lines = [
        '"""Glyphs for the annotated QA engines, rendered by OpenCV '
        f'{cv2.__version__}',
        "with scripts/gen_glyphs.py (which says what each entry holds). "
        "Generated:",
        'do not edit; rerun the script instead."""',
        "",
        f'CV2_VERSION = "{cv2.__version__}"',
        "",
        "# radius -> (pad, rows of the 0/255 canvas as hex)",
        "CIRCLES = {",
    ]
    for r in CIRCLE_RADII:
        pad, canvas = render_circle(cv2, r)
        _check_unclipped(canvas, f"circle {r}")
        lines.append(f"    {r}: ({pad}, (")
        lines += [f'        "{h}",' for h in _rows(canvas)]
        lines.append("    )),")
    lines += [
        "}",
        "",
        "# (letter, font_scale, thickness) -> (getTextSize, org in the",
        "# canvas, rows of the 0..255 coverage canvas as hex)",
        "LETTERS = {",
    ]
    for scale, thick in FONTS:
        for letter in LETTERS:
            size, org, canvas = render_letter(cv2, letter, scale, thick)
            _check_unclipped(canvas, f"letter {letter}")
            lines.append(f'    ("{letter}", {scale!r}, {thick}): '
                         f"({size!r}, {org!r}, (")
            lines += [f'        "{h}",' for h in _rows(canvas)]
            lines.append("    )),")
    lines += ["}", ""]
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help="compare the stored module with a fresh render")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    import cv2

    text = module_text(cv2)
    if args.check:
        with open(args.out) as f:
            same = f.read() == text
        print("stored glyphs equal a fresh render" if same
              else "stored glyphs differ from a fresh render")
        return 0 if same else 1
    with open(args.out, "w") as f:
        f.write(text)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
