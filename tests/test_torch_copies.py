"""The port's copies of the JAX package's host code: each byte-identical
copy equals its original, and each edited copy differs from its original
only in the lines named here (line numbers of the original, with why)."""

import difflib
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX, PORT = "multi_spatialmllm_tpu", "multi_spatialmllm_tpu_torch"

IDENTICAL = [
    "core/io.py",
    "stages/manifest.py",
    "utils/logging.py",
    "engines/__init__.py",
    "engines/base.py",
    "engines/sampling.py",
    "engines/templates/__init__.py",
    "engines/templates/camera_movement.py",
    "engines/templates/depth.py",
    "engines/templates/correspondence.py",
    "engines/templates/object_perception.py",
    "engines/templates/object_movement.py",
    "engines/depth_perception.py",
    "engines/visual_correspondence.py",
    "engines/object_perception.py",
    "engines/fast_jsonl.py",
    "models/eval_harness.py",
    "ingest/__init__.py",
    "ingest/tapvid.py",
    "ingest/ply.py",
    "ingest/scannet_export.py",
    "ingest/native/src/jsonl_emit.cpp",
    "ingest/native/src/msm_native.cpp",
    "ingest/native/src/jpeg_encode.cpp",
    "ingest/native/src/ryu_tables.h",
]

# original line ranges (inclusive) an edited copy may change
EDITED = {
    "core/rng.py": [
        (1, 10),     # the module docstring names the copy
        (35, 43),    # jax_key, which imports jax, is left out
    ],
    "ingest/native/__init__.py": [
        (1, 7),      # the module docstring: the inflate has no fallback
        (12, 16),    # imports for the digest and the temporary file (zlib
                     # is no longer needed: nothing falls back to it)
        (19, 38),    # the library builds at first use under a hashed name
        (88, 91),    # zlib_inflate raises where the library cannot be
                     # built (with build_error), instead of Python's zlib
        (103, 103),  # ... and where the native inflate rejects the stream
        (111, 115),  # zlib_inflate_batch raises where the library cannot
                     # be built
        (141, 144),  # ... and names the stream the native inflate
                     # rejected, instead of a per-stream fallback
        (170, 183),  # jpeg_encode retries a short cap at the size asked
    ],
    "core/scene.py": [
        (218, 218),  # save_reference_layout: the port's JPEG and PNG
        (237, 239),  # writers (cv2.imwrite's bytes) instead of cv2
        (336, 336),  # load_reference_scene: the PNG reader and the frame
        (348, 352),  # size from the JPEG's headers instead of cv2.imread
    ],
    "ingest/sens.py": [
        (66, 71),    # color_bgr: ingest/image.py's IMREAD_COLOR decode
        (142, 142),  # export_posed_images writes depth with the port's
        (159, 159),  # PNG writer (cv2.imwrite's bytes)
    ],
    "ingest/posed_images.py": [
        (79, 79),    # scene_from_sens: the frame size from the first
        (87, 89),    # JPEG's headers (IMREAD_COLOR's size), no decode
    ],
    "utils/flops.py": [
        (13, 17),    # the module docstring names the port's train step
                     # (and no reference path)
        (26, 44),    # PEAK_BF16 holds the H100's dense bf16 peak keyed by
                     # torch.cuda.get_device_name; device_peak_flops takes
                     # a torch device (None for the CPU or an unknown card)
    ],
    "utils/profiling.py": [
        (1, 44),     # the module docstring names torch.profiler and the
                     # spans; torch and threading imported; Timings is
                     # the process-wide span store (host and device
                     # seconds by name, a lock, snapshot and reset), then
                     # the span context that writes it
        (45, 55),    # device_trace: a torch.profiler trace (CPU and CUDA
                     # activities) exported as a Chrome trace
    ],
    "ingest/native/build.sh": [
        (2, 10),     # an optional output path and the codec's source; the
                     # g++ flags are kept
    ],
    "core/synthetic.py": [
        (236, 236),  # the native codec is imported instead of cv2
        (284, 286),  # make_tapvid_npz encodes with ingest/jpeg.py
        (322, 323),  # make_synthetic_sens imports the native codec
        (342, 344),  # ... and encodes its q90 frames with it
        (351, 351),  # (the frame's bytes, named `color`)
    ],
    "engines/object_movement.py": [
        (3, 9),      # the module docstring names the port, without cv2
        (35, 43),    # torch, the codec and the circle instead of jax, cv2
        (71, 102),   # M5 as torch ops on a device (cumulative_loss)
        (133, 139),  # select_sample_pairs passes the device to M5
        (276, 300),  # process_sequence: the device; the frame size from
                     # the frame header
        (315, 319),  # frames decoded and re-encoded by the native codec
        (342, 348),  # the dot annotation: native codec and draw.circle
        (362, 376),  # generate takes and passes the device
        (414, 439),  # _sequence_columns: as process_sequence
        (494, 497),  # frames as above
        (515, 521),  # the dot annotation as above
        (533, 553),  # generate_to_jsonl takes and passes the device
    ],
    "engines/annotate.py": [
        (1, 10),     # the module docstring names the port, without cv2
        (20, 23),    # the stored glyphs (engines/_glyphs.py) are imported
        (54, 65),    # glyph lookup; _letter_metrics reads the stored size
        (82, 110),   # _circle_mask and _letter_glyph read stored renders
        (207, 213),  # DirImageProvider reads with ingest/image.py
                     # (cv2.imread's pixels; a missing file raises)
        (258, 262),  # save_annotated writes with the native codec at q95
                     # (cv2.imwrite's bytes)
        (276, 306),  # the writer raises without the native encoder
        (397, 407),  # a failed multi-dot splice: whole-frame native encode
        (416, 436),  # _draw_and_save: no branch for a missing encoder
        (464, 476),  # _save: a short cap is retried natively, not by cv2
    ],
    "stages/object_visibility.py": [
        (1, 17),     # the module docstring names the port
        (19, 34),    # torch instead of jax; the shared bit unpacking
        (35, 66),    # the V @ onehot count program in torch on a device
        (73, 81),    # compute_object_visibility takes the device
        (113, 172),  # the multi-device stage is left out
        (176, 184),  # build_object_visibility takes the device
    ],
    "stages/coverage.py": [
        (1, 25),     # the module docstring names the port
        (27, 40),    # torch instead of jax; the shared bit unpacking
        (47, 163),   # the interval program in torch; no multi-device stage
        (286, 321),  # build_object_coverage takes a device, not a mesh
    ],
    "engines/camera_movement.py": [
        (3, 3),      # the module docstring names the port
        (24, 29),    # torch instead of jax
        (63, 63),    # no jax.jit on _batched_displacement
        (70, 70),    # device: a bool or a torch device name
        (78, 98),    # the device path runs torch ops on that device
    ],
}


def _read(pkg, rel):
    with open(os.path.join(REPO, pkg, rel), "rb") as f:
        return f.read()


@pytest.mark.parametrize("rel", IDENTICAL)
def test_identical_copy(rel):
    assert _read(PORT, rel) == _read(JAX, rel)


@pytest.mark.parametrize("rel", sorted(EDITED))
def test_edited_copy_differs_only_in_named_lines(rel):
    a = _read(JAX, rel).decode().splitlines()
    b = _read(PORT, rel).decode().splitlines()
    allowed = EDITED[rel]
    sm = difflib.SequenceMatcher(a=a, b=b, autojunk=False)
    changed = 0
    for tag, i1, i2, _, _ in sm.get_opcodes():
        if tag == "equal":
            continue
        changed += 1
        # original lines i1+1..i2; an insertion sits between i1 and i1+1
        lo, hi = (i1 + 1, i2) if i2 > i1 else (i1, i1 + 1)
        assert any(a_lo <= lo and hi <= a_hi for a_lo, a_hi in allowed), (
            f"{rel}: lines {lo}-{hi} of the original changed outside "
            f"{allowed}")
    assert changed, f"{rel} is identical: move it to IDENTICAL"


def test_native_library_name_follows_sources_and_flags(tmp_path):
    """The port's loader names its build by a digest of the sources and
    build.sh: an edit to either names a new library; the JAX package's
    prebuilt library is never the one loaded."""
    import shutil

    from multi_spatialmllm_tpu_torch.ingest import native

    src = os.path.join(REPO, PORT, "ingest", "native")
    copy = tmp_path / "native"
    shutil.copytree(src, copy, ignore=shutil.ignore_patterns("_build"))
    base = native.library_path()
    assert native.library_path(str(copy)) == base
    assert os.path.dirname(base).endswith(os.path.join("native", "_build"))
    sh = copy / "build.sh"
    sh.write_text(sh.read_text().replace("-O3", "-O2"))
    assert native.library_path(str(copy)) != base
    shutil.copy(os.path.join(src, "build.sh"), sh)
    cpp = copy / "src" / "jsonl_emit.cpp"
    cpp.write_bytes(cpp.read_bytes() + b"\n")
    assert native.library_path(str(copy)) != base
    assert native.native_available(), native.build_error
    assert native.build() == base and os.path.exists(base)
