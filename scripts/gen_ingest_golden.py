"""Generate multi_spatialmllm_tpu_torch/ingest/_ingest_golden.json: SHA-256
digests of what the JAX package (with cv2) writes for seeded ingest
inputs, so that a machine with neither can show that the port's ingest
path equals it. The digests cover:

- **export**: bench.py's `ingest_l1` configuration (`make_synthetic_sens`
  of 300 frames at 480 x 640, seed 5), `export_posed_images(frame_skip=1)`
  into `bench_scene/`: the JPEG, PNG and pose-text bytes, the PNGs' pixels,
  and `build_images_info`'s dict;
- **small**: two scans written by `ingest/synthetic_scan.write_scan` (240 x
  320 colour, 40 frames, 4,000 points each) through the JAX CLI's
  `ingest-scannet`, `ingest-sens` and `coverage` (2 shards, `--merge`):
  the scene packs' arrays, `scenes_info.pkl` and the merged coverage;
- **tiles**: 968 x 1296 and 480 x 640 frames written by `cv2.imwrite` as
  JPEG and PNG: the files' bytes, and the tiles of the JAX `tile_image`
  (cv2's INTER_AREA) on `cv2.imread` → RGB, at the flagship's 448 tiles
  and the tiny config's 56.

Files are digested by bytes; arrays, pickles and npz files by content
(`content_sha`: each array's dtype, shape and bytes, each dict's keys in
order), which no numpy or zlib version changes. PNG bytes depend on the
zlib that writes them: the file names the version used here.

The input makers (`small_scans`, `tile_frame`) and the digest functions use
numpy and the port alone; the smoke run on the card imports them from here.
Run it with cv2 and the JAX package importable to regenerate:

    python scripts/gen_ingest_golden.py            # write the file
    python scripts/gen_ingest_golden.py --check    # exit 1 if it differs
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import pickle
import sys
import tempfile
import zlib

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
OUT = os.path.join(REPO, "multi_spatialmllm_tpu_torch", "ingest",
                   "_ingest_golden.json")
EXPORT = dict(n_frames=300, image_hw=(480, 640), depth_hw=(480, 640),
              seed=5)                       # bench.py:748-751
EXPORT_DIR = "bench_scene"
SMALL = [dict(scene_id=f"scene{i:04d}_00", seed=60 + i, n_images=8,
              n_background=4000, image_hw=(240, 320), depth_hw=(120, 160))
         for i in range(2)]
SMALL_SKIP = 5                               # 8 kept of 40 frames a scan
TILE_FRAMES = {"scannet": (968, 1296), "vga": (480, 640)}
TILE_SIZES = {"flagship": 448, "tiny": 56}
MAX_TILES = 6                                # the serve CLI's default


def sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def content_sha(obj) -> str:
    """A digest of a value's content: arrays by dtype, shape and bytes,
    dicts by keys in order, sequences item by item, scalars by repr."""
    h = hashlib.sha256()

    def walk(o):
        if isinstance(o, np.ndarray):
            a = np.ascontiguousarray(o)
            h.update(f"A{a.dtype.str}{a.shape}".encode())
            h.update(a.tobytes() if a.dtype != object else
                     repr(a.tolist()).encode())
        elif isinstance(o, dict):
            h.update(f"D{len(o)}".encode())
            for k, v in o.items():
                walk(k)
                walk(v)
        elif isinstance(o, (list, tuple)):
            h.update(f"L{len(o)}".encode())
            for v in o:
                walk(v)
        elif isinstance(o, np.generic):
            h.update(f"S{o.dtype.str}".encode() + o.tobytes())
        else:
            h.update(f"{type(o).__name__}:{o!r}".encode())

    walk(obj)
    return h.hexdigest()


def npz_sha(path: str) -> str:
    with np.load(path, allow_pickle=False) as z:
        return content_sha({k: z[k] for k in z.files})


def pickle_sha(path: str) -> str:
    with open(path, "rb") as f:
        return content_sha(pickle.load(f))


def files_sha(root: str, suffix: str, read=None) -> str:
    """One digest over the files under `root` ending in `suffix`, by
    sorted relative name: their bytes, or `read(path)`'s content."""
    h = hashlib.sha256()
    for d, _, fs in sorted(os.walk(root)):
        for f in sorted(fs):
            if not f.endswith(suffix):
                continue
            p = os.path.join(d, f)
            h.update(os.path.relpath(p, root).encode() + b"\0")
            if read is None:
                with open(p, "rb") as fh:
                    h.update(sha(fh.read()).encode())
            else:
                h.update(content_sha(read(p)).encode())
    return h.hexdigest()


def small_scans(root: str) -> list:
    """Write the two small scans under `root`; returns their scenes."""
    from multi_spatialmllm_tpu_torch.core.synthetic import make_scene
    from multi_spatialmllm_tpu_torch.ingest.synthetic_scan import write_scan

    scenes = [make_scene(**cfg) for cfg in SMALL]
    for s in scenes:
        write_scan(root, s, frame_skip=SMALL_SKIP)
    return scenes


def tile_frame(name: str) -> np.ndarray:
    from multi_spatialmllm_tpu_torch.ingest.synthetic_scan import scan_frame

    h, w = TILE_FRAMES[name]
    return scan_frame(h, w, 7, seed=len(name))


def small_digests(root: str) -> dict:
    """Digests of a small run's tree: `<root>/exp`, `packs`, `cov`."""
    out = {"scenes_info": pickle_sha(os.path.join(root, "exp",
                                                  "scenes_info.pkl"))}
    for cfg in SMALL:
        sid = cfg["scene_id"]
        out[f"pack_{sid}"] = npz_sha(os.path.join(root, "packs",
                                                  f"{sid}.npz"))
    for dim in ("height", "length", "width"):
        out[f"coverage_{dim}"] = pickle_sha(os.path.join(
            root, "cov", f"merged_train_object_coverage_{dim}.pkl"))
    return out


def small_commands(scans: str, root: str) -> list[list[str]]:
    """The small run's commands (the CLI of either package), in order."""
    cmds = [["ingest-scannet", "--scans", scans, "--output",
             os.path.join(root, "exp")],
            ["ingest-sens", "--scans", scans, "--frame-skip",
             str(SMALL_SKIP), "--output", os.path.join(root, "packs")]]
    for i in range(2):
        cmds.append(["coverage", "--scenes", os.path.join(root, "packs"),
                     "--shard-index", str(i), "--num-shards", "2",
                     "--output", os.path.join(root, "cov")])
    cmds.append(["coverage", "--merge", "--output",
                 os.path.join(root, "cov")])
    return cmds


def export_digests(exp: str, n: int, read_png, images_info) -> dict:
    return {"frames": n, "jpg": files_sha(exp, ".jpg"),
            "png": files_sha(exp, ".png"),
            "png_pixels": files_sha(exp, ".png", read_png),
            "txt": files_sha(exp, ".txt"),
            "images_info": content_sha(images_info)}


def port_export_sens(tmp: str) -> str:
    """The port's `make_synthetic_sens` of the export configuration under
    `tmp` (export it into `<tmp>/posed/<EXPORT_DIR>`)."""
    from multi_spatialmllm_tpu_torch.core.synthetic import make_synthetic_sens

    sens = os.path.join(tmp, "bench.sens")
    make_synthetic_sens(sens, **EXPORT)
    return sens


def port_export_digests(exp: str, n: int) -> dict:
    from multi_spatialmllm_tpu_torch.ingest.png import imread_png
    from multi_spatialmllm_tpu_torch.ingest.posed_images import (
        build_images_info,
    )

    return export_digests(exp, n, imread_png, build_images_info(exp, 1))


def port_tiles(tmp: str) -> dict:
    """The tiles entry from the port: frames written by its JPEG and PNG
    writers, read by ingest/image.py, tiled by its tile_image."""
    from multi_spatialmllm_tpu_torch.__main__ import _read_image
    from multi_spatialmllm_tpu_torch.ingest import jpeg, png
    from multi_spatialmllm_tpu_torch.models.preprocess import (
        PreprocessConfig,
        tile_image,
    )

    out = {}
    for name in TILE_FRAMES:
        img = tile_frame(name)
        for ext, write in (("jpg", lambda p, x: jpeg.imwrite(p, x, 95)),
                           ("png", png.imwrite_png)):
            path = os.path.join(tmp, f"{name}.{ext}")
            write(path, img)
            with open(path, "rb") as f:
                entry = {"file": sha(f.read())}
            rgb = _read_image(path)
            entry["pixels"] = content_sha(rgb)
            for label, size in TILE_SIZES.items():
                entry[label] = content_sha(tile_image(
                    rgb, PreprocessConfig(tile_size=size,
                                          max_tiles=MAX_TILES,
                                          resize_hw=None)))
            out[f"{name}.{ext}"] = entry
    return out


def golden(cv2) -> dict:
    """Run the JAX package (with cv2) on the inputs; returns the file's
    content."""
    from multi_spatialmllm_tpu import __main__ as jcli
    from multi_spatialmllm_tpu.core.synthetic import make_synthetic_sens
    from multi_spatialmllm_tpu.ingest import native as JN
    from multi_spatialmllm_tpu.ingest.posed_images import build_images_info
    from multi_spatialmllm_tpu.ingest.sens import export_posed_images
    from multi_spatialmllm_tpu.models.preprocess import (
        PreprocessConfig,
        tile_image,
    )

    JN.build()
    out = {"cv2": cv2.__version__, "zlib": zlib.ZLIB_RUNTIME_VERSION,
           "numpy": np.__version__}
    with tempfile.TemporaryDirectory() as tmp:
        sens = os.path.join(tmp, "bench.sens")
        make_synthetic_sens(sens, **EXPORT)
        exp = os.path.join(tmp, "posed", EXPORT_DIR)
        n = export_posed_images(sens, exp, frame_skip=1)
        out["export"] = export_digests(exp, n, lambda p: cv2.imread(p, -1),
                                       build_images_info(exp, 1))

        scans = os.path.join(tmp, "scans")
        small_scans(scans)
        argv = sys.argv
        try:
            for cmd in small_commands(scans, os.path.join(tmp, "small")):
                sys.argv = ["multi_spatialmllm_tpu", *cmd]
                jcli.main()
        finally:
            sys.argv = argv
        out["small"] = small_digests(os.path.join(tmp, "small"))

        out["tiles"] = {}
        for name in TILE_FRAMES:
            img = tile_frame(name)
            for ext in ("jpg", "png"):
                path = os.path.join(tmp, f"{name}.{ext}")
                cv2.imwrite(path, img)
                with open(path, "rb") as f:
                    entry = {"file": sha(f.read())}
                rgb = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
                entry["pixels"] = content_sha(rgb)
                for label, size in TILE_SIZES.items():
                    entry[label] = content_sha(tile_image(
                        rgb, PreprocessConfig(tile_size=size,
                                              max_tiles=MAX_TILES,
                                              resize_hw=None)))
                out["tiles"][f"{name}.{ext}"] = entry
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--check", action="store_true",
                        help="compare with the stored file instead")
    args = parser.parse_args(argv)
    import cv2

    got = golden(cv2)
    if args.check:
        with open(OUT) as f:
            stored = json.load(f)
        if stored != got:
            print("stored ingest digests differ from this run",
                  file=sys.stderr)
            return 1
        print("stored ingest digests match")
        return 0
    with open(OUT, "w") as f:
        json.dump(got, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
