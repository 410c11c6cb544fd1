"""Generate multi_spatialmllm_tpu_torch/stages/_visibility_golden.json: the
SHA-256 of the JAX package's float64 visibility labels, bit-packed, on
bench.py's real-scale scene (:357-362: seed 7, 296 images of 968 x 1296,
202,400 points, depth 480 x 640), and of its hybrid labels (a float32 pass
and the host float64 fix-up), which must be the same. A machine without
JAX (the card's) holds the port's float64 and hybrid labels to it.

The scene maker and `packed_digest` use numpy and the port alone; the
smoke run on the card imports them from here. Run it with the JAX package
importable (on the CPU; ~1 GB a chunk of 40 images) to regenerate:

    python scripts/gen_visibility_golden.py            # write the file
    python scripts/gen_visibility_golden.py --check    # exit 1 if it differs
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
OUT = os.path.join(REPO, "multi_spatialmllm_tpu_torch", "stages",
                   "_visibility_golden.json")
# bench.py:357-362
REAL_SCENE = dict(scene_id="real0000_00", seed=7, n_images=296,
                  n_background=200_000, n_objects=8, image_hw=(968, 1296),
                  depth_hw=(480, 640), n_invalid_poses=0)
JAX_CHUNK = 40          # images a JAX dispatch here: bounds the CPU memory


def real_scene():
    from multi_spatialmllm_tpu_torch.core.synthetic import make_scene

    return make_scene(**REAL_SCENE)


def packed_digest(vis: np.ndarray) -> str:
    """SHA-256 of an `[I, N]` bool matrix: its shape, then its
    `np.packbits(axis=1)` bytes."""
    h = hashlib.sha256(f"{vis.shape}".encode())
    h.update(np.packbits(vis, axis=1).tobytes())
    return h.hexdigest()


def load() -> dict:
    with open(OUT) as f:
        return json.load(f)


def generate() -> dict:
    import jax

    jax.config.update("jax_enable_x64", True)
    from multi_spatialmllm_tpu.stages import visibility as JV

    scene = real_scene()
    t0 = time.perf_counter()
    f64 = JV.compute_scene_visibility(scene, np.float64,
                                      image_chunk=JAX_CHUNK)
    t_f64 = time.perf_counter() - t0
    t0 = time.perf_counter()
    hybrid = JV.compute_scene_visibility_hybrid(scene, image_chunk=JAX_CHUNK)
    t_hybrid = time.perf_counter() - t0
    print(f"JAX CPU ({jax.__version__}): float64 {t_f64:.1f} s, hybrid "
          f"{t_hybrid:.1f} s, {scene.num_images} x {scene.num_points} "
          f"pairs, {int(f64.sum())} visible")
    return {
        "scene": {k: list(v) if isinstance(v, tuple) else v
                  for k, v in REAL_SCENE.items()},
        "shape": list(f64.shape),
        "visible": int(f64.sum()),
        "float64_packed_sha256": packed_digest(f64),
        "hybrid_packed_sha256": packed_digest(hybrid),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--check", action="store_true",
                        help="compare with the stored file instead of "
                             "writing it")
    args = parser.parse_args(argv)
    golden = generate()
    if golden["float64_packed_sha256"] != golden["hybrid_packed_sha256"]:
        print("the JAX hybrid labels differ from its float64 labels")
        return 1
    if args.check:
        if golden != load():
            print(f"{OUT} differs from a fresh JAX run")
            return 1
        print(f"{OUT} matches")
        return 0
    with open(OUT, "w") as f:
        json.dump(golden, f, indent=1)
        f.write("\n")
    print(f"wrote {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
