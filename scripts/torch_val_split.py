#!/usr/bin/env python
"""The val-shaped split through the port's scene-parallel stages: bench.py's
`split_projection_val` scene shape (:692-700: 296 images of 968 x 1296,
200,000 background points, 8 objects, depth 480 x 640, no invalid pose)
at 312 seeds (20 .. 331), the size of the ScanNet val split, through
`compute_visibility_multichip` and `compute_relations_multichip` (float64)
over the data axis of the launched world, once. Prints the minutes of the
stages, the wall minutes (scene synthesis included: worker processes make
the scenes while the stages run, a bounded number ahead; the minutes the
stages waited for them apart) and the relation rows (valid pairs i < j),
beside the reference's 24.12M val pairs; a progress line a chunk on
stderr.

    python -m torch.distributed.run --nproc-per-node 1 \\
        scripts/torch_val_split.py [--scenes 312] [--out report.json]

`--device cpu` joins a gloo group and computes on the CPU (for a rehearsal
at `--scenes 2`); the card is the default.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

VAL_SCENES = 312
REF_VAL_PAIRS = 24.12e6   # the reference's val relation pairs (bench.py)
SHAPE = dict(n_images=296, n_background=200_000, n_objects=8,
             image_hw=(968, 1296), depth_hw=(480, 640), n_invalid_poses=0)
AHEAD = 8                 # scenes made ahead of the stages


def make(i: int, shape: dict):
    from multi_spatialmllm_tpu_torch.core.synthetic import make_scene

    return make_scene(scene_id=f"proj{i:04d}_00", seed=20 + i, **shape)


def main(shape: dict = SHAPE) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenes", type=int, default=VAL_SCENES)
    ap.add_argument("--per-device-batch", type=int, default=4)
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch
    import torch.distributed as dist

    from multi_spatialmllm_tpu_torch.parallel.distributed import (
        initialize_multihost,
    )
    from multi_spatialmllm_tpu_torch.parallel.mesh import make_mesh
    from multi_spatialmllm_tpu_torch.stages.frame_relations import (
        compute_relations_multichip,
    )
    from multi_spatialmllm_tpu_torch.stages.visibility import (
        compute_visibility_multichip,
    )

    initialize_multihost(device=args.device)
    mesh = make_mesh()
    size = mesh.size(0)
    cuda = torch.device(args.device).type == "cuda"
    step = size * args.per_device_batch
    stage_s = vis_s = wait_s = 0.0
    rows = visible = 0
    t_wall = time.perf_counter()
    # one BLAS thread a worker: the synthesis's 4 x N products would
    # otherwise start a thread a core in every worker and contend
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    with ProcessPoolExecutor(args.workers,
                             mp_context=get_context("spawn")) as pool:
        pending = [pool.submit(make, i, shape)
                   for i in range(min(AHEAD, args.scenes))]
        submitted = len(pending)
        done = 0
        while done < args.scenes:
            take = min(step, args.scenes - done)
            t0 = time.perf_counter()
            scenes = [f.result() for f in pending[:take]]
            wait_s += time.perf_counter() - t0
            pending = pending[take:]
            while submitted < args.scenes and len(pending) < AHEAD:
                pending.append(pool.submit(make, submitted, shape))
                submitted += 1
            t0 = time.perf_counter()
            vis = compute_visibility_multichip(
                scenes, mesh, per_device_batch=args.per_device_batch,
                device=args.device)
            if cuda:
                torch.cuda.synchronize()
            t1 = time.perf_counter()
            rel = compute_relations_multichip(
                scenes, mesh, vis, per_device_batch=args.per_device_batch,
                device=args.device)
            if cuda:
                torch.cuda.synchronize()
            stage_s += time.perf_counter() - t0
            vis_s += t1 - t0
            for s in scenes:
                n = int(s.valid_image_mask().sum())
                rows += n * (n - 1) // 2
                visible += int(vis[s.scene_id].sum())
                if rel[s.scene_id]["overlap"].shape != (s.num_images,) * 2:
                    raise SystemExit(f"{s.scene_id}: relations of shape "
                                     f"{rel[s.scene_id]['overlap'].shape}")
            done += take
            del scenes, vis, rel
            print(f"[val-split] {done}/{args.scenes} scenes: stages "
                  f"{stage_s:.1f} s (visibility {vis_s:.1f}), waiting for "
                  f"scenes {wait_s:.1f} s, wall "
                  f"{time.perf_counter() - t_wall:.1f} s, {rows} relation "
                  f"rows", file=sys.stderr, flush=True)
    wall = time.perf_counter() - t_wall
    report = {
        "scenes": args.scenes, "world": size,
        "backend": dist.get_backend(),
        "device": (torch.cuda.get_device_name(0) if cuda else "cpu"),
        "stage_min": stage_s / 60, "visibility_min": vis_s / 60,
        "relations_min": (stage_s - vis_s) / 60,
        "s_per_scene": stage_s / args.scenes, "wall_min": wall / 60,
        "synthesis_wait_min": wait_s / 60,
        "relation_rows": rows, "reference_val_pairs": REF_VAL_PAIRS,
        "visible_pairs": visible,
    }
    if dist.get_rank() == 0:
        print(json.dumps(report), flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(report, f, indent=1)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
