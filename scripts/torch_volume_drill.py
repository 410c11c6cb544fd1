#!/usr/bin/env python
"""Volume drill of the PyTorch port: one full `run_all` campaign writing
>=1M QA records + annotated JPEGs across all ten engines, KILLED mid-run
and RESUMED through the stage manifest (stages/manifest.py). The port's
copy of scripts/volume_drill.py: the same modes, counts, store, seeds and
kill rule, with the campaign on `multi_spatialmllm_tpu_torch`.

Modes
  drive     (default) build the inputs, launch the campaign subprocess,
            SIGKILL it once 8 new manifest units are complete (or after
            --kill-after seconds), relaunch it to completion, check that no
            unit complete at the kill ran again, then write
            torch_volume_drill.{json,md} under --root
  campaign  internal: run `SpatialEnginePipeline.run_all` at volume
            counts against --root (resumable: rerunning skips every
            manifest-complete unit)

Counts (full scale, --scale full; 24 scenes x 296 posed images):
  camera movement   9 question types x 110K train + 300 val each
  depth est/comp    coor <=60K train + 15K eval each (8 pts/image);
                    dot 8K + 2K each (annotated 480x640 JPEGs)
  correspondence    coor->coor 60K + 15K; dot->MC 2.4K + 600 (2 JPEGs
                    per record)
  object perception coverage-driven (all samples, train + val)
  object movement   24 TAPVid sequences, coord + dot (annotated)
  total             >=1.3M records + ~30K annotated JPEGs

The campaign runs on the card (`--device cuda`, the default) or on the CPU
(`--device cpu`), under PYTHONHASHSEED 0: the synthetic frames are seeded
from Python's string hash, so a fixed seed gives the same files on every
machine. The report lists a sha256 of every output file (`digests`): the
JSONL, the JPEGs, the index pickles and visibility.npz, the parquet.

    python scripts/torch_volume_drill.py --root /big/disk/drill
    python scripts/torch_volume_drill.py --scale smoke --root /tmp/d
"""

from __future__ import annotations

import argparse
import collections
import hashlib
import json
import os
import signal
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# camera-movement balanced sampling draws WITHOUT replacement per
# overlap bin (engines/sampling.py, reference parity), so per-type
# counts are bounded by qualifying relation pairs: 24 scenes x 296
# images ~= 1.05M raw pairs, ~40% in the 6-35% overlap band -> ~400K
# qualifying, comfortably above the 110K/type requests below.
CAMERA_TRAIN = {
    "total_distance": 110_000, "displacement_vector": 110_000,
    "x_movement": 110_000, "y_movement": 110_000, "z_movement": 110_000,
    "yaw_movement": 110_000, "pitch_movement": 110_000,
    "yaw_angle": 110_000, "pitch_angle": 110_000,
}
SMOKE_DIV = 500  # --scale smoke: the structural pass, small counts
KILL_UNITS = 8
# output files that hold wall times or paths, not the campaign's data
NOT_DATA = ("manifest.jsonl", "events.jsonl")


def _counts(scale: str) -> dict:
    d = SMOKE_DIV if scale == "smoke" else 1
    return {
        "camera_train": {k: max(v // d, 10)
                         for k, v in CAMERA_TRAIN.items()},
        "camera_val": {k: max(300 // d, 3) for k in CAMERA_TRAIN},
        "depth": max(60_000 // d, 20),
        "depth_dot": max(8_000 // d, 8),
        "depth_ppi": 8,  # 24 x 296 images x 8 pts ~= 57K estimation rows
        "corr": max(60_000 // d, 20),
        "corr_dot": max(2_400 // d, 8),
        "n_scenes": 24 if scale == "full" else 2,
        "n_tapvid": 24 if scale == "full" else 3,
    }


def _check_marker(root: str, scale: str) -> "str | None":
    """The store marker records the scale it was built at; a --root
    reused at a DIFFERENT scale must error, not silently reuse the old
    store + manifest."""
    marker = os.path.join(root, "scenes", ".complete")
    if not os.path.exists(marker):
        return None
    with open(marker) as f:
        built = f.read().strip()
    if built != scale:
        raise SystemExit(
            f"{root} was built at scale={built or '<unknown>'} but this "
            f"run asks for scale={scale}; pass a fresh --root (the store "
            f"AND out/manifest.jsonl there belong to the old scale)")
    return built


def build_inputs(root: str, scale: str) -> None:
    """Synthetic store at ScanNet-export geometry (480x640 frames,
    120x160 depth); idempotent per scale. TAPVid records are rebuilt in
    memory by each campaign (seeded)."""
    from multi_spatialmllm_tpu_torch.core.scene import SceneStore
    from multi_spatialmllm_tpu_torch.core.synthetic import make_scene

    c = _counts(scale)
    scene_dir = os.path.join(root, "scenes")
    if _check_marker(root, scale) is None:
        scenes = [
            make_scene(scene_id=f"vol{i:04d}_00", seed=7_000 + i,
                       n_images=296 if scale == "full" else 10,
                       n_background=40_000 if scale == "full" else 2_000,
                       n_objects=5, image_hw=(480, 640),
                       depth_hw=(120, 160), n_invalid_poses=1)
            for i in range(c["n_scenes"])
        ]
        SceneStore.write(scenes, scene_dir)
        with open(os.path.join(scene_dir, ".complete"), "w") as f:
            f.write(scale + "\n")


def campaign(root: str, scale: str, device: str) -> None:
    from multi_spatialmllm_tpu_torch.core.scene import SceneStore
    from multi_spatialmllm_tpu_torch.core.synthetic import make_tapvid_npz
    from multi_spatialmllm_tpu_torch.pipeline import (
        PipelineConfig,
        SpatialEnginePipeline,
    )

    c = _counts(scale)
    build_inputs(root, scale)
    store = SceneStore(os.path.join(root, "scenes"))
    tapvid = {
        f"volseq{i:03d}": make_tapvid_npz(n_frames=12, n_groups=4,
                                          points_per_group=10,
                                          seed=9_000 + i)
        for i in range(c["n_tapvid"])
    }
    pipe = SpatialEnginePipeline(
        store, os.path.join(root, "out"),
        PipelineConfig(dtype="hybrid"), device=device)
    results = pipe.run_all(
        tapvid_records=tapvid,
        camera_train_counts=c["camera_train"],
        camera_val_counts=c["camera_val"],
        depth_samples=c["depth"],
        depth_dot_samples=c["depth_dot"],
        depth_points_per_image=c["depth_ppi"],
        correspondence_count=c["corr"],
        correspondence_dot_count=c["corr_dot"],
    )
    summary = {}
    for group, res in results.items():
        if hasattr(res, "n_train"):
            summary[group] = {"n_train": res.n_train, "n_val": res.n_val}
            continue
        summary[group] = {
            k: {"n_train": getattr(v, "n_train", 0),
                "n_val": getattr(v, "n_val", 0)}
            for k, v in res.items()}
    with open(os.path.join(root, "campaign_summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print("CAMPAIGN_DONE")


def _walk_outputs(root: str) -> dict:
    """Count records/images/bytes under out/qa."""
    n_records = n_images = total_bytes = 0
    per_engine: dict[str, dict] = {}
    qa = os.path.join(root, "out", "qa")
    for dirpath, _, files in os.walk(qa):
        for fname in files:
            p = os.path.join(dirpath, fname)
            sz = os.path.getsize(p)
            total_bytes += sz
            rel = os.path.relpath(dirpath, qa)
            engine = rel.split(os.sep)[1] if os.sep in rel else rel
            ent = per_engine.setdefault(
                engine, {"records": 0, "images": 0, "bytes": 0})
            ent["bytes"] += sz
            if fname.endswith(".jsonl"):
                with open(p, "rb") as f:
                    n = sum(1 for _ in f)
                ent["records"] += n
                n_records += n
            elif fname.endswith((".jpg", ".jpeg", ".png")):
                ent["images"] += 1
                n_images += 1
    return {"records": n_records, "images": n_images,
            "bytes": total_bytes, "per_engine": per_engine}


def output_digests(root: str) -> dict[str, str]:
    """sha256 of every data file the campaign wrote under out/ (relative
    path -> hex), leaving out the manifest and the event log."""
    out_dir = os.path.join(root, "out")
    digests = {}
    for dirpath, _, files in os.walk(out_dir):
        for fname in files:
            if fname in NOT_DATA:
                continue
            p = os.path.join(dirpath, fname)
            h = hashlib.sha256()
            with open(p, "rb") as f:
                for block in iter(lambda: f.read(1 << 20), b""):
                    h.update(block)
            digests[os.path.relpath(p, out_dir)] = h.hexdigest()
    return dict(sorted(digests.items()))


def _manifest_units(root: str) -> list[str]:
    path = os.path.join(root, "out", "manifest.jsonl")
    units = []
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:  # the campaign may be mid-append: a partially
                    rec = json.loads(line)  # flushed tail line is never
                except json.JSONDecodeError:  # a completed unit
                    continue
                units.append(f'{rec["stage"]}:{rec["unit"]}')
    return units


def _write_md(report: dict, path: str) -> None:
    keys = ("scale", "device", "killed_mid_run", "phase1_s", "phase2_s",
            "wall_s", "units_complete_at_kill", "units_resumed",
            "units_rerun", "units_total", "records_at_kill", "records",
            "images", "bytes", "records_per_s")
    lines = ["# Volume drill of the PyTorch port "
             "(scripts/torch_volume_drill.py)", "",
             "| Metric | Value |", "|---|---|"]
    lines += [f"| {k} | {report[k]} |" for k in keys]
    lines += ["", "| Engine | Records | Images | Bytes |", "|---|---|---|---|"]
    lines += [f"| {e} | {v['records']} | {v['images']} | {v['bytes']} |"
              for e, v in sorted(report["per_engine"].items())]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def drive(root: str, scale: str, kill_after: float, device: str) -> dict:
    os.makedirs(root, exist_ok=True)
    _check_marker(root, scale)  # fail fast on a scale-mismatched root
    cmd = [sys.executable, os.path.abspath(__file__), "--mode", "campaign",
           "--root", root, "--scale", scale, "--device", device]
    env = dict(os.environ, PYTHONHASHSEED="0")
    log1 = os.path.join(root, "phase1.log")
    log2 = os.path.join(root, "phase2.log")

    # Phase 1: run + SIGKILL mid-campaign (no cleanup chance: the resume
    # must cope with whatever was on disk at that instant). The kill fires
    # as soon as KILL_UNITS NEW manifest units complete (so it lands
    # MID-campaign whatever the wall time, and a pre-populated manifest
    # cannot trigger it instantly); `kill_after` is the fallback bound.
    base_units = len(_manifest_units(root))
    t0 = time.time()
    with open(log1, "w") as lf:
        proc = subprocess.Popen(cmd, stdout=lf, stderr=subprocess.STDOUT,
                                env=env)
        killed = False
        try:
            while proc.poll() is None:
                done = len(_manifest_units(root)) - base_units
                if done >= KILL_UNITS or time.time() - t0 >= kill_after:
                    proc.send_signal(signal.SIGKILL)
                    proc.wait()
                    killed = True
                    break
                time.sleep(0.5)
        finally:
            if proc.poll() is None:  # poller crashed: never orphan the
                proc.kill()          # campaign subprocess
                proc.wait()
    t_phase1 = time.time() - t0
    if proc.returncode not in (0, -signal.SIGKILL):
        raise SystemExit(f"the phase-1 campaign failed (rc "
                         f"{proc.returncode}); see {log1}")
    units_at_kill = _manifest_units(root)
    outputs_at_kill = _walk_outputs(root)
    if not killed:
        print("WARNING: campaign finished before the kill; the report "
              "shows a completed phase 1")

    # Phase 2: resume to completion.
    t0 = time.time()
    with open(log2, "w") as lf:
        rc = subprocess.call(cmd, stdout=lf, stderr=subprocess.STDOUT,
                             env=env)
    t_phase2 = time.time() - t0
    if rc != 0:
        raise SystemExit(f"RESUME FAILED rc={rc}; see {log2}")

    units_final = _manifest_units(root)
    # a unit complete at the kill that ran again would append its line
    # again
    seen = collections.Counter(units_final)
    rerun = sorted(u for u in set(units_at_kill) if seen[u] > 1)
    outputs = _walk_outputs(root)
    report = {
        "scale": scale,
        "device": device,
        "killed_mid_run": killed,
        "phase1_s": round(t_phase1, 1),
        "phase2_s": round(t_phase2, 1),
        "wall_s": round(t_phase1 + t_phase2, 1),
        "units_complete_at_kill": len(units_at_kill),
        "units_total": len(seen),
        "units_resumed": len(seen) - len(set(units_at_kill)),
        "units_rerun": len(rerun),
        "records_at_kill": outputs_at_kill["records"],
        "records": outputs["records"],
        "images": outputs["images"],
        "bytes": outputs["bytes"],
        "records_per_s": round(
            outputs["records"] / max(t_phase1 + t_phase2, 1e-9), 1),
        "units_at_kill": units_at_kill,
        "rerun": rerun,
        "per_engine": outputs["per_engine"],
        "digests": output_digests(root),
    }
    out_json = os.path.join(root, "torch_volume_drill.json")
    with open(out_json, "w") as f:
        json.dump(report, f, indent=1)
    _write_md(report, os.path.join(root, "torch_volume_drill.md"))
    print(json.dumps({k: v for k, v in report.items()
                      if k not in ("per_engine", "units_at_kill",
                                   "digests")}))
    print(f"report: {out_json}")
    if rerun:
        raise SystemExit(f"units complete at the kill ran again: {rerun}")
    return report


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("drive", "campaign"),
                    default="drive")
    ap.add_argument("--root", default="torch_volume_drill")
    ap.add_argument("--scale", choices=("full", "smoke"), default="full")
    ap.add_argument("--device", default="cuda",
                    help="where the campaign computes (cuda, or cpu)")
    ap.add_argument("--kill-after", type=float, default=240.0,
                    help="SIGKILL the phase-1 campaign after this many "
                         "seconds if 8 new units are not complete by then "
                         "(drive mode)")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    if args.mode == "campaign":
        campaign(root, args.scale, args.device)
    else:
        drive(root, args.scale, args.kill_after, args.device)


if __name__ == "__main__":
    main()
