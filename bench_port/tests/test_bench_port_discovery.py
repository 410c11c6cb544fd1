"""A configuration, a cell and a per-layer metric dropped into a copy of
the benchmark's folder are found by name, with no file edited (only
BENCHMARK.json gains entries)."""

import json
import os
import shutil
import subprocess
import sys

from bench_port.harness import ROOT

from .tiny import TINY


def test_new_files_are_found(tmp_path):
    shutil.copytree(os.path.join(ROOT, "bench_port"), tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = tmp_path / "bench_port"
    cfg = json.loads((b / "configs" / "internvl2_2b.json").read_text())
    cfg["name"] = "extra_cfg"
    for k, patch in TINY.items():
        cfg[k] = {**cfg[k], **patch}
    cfg["train"]["compute_dtype"] = "float32"
    (b / "configs" / "extra_cfg.json").write_text(json.dumps(cfg))
    cell = json.loads((b / "workloads" / "internvl2_2b.sft.json").read_text())
    cell.update(config="extra_cfg")
    cell["params"].update(seq_len=512, frame_pool=4)
    (b / "workloads" / "extra_cfg.sft.json").write_text(json.dumps(cell))
    (b / "metrics" / "steps_seen.extra.py").write_text(
        'def read(ctx):\n    return float(ctx.counters["steps"])\n')
    bench = json.loads(open(os.path.join(ROOT, "BENCHMARK.json")).read())
    bench["per_layer"].append({
        "name": "steps_seen.extra", "unit": "steps", "better": "higher",
        "source": "program_counter", "layer": "train loop",
        "moves": "train_tokens_per_s", "workloads": ["extra_cfg.sft"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json, sys\n"
            f"sys.path[:0] = [{str(tmp_path)!r}]\nsys.path.append({ROOT!r})\n"
            "from bench_port import run\n"
            "print(json.dumps(run.run_cell('extra_cfg.sft', 12, 1.0, True, "
            "'cpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["metrics"]["steps_seen.extra"]["value"] >= 1
    assert "data_wait_ms.train" not in res["metrics"]
    assert res["correct"]
