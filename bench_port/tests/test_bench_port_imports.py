"""No run imports JAX or the JAX package; the reference imports nothing
of the program. Names are compared whole by their top-level part:
`multi_spatialmllm_tpu_torch` starts with the JAX package's name."""

import json
import os
import subprocess
import sys

from bench_port.harness import FORBIDDEN, ROOT

from .tiny import tiny_overrides


def run_py(code: str) -> dict:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax():
    over = tiny_overrides("internvl2_2b.sft")
    got = run_py(
        "import json, sys\n"
        "from bench_port import run, harness\n"
        "for n in ('sft', 'spatial_qa'): harness.load_module('traffic', n)\n"
        "for m in harness.benchmark()['per_layer']:\n"
        "    harness.load_module('metrics', m['name'])\n"
        f"res = run.run_cell('internvl2_2b.sft', 2**31 + 3, 1.0, True, "
        f"'cpu', overrides={over!r})\n"
        "print(json.dumps({'top': sorted({m.split('.')[0] for m in "
        "sys.modules}), 'correct': res['correct']}))\n")
    assert not set(got["top"]) & FORBIDDEN
    assert "multi_spatialmllm_tpu_torch" in got["top"]
    assert got["correct"]


def test_the_reference_imports_nothing_of_the_program():
    got = run_py(
        "import json, sys\n"
        "from bench_port.reference import checks, data, model\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    assert not set(got) & (FORBIDDEN | {"multi_spatialmllm_tpu_torch"})


def test_forbidden_names_are_compared_whole():
    from bench_port import harness

    sys.modules.setdefault("multi_spatialmllm_tpu_torch", sys)
    assert "multi_spatialmllm_tpu" not in harness.forbidden_modules()
