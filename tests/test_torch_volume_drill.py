"""The port's volume drill (scripts/torch_volume_drill.py) at `--scale
smoke` on the CPU: the campaign is SIGKILLed once 8 new manifest units are
complete and resumed; no unit complete at the kill runs again; every
output file (JSONL, JPEGs, index pickles, visibility.npz, parquets) is
byte-equal to an uninterrupted port campaign's; every one but the relation
parquets is byte-equal to the JAX drill's `campaign` (scripts/
volume_drill.py, JAX_PLATFORMS=cpu), whose parquets hold equal identity
and overlap columns and distances and angles within the limits
scripts/gen_drill_golden.py states (the port's pitch is within 4 ulp of
JAX's, tests/test_torch_geometry.py); and the digests stored for the
card's check (scripts/gen_drill_golden.py) are the uninterrupted run's.
All campaigns run under PYTHONHASHSEED 0, as the drill's own do. The JAX
campaign runs with x64 on (JAX_ENABLE_X64), as the JAX package's tests
run: its overlap column takes the dtype of `jnp.result_type(float)` (JAX
core/geometry.py:428), float32 in a process with x64 off, where the port's
is float64 always (ROADMAP.md, departures).
"""

import json
import os
import subprocess
import sys

import pytest

from multi_spatialmllm_tpu.ingest import native as JN

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import gen_drill_golden as golden  # noqa: E402
from torch_volume_drill import KILL_UNITS, output_digests  # noqa: E402


def _env(**kw):
    return dict(os.environ, PYTHONHASHSEED="0", CUDA_VISIBLE_DEVICES="",
                PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""), **kw)


def _run(args, **env):
    proc = subprocess.run([sys.executable, *args], env=_env(**env),
                          capture_output=True, text=True, timeout=600,
                          cwd=REPO)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("drill")
    killed, whole, jax = (str(base / n) for n in ("killed", "whole", "jax"))
    _run([os.path.join(REPO, "scripts", "torch_volume_drill.py"), "--scale",
          "smoke", "--device", "cpu", "--root", killed])
    _run([os.path.join(REPO, "scripts", "torch_volume_drill.py"), "--mode",
          "campaign", "--scale", "smoke", "--device", "cpu", "--root",
          whole])
    # the JAX writer encodes natively only where its library is built
    JN.build()
    _run([os.path.join(REPO, "scripts", "volume_drill.py"), "--mode",
          "campaign", "--scale", "smoke", "--root", jax],
         JAX_PLATFORMS="cpu", JAX_ENABLE_X64="1")
    with open(os.path.join(killed, "torch_volume_drill.json")) as f:
        report = json.load(f)
    return report, killed, whole, jax


def test_killed_and_resumed_without_rerunning_a_unit(roots):
    report, killed, whole, _ = roots
    with open(os.path.join(whole, "out", "manifest.jsonl")) as f:
        n_units = sum(1 for line in f if line.strip())
    assert report["killed_mid_run"]
    assert KILL_UNITS <= report["units_complete_at_kill"] < n_units
    assert report["units_rerun"] == 0 and report["rerun"] == []
    assert report["units_total"] == n_units
    assert report["units_resumed"] == n_units - report[
        "units_complete_at_kill"]
    assert report["records"] > report["records_at_kill"] > 0
    assert report["images"] > 1000
    assert os.path.exists(os.path.join(killed, "torch_volume_drill.md"))


def test_resumed_outputs_equal_an_uninterrupted_campaign(roots):
    report, killed, whole, _ = roots
    want = output_digests(whole)
    assert report["digests"] == want == output_digests(killed)
    assert sum(k.endswith(".jsonl") for k in want) > 20
    assert sum(k.endswith(".pkl") for k in want) == 4


def test_outputs_equal_the_jax_drill(roots):
    _, killed, _, jax = roots
    got, want = golden.summary(killed), golden.summary(jax)
    assert golden.differences(got, want) == []
    assert got["parquets"]["indices/frame_relations.parquet"]["rows"] > 0


def test_stored_digests_are_the_cpu_campaign(roots):
    """What the card's killed and resumed drill is held to."""
    _, _, whole, _ = roots
    assert golden.differences(golden.summary(whole), golden.load()) == []
