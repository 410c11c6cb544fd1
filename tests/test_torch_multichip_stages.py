"""The port's scene-parallel data engine (the four `*_multichip` stages and
`build_object_coverage(mesh=...)`) over gloo worlds of 3 and 2 processes on
the CPU, against the JAX package's single-device stages and against JAX's
own `*_multichip` functions on its 8-device virtual CPU mesh.

Eleven scenes (the JAX tests' shape: `n_images=10`, `n_background=2000`,
two objects, seeds 90+i), not a multiple of either world; four of them
have 17 images, so there are two padded-shape groups, and at
`per_device_batch` 4 over 3 processes the last process holds no scene of
the smaller group while it still takes part in every exchange. Odd seeds
carry an invalid pose. On every process, every result must be byte-equal,
scene by scene, to the port's single-device stage (arrays: dtype, shape and
bytes; the object-visibility and coverage dicts: their pickles), and to the
JAX stage's with one departure on record: the relations' pitch, within
2 * PITCH_ULP ulp of 90 degrees as tests/test_torch_stages.py holds the
single-device stage. Only the first process writes the object-visibility
warnings.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

from multi_spatialmllm_tpu.core.synthetic import make_scene as j_make_scene
from multi_spatialmllm_tpu.stages.coverage import (
    build_object_coverage as j_build_coverage,
)
from multi_spatialmllm_tpu.stages.coverage import (
    object_coverage_intervals as j_intervals,
)
from multi_spatialmllm_tpu.stages.frame_relations import (
    compute_scene_relations as j_relations,
)
from multi_spatialmllm_tpu.stages.object_visibility import (
    build_object_visibility as j_build_ovis,
)
from multi_spatialmllm_tpu.stages.visibility import (
    compute_scene_visibility as j_visibility,
)
from multi_spatialmllm_tpu_torch.dryrun import run_world
from test_torch_geometry import PITCH_ULP

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SCENES = 11
PDBS = (1, 4)


def scene_kwargs(i):
    return dict(scene_id=f"mcs{i:04d}_00", seed=90 + i,
                n_images=10 if i < 7 else 17, n_background=2000,
                n_objects=2, n_invalid_poses=i % 2)


def stage_rank(tmp: str) -> dict:
    """One process of a world: the four scene-parallel stages at each
    per-device batch, coverage of no scenes, and on the first process the
    single-device stages."""
    import torch.distributed as dist

    from multi_spatialmllm_tpu_torch.core.synthetic import make_scene
    from multi_spatialmllm_tpu_torch.parallel.mesh import make_mesh
    from multi_spatialmllm_tpu_torch.stages.coverage import (
        build_object_coverage,
        coverage_intervals_multichip,
        object_coverage_intervals,
    )
    from multi_spatialmllm_tpu_torch.stages.frame_relations import (
        compute_relations_multichip,
        compute_scene_relations,
    )
    from multi_spatialmllm_tpu_torch.stages.object_visibility import (
        build_object_visibility,
        object_visibility_multichip,
    )
    from multi_spatialmllm_tpu_torch.stages.visibility import (
        compute_scene_visibility,
        compute_visibility_multichip,
    )

    mesh = make_mesh()
    scenes = [make_scene(**scene_kwargs(i)) for i in range(N_SCENES)]
    out = {"empty": coverage_intervals_multichip([], mesh, {},
                                                 device="cpu")}
    for pdb in PDBS:
        vis = compute_visibility_multichip(scenes, mesh, per_device_batch=pdb,
                                           device="cpu")
        warn = os.path.join(tmp, f"warn_{dist.get_rank()}_{pdb}.txt")
        ovis = object_visibility_multichip(scenes, mesh, vis,
                                           warning_path=warn,
                                           per_device_batch=pdb,
                                           device="cpu")
        out[pdb] = dict(
            vis=vis,
            rel=compute_relations_multichip(scenes, mesh, vis,
                                            per_device_batch=pdb,
                                            device="cpu"),
            ovis=pickle.dumps(ovis),
            intervals=coverage_intervals_multichip(
                scenes, mesh, vis, per_device_batch=pdb, device="cpu"),
            coverage=pickle.dumps(build_object_coverage(
                scenes, ovis, visibility=vis, device="cpu", mesh=mesh)))
    if dist.get_rank() == 0:
        vis = {s.scene_id: compute_scene_visibility(s, device="cpu")
               for s in scenes}
        ovis = build_object_visibility(scenes, visibility=vis, device="cpu")
        out["single"] = dict(
            vis=vis,
            rel={s.scene_id: compute_scene_relations(
                s, vis=vis[s.scene_id], device="cpu") for s in scenes},
            ovis=pickle.dumps(ovis),
            intervals={s.scene_id: object_coverage_intervals(
                s, vis[s.scene_id], device="cpu") for s in scenes},
            coverage=pickle.dumps(build_object_coverage(
                scenes, ovis, visibility=vis, device="cpu")))
    return out


@pytest.fixture(scope="module")
def jax_single():
    """The JAX single-device stages on every scene (float64)."""
    scenes = [j_make_scene(**scene_kwargs(i)) for i in range(N_SCENES)]
    vis = {s.scene_id: j_visibility(s, np.float64) for s in scenes}
    ovis = j_build_ovis(scenes, visibility=vis)
    return dict(
        vis=vis,
        rel={s.scene_id: j_relations(s, vis=vis[s.scene_id],
                                     dtype=np.float64) for s in scenes},
        ovis=ovis,
        intervals={s.scene_id: j_intervals(s, vis[s.scene_id])
                   for s in scenes},
        coverage=j_build_coverage(scenes, ovis, visibility=vis))


@pytest.fixture(scope="module", params=[3, 2], ids=["world3", "world2"])
def world(request, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp(f"world{request.param}"))
    return request.param, tmp, run_world(
        request.param, "test_torch_multichip_stages:stage_rank", (tmp,),
        device="cpu", timeout=600)


def same_array(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return (got.dtype == want.dtype and got.shape == want.shape
            and got.tobytes() == want.tobytes())


def assert_equal_stages(got: dict, want: dict, jax: bool = False) -> None:
    """Scene by scene, byte for byte; against JAX (`jax`), the pitch
    within its ulp limit."""
    assert list(got["vis"]) == list(want["vis"])
    for sid, v in want["vis"].items():
        assert same_array(got["vis"][sid], v), sid
        assert set(got["rel"][sid]) == set(want["rel"][sid]), sid
        for k, r in want["rel"][sid].items():
            g = got["rel"][sid][k]
            if jax and k == "pitch":
                assert g.dtype == r.dtype and g.shape == r.shape, sid
                np.testing.assert_allclose(
                    g, r, rtol=0, atol=2 * PITCH_ULP * np.spacing(
                        r.dtype.type(90.0)), err_msg=sid)
            else:
                assert same_array(g, r), (sid, k)
        for g, w in zip(got["intervals"][sid], want["intervals"][sid]):
            assert same_array(g, w), sid
    assert got["ovis"] == want["ovis"]
    assert got["coverage"] == want["coverage"]


@pytest.mark.parametrize("pdb", PDBS)
def test_scene_parallel_stages_equal_jax_single_device(world, jax_single,
                                                       pdb):
    """Every process of the world returns every scene's visibility,
    relations, object visibility, coverage intervals and coverage search,
    byte-equal to the port's single-device stage and to JAX's."""
    n, tmp, results = world
    want = dict(jax_single, ovis=pickle.dumps(jax_single["ovis"]),
                coverage=pickle.dumps(jax_single["coverage"]))
    for rank, res in enumerate(results):
        assert_equal_stages(res[pdb], results[0]["single"])
        assert_equal_stages(res[pdb], want, jax=True)
        assert res["empty"] == {}, rank
    assert not any(os.path.exists(os.path.join(tmp, f"warn_{r}_{pdb}.txt"))
                   for r in range(1, n))


JAX_MULTICHIP = """
import pickle, sys
import jax
import numpy as np
from jax.sharding import Mesh
sys.path.insert(0, {tests!r})
from test_torch_multichip_stages import N_SCENES, scene_kwargs
from multi_spatialmllm_tpu.core.synthetic import make_scene
from multi_spatialmllm_tpu.stages.coverage import (
    build_object_coverage, coverage_intervals_multichip)
from multi_spatialmllm_tpu.stages.frame_relations import (
    compute_relations_multichip)
from multi_spatialmllm_tpu.stages.object_visibility import (
    object_visibility_multichip)
from multi_spatialmllm_tpu.stages.visibility import (
    compute_visibility_multichip)

assert len(jax.devices()) == 8, jax.devices()
mesh = Mesh(np.asarray(jax.devices()), ("data",))
scenes = [make_scene(**scene_kwargs(i)) for i in range(N_SCENES)]
vis = compute_visibility_multichip(scenes, mesh, per_device_batch=1)
ovis = object_visibility_multichip(scenes, mesh, vis, per_device_batch=1)
out = dict(
    vis=vis,
    rel=compute_relations_multichip(scenes, mesh, vis, per_device_batch=1),
    ovis=pickle.dumps(ovis),
    intervals=coverage_intervals_multichip(scenes, mesh, vis,
                                           per_device_batch=1),
    coverage=pickle.dumps(build_object_coverage(scenes, ovis, visibility=vis,
                                                mesh=mesh)))
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def jax_multichip(tmp_path_factory):
    """JAX's own four `*_multichip` functions on the 8-device virtual CPU
    mesh, at per_device_batch 1, in a subprocess (as
    `__graft_entry__._reexec_on_virtual_mesh` runs them)."""
    tmp_path = tmp_path_factory.mktemp("jax_multichip")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                            ""))
    out = tmp_path / "jax_multichip.pkl"
    proc = subprocess.run(
        [sys.executable, "-c", JAX_MULTICHIP.format(
            tests=os.path.join(REPO, "tests")), str(out)],
        env=env, capture_output=True, text=True, timeout=600, cwd=REPO)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    with open(out, "rb") as f:
        return pickle.load(f)


def test_scene_parallel_stages_equal_jax_multichip(world, jax_multichip):
    """Each world's results at per_device_batch 1 against JAX's
    `*_multichip` on its 8-device mesh."""
    for res in world[2]:
        assert_equal_stages(res[1], jax_multichip, jax=True)
