"""The port's process group and mesh (parallel/distributed.py,
parallel/mesh.py) against the JAX package's functions.

`initialize_multihost` in a world of 4 gloo processes on the CPU, from the
launcher's environment (`dryrun.run_world` sets it as
`torch.distributed.run` does) and again from explicit arguments; it is a
no-op when no world is asked for or a group exists, and it raises (where
the JAX function carries on alone) when an asked-for init fails.
`global_batch_slice` equals JAX's, from explicit arguments and from the
group. `make_mesh` gives JAX's axis names and sizes for the same counts
(JAX's on 4 virtual CPU devices, in a subprocess).
"""

import json
import os
import socket
import subprocess
import sys

import pytest
import torch.distributed as dist

from multi_spatialmllm_tpu.parallel import distributed as JD
from multi_spatialmllm_tpu_torch.dryrun import free_port, run_world
from multi_spatialmllm_tpu_torch.parallel import distributed as TD
from multi_spatialmllm_tpu_torch.parallel.mesh import data_axis, make_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
# (n_data, n_model, n_seq, n_expert) over 4 devices
MESHES = [(None, 1, 1, 1), (2, 2, 1, 1), (None, 2, 1, 1), (1, 1, 4, 1),
          (None, 1, 2, 2), (2, 1, 1, 2)]
SLICES = [8, 4, 12]


def world_rank(port: int) -> dict:
    """One process of the world of 4: the group from the environment,
    again from explicit arguments, and the meshes."""
    import torch

    env_group = (dist.get_rank(), dist.get_world_size(), dist.get_backend())
    before = dist.group.WORLD
    TD.initialize_multihost()              # a group exists: a no-op
    kept = dist.group.WORLD is before
    rank = dist.get_rank()
    dist.destroy_process_group()
    TD.initialize_multihost(f"localhost:{port}", WORLD, rank, device="cpu")
    t = torch.tensor([float(rank)])
    dist.all_reduce(t)
    meshes = []
    for n_data, n_model, n_seq, n_expert in MESHES:
        mesh = make_mesh(n_data=n_data, n_model=n_model, n_seq=n_seq,
                         n_expert=n_expert)
        _, r, size = data_axis(mesh)
        meshes.append((list(mesh.mesh_dim_names), list(mesh.shape), r, size,
                       mesh.device_type))
    return dict(env_group=env_group, kept=kept,
                arg_group=(dist.get_rank(), dist.get_world_size()),
                sum=float(t), meshes=meshes,
                slices=[TD.global_batch_slice(g) for g in SLICES],
                shard=TD.host_shard(list(range(10))))


@pytest.fixture(scope="module")
def world():
    return run_world(WORLD, "test_torch_distributed:world_rank",
                     (free_port(),), device="cpu", timeout=300)


def test_initialize_multihost_in_a_world_of_four(world):
    for rank, res in enumerate(world):
        assert res["env_group"] == (rank, WORLD, "gloo")
        assert res["kept"]
        assert res["arg_group"] == (rank, WORLD)
        assert res["sum"] == sum(range(WORLD))


def test_global_batch_slice_and_host_shard_follow_the_group(world):
    for rank, res in enumerate(world):
        assert res["slices"] == [JD.global_batch_slice(g, rank, WORLD)
                                 for g in SLICES]
        assert res["shard"] == JD.host_shard(list(range(10)), rank, WORLD)


JAX_MESHES = """
import json, sys
import jax
from multi_spatialmllm_tpu.parallel.mesh import make_mesh
out = []
for n_data, n_model, n_seq, n_expert in json.loads(sys.argv[1]):
    m = make_mesh(n_data=n_data, n_model=n_model, n_seq=n_seq,
                  n_expert=n_expert)
    out.append([list(m.axis_names), [m.shape[a] for a in m.axis_names]])
print(json.dumps(out))
"""


def test_make_mesh_axes_equal_jax(world):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={WORLD}",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                            ""))
    proc = subprocess.run([sys.executable, "-c", JAX_MESHES,
                           json.dumps(MESHES)], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = json.loads(proc.stdout.splitlines()[-1])
    for rank, res in enumerate(world):
        for (names, shape, r, size, dev), (j_names, j_shape) in zip(
                res["meshes"], want):
            assert (names, shape) == (j_names, j_shape)
            assert size == shape[0] and dev == "cpu"
            # the data axis is the slowest-varying: ranks in blocks
            assert r == rank // (WORLD // shape[0])


@pytest.mark.parametrize("g,pi,pc", [(8, 0, 1), (8, 1, 2), (12, 2, 3),
                                     (6, 5, 6)])
def test_global_batch_slice_equals_jax(g, pi, pc):
    assert TD.global_batch_slice(g, pi, pc) == JD.global_batch_slice(g, pi,
                                                                     pc)


def test_global_batch_slice_keeps_the_divisibility_check():
    with pytest.raises(AssertionError):
        TD.global_batch_slice(9, 0, 2)


def test_no_world_asked_is_a_no_op(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    TD.initialize_multihost()
    assert not dist.is_initialized()
    assert TD.global_batch_slice(8) == (0, 8)


def test_a_failed_init_raises():
    """An asked-for world whose rendezvous cannot start (its address is
    taken) raises; so does NCCL on a host without a card. The JAX function
    would carry on as one process."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        s.listen()
        port = s.getsockname()[1]
        with pytest.raises(RuntimeError, match="address already in use"):
            TD.initialize_multihost(f"localhost:{port}", 1, 0, device="cpu")
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="CUDA"):
        TD.initialize_multihost(f"localhost:{free_port()}", 1, 0,
                                device="cuda")
    assert not dist.is_initialized()


def test_make_mesh_needs_a_group():
    with pytest.raises(RuntimeError, match="initialize_multihost"):
        make_mesh()


def test_dryrun_on_the_card_needs_its_cards():
    """`dryrun_multichip` runs on the card unless the CPU is asked for: with
    too few cards it raises before it starts a process."""
    from multi_spatialmllm_tpu_torch.dryrun import dryrun_multichip

    with pytest.raises(RuntimeError, match="needs 2 cards"):
        dryrun_multichip(2)
    assert not dist.is_initialized()
