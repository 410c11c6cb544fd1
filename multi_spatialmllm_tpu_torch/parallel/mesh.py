"""Device mesh over the processes of the default group (the port of
multi_spatialmllm_tpu/parallel/mesh.py).

The JAX mesh lays devices out on named axes: "data" carries batch (and
scene) parallelism, "model" tensor parallelism, and "seq"/"expert" the
sequence and expert axes when they are above 1. Here each device is one
process of the `torch.distributed` default group (`initialize_multihost`),
and the mesh is a `DeviceMesh` with the same axis names in the same order.
Code that runs over an axis takes its group, this process's coordinate and
its size from the mesh (`mesh.get_group("data")`,
`mesh.get_local_rank("data")`, `mesh.size(0)`).

Not ported: `shard_map_compat`, `data_sharding` and `replicated`. They
place arrays on a JAX mesh for XLA's partitioner; a process here holds its
own share and calls the collectives itself.
"""

from __future__ import annotations

from typing import Sequence

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
EXPERT_AXIS = "expert"


def make_mesh(n_data: int | None = None, n_model: int = 1,
              devices: Sequence[int] | None = None, n_seq: int = 1,
              n_expert: int = 1):
    """Mesh over the default group's ranks (`devices`, by default all of
    them, in rank order); defaults to all-data. `n_data=None` fills the
    ranks left by the other axes. Needs an initialised default group; its
    backend sets the mesh's device type (NCCL: cuda, gloo: cpu)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "parallel.distributed.initialize_multihost first")
    ranks = list(range(dist.get_world_size()) if devices is None
                 else devices)
    extra = n_model * n_seq * n_expert
    if n_data is None:
        n_data = len(ranks) // extra
    if n_data * extra != len(ranks):
        raise ValueError(f"{n_data}x{n_model}x{n_seq}x{n_expert} != "
                         f"{len(ranks)} devices")
    axes = [(DATA_AXIS, n_data), (MODEL_AXIS, n_model)]
    if n_seq > 1:
        axes.append((SEQ_AXIS, n_seq))
    if n_expert > 1:
        axes.append((EXPERT_AXIS, n_expert))
    shape = tuple(n for _, n in axes)
    names = tuple(name for name, _ in axes)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if devices is None:
        return init_device_mesh(device_type, shape, mesh_dim_names=names)
    return DeviceMesh(device_type, torch.tensor(ranks).reshape(shape),
                      mesh_dim_names=names)


def data_axis(mesh) -> tuple:
    """(group, this process's coordinate, size) of the mesh's leading
    axis, the one batches and scenes shard over; (None, 0, 1) without a
    mesh."""
    if mesh is None:
        return None, 0, 1
    name = mesh.mesh_dim_names[0]
    return mesh.get_group(name), mesh.get_local_rank(name), mesh.size(0)
