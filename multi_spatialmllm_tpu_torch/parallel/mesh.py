"""Device mesh over the processes of the default group (the port of
multi_spatialmllm_tpu/parallel/mesh.py).

The JAX mesh lays devices out on named axes: "data" carries batch (and
scene) parallelism, "model" tensor parallelism, and "seq"/"expert" the
sequence and expert axes when they are above 1. Here each device is one
process of the `torch.distributed` default group (`initialize_multihost`),
and the mesh is a `DeviceMesh` with the same axis names in the same order.
Code that runs over an axis takes its group, this process's coordinate and
its size from the helper of that axis (`data_axis`, `model_axis`,
`seq_axis`, `expert_axis`; the pipeline's "pipe" axis through `mesh_axis`,
its mesh from parallel/pipeline_parallel.make_pipe_mesh), and a group over
several axes at once from `axes_group`.

Not ported: `shard_map_compat`, `data_sharding` and `replicated`. They
place arrays on a JAX mesh for XLA's partitioner; a process here holds its
own share and calls the collectives itself.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
EXPERT_AXIS = "expert"
PIPE_AXIS = "pipe"


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


def mesh_axis(mesh, name: str) -> tuple:
    """(group, this process's coordinate, size) of the mesh axis `name`;
    (None, 0, 1) without a mesh, when the mesh lacks the axis, or when the
    axis has one process (nothing to exchange: the code of the axis is
    skipped and a step is the one without it, bit for bit)."""
    if mesh is None or name not in mesh.mesh_dim_names:
        return None, 0, 1
    size = mesh.size(mesh.mesh_dim_names.index(name))
    if size == 1:
        return None, 0, 1
    return mesh.get_group(name), mesh.get_local_rank(name), size


def model_axis(mesh) -> tuple:
    """`mesh_axis` of "model": the tensor-parallel axis."""
    return mesh_axis(mesh, MODEL_AXIS)


def seq_axis(mesh) -> tuple:
    """`mesh_axis` of "seq": the ring-attention axis."""
    return mesh_axis(mesh, SEQ_AXIS)


def expert_axis(mesh) -> tuple:
    """`mesh_axis` of "expert": the expert-parallel axis."""
    return mesh_axis(mesh, EXPERT_AXIS)


def axes_group(mesh, names) -> tuple:
    """(group, coordinate, size) over the mesh axes `names` taken together
    (those the mesh carries with more than one process; the coordinate
    orders them as the mesh does): one axis's own group, or a group made
    for the combination. Every process of the mesh makes every
    combination's groups at the first call, in one order, as
    `torch.distributed.new_group` needs; they are kept on the mesh."""
    names = [n for n in (mesh.mesh_dim_names if mesh is not None else ())
             if n in names and mesh_axis(mesh, n)[2] > 1]
    if not names:
        return None, 0, 1
    if len(names) == 1:
        return mesh_axis(mesh, names[0])
    groups = getattr(mesh, "_axes_groups", None)
    if groups is None:
        groups = mesh._axes_groups = _make_axes_groups(mesh)
    return groups[tuple(names)]


def _make_axes_groups(mesh) -> dict:
    """Every combination of two or more of the mesh's axes (of more than
    one process) -> (this process's group, coordinate, size)."""
    import itertools

    import torch.distributed as dist

    dims = [i for i, _ in enumerate(mesh.mesh_dim_names) if mesh.size(i) > 1]
    ranks = mesh.mesh
    me = dist.get_rank()
    out = {}
    for k in range(2, len(dims) + 1):
        for combo in itertools.combinations(dims, k):
            rest = [i for i in range(ranks.dim()) if i not in combo]
            table = ranks.permute(*rest, *combo).reshape(
                -1, int(np.prod([ranks.shape[i] for i in combo])))
            subgroups = [dist.new_group(row.tolist()) for row in table]
            for row, g in zip(table.tolist(), subgroups):
                if me in row:
                    out[tuple(mesh.mesh_dim_names[i] for i in combo)] = (
                        g, row.index(me), len(row))
    return out
