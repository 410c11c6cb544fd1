"""Multi-process initialization and host-sharded data loading (the port of
multi_spatialmllm_tpu/parallel/distributed.py).

`initialize_multihost` starts the default `torch.distributed` process group
(the counterpart of `jax.distributed.initialize`), with NCCL when the
process computes on CUDA and gloo on the CPU. The data engine's stages
shard scenes across processes by a stable round-robin (`host_shard`), the
share-nothing unit of the reference (a Pool over scenes plus bash range
sharding, SURVEY.md §2.5); the scene-parallel stages and the
data-parallel train step exchange over the group. A process's rank and
the world size come from the group when one is initialised, and are
(0, 1) otherwise.
"""

from __future__ import annotations

import datetime
import os
from typing import Sequence, TypeVar

T = TypeVar("T")

# how long a rank waits for the others at the group's rendezvous and at
# each collective before it raises
GROUP_TIMEOUT = datetime.timedelta(minutes=10)


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device="cuda",
) -> None:
    """Initialise the default process group of `num_processes` processes
    (this one `process_id`) that meet at `coordinator_address`
    ("host:port"). An argument left out is read from the launcher's
    environment (`python -m torch.distributed.run` sets `WORLD_SIZE`,
    `RANK`, `MASTER_ADDR`, `MASTER_PORT`, and `LOCAL_RANK`).

    A no-op when no world is asked for (no `num_processes` and no
    `WORLD_SIZE`) or a group already exists. The backend follows
    `device`: NCCL for CUDA, with this process on card `LOCAL_RANK`, and
    gloo for the CPU.

    Departure from the JAX function, which swallows the `ValueError` and
    `RuntimeError` of `jax.distributed.initialize` and carries on alone:
    here an init that was asked for and fails raises, since a process
    that carried on alone would train or label on its own share as if it
    were the whole.
    """
    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        return
    env = os.environ
    if num_processes is None and not env.get("WORLD_SIZE"):
        return
    world = int(env["WORLD_SIZE"]) if num_processes is None \
        else num_processes
    rank = int(env["RANK"]) if process_id is None else process_id
    if coordinator_address is None:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a process group on CUDA (NCCL) needs a CUDA "
                               "device, and none is available")
        backend = "nccl"
        torch.cuda.set_device(int(env.get("LOCAL_RANK", "0")))
    else:
        backend = "gloo"
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=world, rank=rank,
                            timeout=GROUP_TIMEOUT)


def _rank_and_world(process_index, process_count) -> tuple[int, int]:
    import torch.distributed as dist

    grouped = dist.is_available() and dist.is_initialized()
    pi = process_index if process_index is not None else (
        dist.get_rank() if grouped else 0)
    pc = process_count if process_count is not None else (
        dist.get_world_size() if grouped else 1)
    return pi, pc


def host_shard(items: Sequence[T],
               process_index: int | None = None,
               process_count: int | None = None) -> list[T]:
    """The slice of `items` this process owns (stable round-robin by
    index): item i belongs to process i % count."""
    pi, pc = _rank_and_world(process_index, process_count)
    return [item for i, item in enumerate(items) if i % pc == pi]


def global_batch_slice(global_batch: int,
                       process_index: int | None = None,
                       process_count: int | None = None) -> tuple[int, int]:
    """(start, size) of this process's rows in a globally-batched array."""
    pi, pc = _rank_and_world(process_index, process_count)
    assert global_batch % pc == 0, (global_batch, pc)
    per = global_batch // pc
    return pi * per, per
