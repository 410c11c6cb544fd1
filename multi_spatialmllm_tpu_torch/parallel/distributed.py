"""Host-sharded data loading (the port of
multi_spatialmllm_tpu/parallel/distributed.py's `host_shard`).

The data engine's stages need no communication between processes: scenes
shard across processes by a stable round-robin, the share-nothing unit of
the reference (a Pool over scenes plus bash range sharding, SURVEY.md
§2.5). A process's rank and the world size come from `torch.distributed`
when a process group is initialised, and are (0, 1) otherwise.
"""

from __future__ import annotations

from typing import Sequence, TypeVar

T = TypeVar("T")


def host_shard(items: Sequence[T],
               process_index: int | None = None,
               process_count: int | None = None) -> list[T]:
    """The slice of `items` this process owns (stable round-robin by
    index): item i belongs to process i % count."""
    import torch.distributed as dist

    grouped = dist.is_available() and dist.is_initialized()
    pi = process_index if process_index is not None else (
        dist.get_rank() if grouped else 0)
    pc = process_count if process_count is not None else (
        dist.get_world_size() if grouped else 1)
    return [item for i, item in enumerate(items) if i % pc == pi]
