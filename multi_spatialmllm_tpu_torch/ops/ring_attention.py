"""Ring attention: causal attention over a sequence-sharded mesh axis (the
port of multi_spatialmllm_tpu/ops/ring_attention.py).

Each process of the "seq" axis holds one block of the sequence, q/k/v
`[B, H, S/n, D]` (k/v at their kv width: the JAX function repeats them to
the query heads first; the result is the same and the ring carries a
quarter of the bytes at GQA 4:1). Over n steps it attends to the kv block
it holds, then passes that block to the next process of the ring
(`parallel/sharding.ring_pass`). Causality is per pair of blocks, as
`_block_mask` in JAX: the diagonal block is causal, earlier blocks are
attended in full, later blocks are skipped.

Every block goes through the port's flash op (`ops/attention.py`: K1 on
CUDA, its plain version on the CPU), `causal=True` on the diagonal block
and False on earlier ones; the blocks' `(o, lse)` are merged in float32.
The backward is flash-style, as JAX's `_ring_core_bwd`: it saves only q,
k, v and the merged output and logsumexp, and runs one more ring pass in
which each block's backward (`flash_attention_bwd`: K2/K3 on CUDA) is fed
the MERGED `o` and `lse`, so the probabilities it re-makes are the exact
global ones; the dk/dv partial sums ride the ring with their kv block and
come home after n passes.

`ring_context(mesh)` marks a train step's forward and backward as running
over the mesh's "seq" axis; models/llm.py's attention reads
`active_ring_mesh()` to take the ring (or, for packed rows, to gather the
sequence and take K1's packed path: `seq_gathered_packed_attention`).
"""

from __future__ import annotations

import torch

from ..parallel.mesh import SEQ_AXIS, seq_axis
from .attention import (
    flash_attention_bwd,
    flash_attention_fwd,
    trainable_flash_attention,
    trainable_flash_attention_packed,
)

_ACTIVE_RING: list = [None]


class ring_context:
    """Within the block, attention without a cache runs over the mesh's
    "seq" axis (a no-op without one, or with one process on it)."""

    def __init__(self, mesh):
        group, rank, n = seq_axis(mesh)
        self.ring = (group, rank, n) if group is not None else None

    def __enter__(self):
        _ACTIVE_RING.append(self.ring)
        return self.ring

    def __exit__(self, *exc):
        _ACTIVE_RING.pop()
        return False


def active_ring_mesh():
    """The active ring `(group, rank, n)`, or None."""
    return _ACTIVE_RING[-1]


def _merge(o_acc, lse_acc, o, lse):
    """Two partial softmax results over disjoint keys, merged in f32."""
    new = torch.logaddexp(lse_acc, lse)
    o_acc = (o_acc * torch.exp(lse_acc - new)[..., None]
             + o.float() * torch.exp(lse - new)[..., None])
    return o_acc, new


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, rank, n):
        from ..parallel.sharding import ring_pass

        o_acc = lse_acc = None
        k_cur, v_cur = k, v
        for t in range(n):
            src = (rank - t) % n          # the block's origin on the ring
            if src <= rank:               # later blocks are masked out
                o, lse = flash_attention_fwd(q, k_cur, v_cur, src == rank)
                if o_acc is None:
                    o_acc, lse_acc = o.float(), lse
                else:
                    o_acc, lse_acc = _merge(o_acc, lse_acc, o, lse)
            if t < n - 1:
                k_cur, v_cur = ring_pass([k_cur, v_cur], group)
        out = o_acc.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse_acc)
        ctx.ring = (group, rank, n)
        return out

    @staticmethod
    def backward(ctx, do):
        from ..parallel.sharding import ring_pass

        q, k, v, out, lse = ctx.saved_tensors
        group, rank, n = ctx.ring
        do = do.contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros_like(dk)
        k_cur, v_cur = k, v
        for t in range(n):
            src = (rank - t) % n
            if src <= rank:
                dq_t, dk_t, dv_t = flash_attention_bwd(
                    q, k_cur, v_cur, out, lse, do, src == rank)
                dq += dq_t.float()
                dk += dk_t.float()
                dv += dv_t.float()
            # dk/dv travel with their kv block; after n passes (one more
            # than k/v take) they are back at their origin
            if t < n - 1:
                k_cur, v_cur, dk, dv = ring_pass([k_cur, v_cur, dk, dv],
                                                 group)
            else:
                dk, dv = ring_pass([dk, dv], group)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   ring) -> torch.Tensor:
    """Causal attention over the ring `(group, rank, n)` (`ring_context`'s,
    or parallel/mesh.seq_axis of a mesh): q `[B, H, S/n, D]` is this process's block of the
    sequence, k/v `[B, KVH, S/n, D]` its kv block (GQA native); returns
    this block's output. Differentiable (see the module docstring). The
    scale is `D ** -0.5`, the flash op's."""
    group, rank, n = ring
    if n == 1:
        return trainable_flash_attention(q, k, v, True)
    return _Ring.apply(q, k, v, group, rank, n)


def seq_gathered_packed_attention(q, k, v, segment_ids, ring):
    """Packed rows under a ring: the blocks of q/k/v and of the segment
    ids are gathered over the ring (the gradient reduce-scattered back),
    the packed flash op runs on the whole rows, and this block's rows of
    the output come back."""
    from ..parallel.sharding import all_gather, fsdp_gather

    group, rank, n = ring
    blk = q.shape[2]
    qf, kf, vf = (fsdp_gather(t.contiguous(), group, 2) for t in (q, k, v))
    seg = all_gather(segment_ids.contiguous(), group, 1)
    out = trainable_flash_attention_packed(qf, kf, vf, seg, True)
    return out[:, :, rank * blk:(rank + 1) * blk]


def make_seq_mesh(n_seq: int | None = None, devices=None):
    """1-D mesh over the sequence axis (context parallelism) over the
    default group's ranks (`devices`, all of them by default)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    ranks = list(range(dist.get_world_size()) if devices is None
                 else devices)
    if n_seq is not None:
        ranks = ranks[:n_seq]
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.tensor(ranks),
                      mesh_dim_names=(SEQ_AXIS,))
