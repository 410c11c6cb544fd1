"""Mixture-of-Experts FFN in PyTorch: top-k routed SwiGLU experts.

Port of multi_spatialmllm_tpu/models/moe.py (its module docstring has the
design). Two implementations, chosen by `cfg.moe_impl`:

* "einsum": GShard dense dispatch. Per batch row, each token's top-k
  experts queue into buffers of `moe_capacity` slots (cumsum order; tokens
  past the capacity are dropped and fall back to the residual), and the
  dispatch/combine tensors contract tokens into per-expert buffers with
  plain einsums. Training with `moe_group = g` routes in groups of g
  tokens (capacity binds per group); inference routes whole chunks, with
  the no-drop capacity for chunks up to NO_DROP_MAX_T tokens.
* "ragged": dropless. Token copies are stable-sorted by expert and the
  three SwiGLU projections run as grouped products over the sorted rows:
  `moe_kernel="pallas"` takes the K8 op (`ops/grouped_matmul`, the CUDA
  kernels on the card), `"xla"` a per-group `torch.matmul` loop (the port
  of XLA's lowering of `lax.ragged_dot`).

Padding tokens (`valid` False) take no capacity and leave the load-balance
statistic. The statistic (aux) is returned beside the output, not stored
on the module, so a layer recomputed under `torch.utils.checkpoint` still
reports it once. Under data parallelism (`data_parallel`) the statistic is
the whole global batch's, as the JAX step computes it over the batch it
shards: each process returns its share of it (see `_topk_select`).

Parameters keep the JAX layouts and names: `router` `[D, E]` (float32),
`wi_gate`/`wi_up` `[E, D, F]` and `wo` `[E, F, D]`; they are cast to the
compute dtype at use, as the Flax module casts its float32 params.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..ops.grouped_matmul import grouped_matmul
from ..parallel.sharding import (
    all_to_all_autograd,
    tp_region_enter,
    tp_region_exit,
)
from .quantize import dequantized

# Inference chunks up to this length route with a no-drop capacity
# (C = top_k * T).
NO_DROP_MAX_T = 512


def moe_capacity(cfg, seq_len: int, inference: bool = False) -> int:
    """Per-batch-row expert capacity (host math on the static length)."""
    if inference and seq_len <= NO_DROP_MAX_T:
        return max(int(cfg.moe_top_k * seq_len), 1)
    c = math.ceil(cfg.moe_top_k * seq_len * cfg.moe_capacity
                  / cfg.moe_experts)
    return max(int(c), 1)


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """float32 one-hot of integer `idx`; out-of-range indices give an
    all-zero row (as `jax.nn.one_hot` does)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def _topk_select(logits: torch.Tensor, top_k: int,
                 vmask: torch.Tensor | None, group=None):
    """Per-token top-k selection: logits `[N, E]` (f32), vmask `[N]` f32
    or None -> (idx `[N, k]` int32, gates `[N, k]` f32 renormalised to sum
    to 1 and zeroed on pads, aux: the load-balance statistic over real
    tokens). The gate is a max (`amax` shares its gradient among ties, as
    `jnp.max` does); `argmax` picks the first maximum, as `jnp.argmax`.

    With a process `group` the statistic is over the tokens of all its
    processes: the first-choice counts and the real-token count are
    summed over the group (no gradient flows through either), and this
    process's probability sums are divided by the global count. The aux
    returned is this process's share, `e * sum(route_frac *
    local prob sum / global count)`: the shares add up to the global
    statistic, and each share's gradient is the global statistic's
    gradient with respect to this process's tokens, so a sum of the
    processes' losses and gradients is the global batch's."""
    e = logits.shape[1]
    probs = torch.softmax(logits.float(), dim=-1)
    masked = probs
    idxs, gates = [], []
    for _ in range(top_k):
        i = torch.argmax(masked, dim=-1)
        idxs.append(i.to(torch.int32))
        gates.append(torch.amax(masked, dim=-1))
        masked = masked * (1.0 - _one_hot(i, e))
    denom = sum(gates) + 1e-9
    gate_mat = torch.stack([g / denom for g in gates], dim=1)

    oh0 = _one_hot(idxs[0], e)
    if vmask is None and group is None:
        route_frac = oh0.mean(dim=0)
        prob_frac = probs.mean(dim=0)
    else:
        weights = probs.new_ones(probs.shape[0]) if vmask is None else vmask
        if vmask is not None:
            gate_mat = gate_mat * vmask[:, None]
        with torch.no_grad():
            stats = torch.cat([(oh0 * weights[:, None]).sum(dim=0),
                               weights.sum().reshape(1)])
            if group is not None:
                dist.all_reduce(stats, group=group)
        n_valid = stats[e].clamp_min(1.0)
        route_frac = stats[:e] / n_valid
        prob_frac = (probs * weights[:, None]).sum(dim=0) / n_valid
    aux = (route_frac * prob_frac).sum() * e
    return torch.stack(idxs, dim=1), gate_mat, aux


def top_k_routing(logits: torch.Tensor, top_k: int, capacity: int,
                  valid: torch.Tensor | None = None, group=None):
    """GShard dispatch: logits `[B, T, E]` (f32), optional `valid` `[B, T]`
    -> (dispatch `[B, T, E, C]` 0/1 f32, combine (gate-weighted dispatch),
    aux). k-th choices queue after the (k-1)-th, cumsum along T."""
    b, t, e = logits.shape
    vflat = None if valid is None else valid.reshape(b * t).float()
    idx, gate_mat, aux = _topk_select(logits.reshape(b * t, e), top_k,
                                      vflat, group)
    idx = idx.reshape(b, t, top_k)
    gate_mat = gate_mat.reshape(b, t, top_k)
    vmask = None if valid is None else valid.float()[..., None]

    counts = torch.zeros(b, 1, e, device=logits.device)
    dispatch = torch.zeros(b, t, e, capacity, device=logits.device)
    combine = torch.zeros_like(dispatch)
    for j in range(top_k):
        oh = _one_hot(idx[:, :, j], e)
        if vmask is not None:
            oh = oh * vmask                 # pads select nothing
        pos = torch.cumsum(oh, dim=1) - oh + counts
        counts = counts + oh.sum(dim=1, keepdim=True)
        keep = (pos < capacity).float() * oh
        d = keep[..., None] * _one_hot(pos.long(), capacity)
        dispatch = dispatch + d
        combine = combine + gate_mat[:, :, j, None, None] * d
    return dispatch, combine, aux


def expert_counts(ei: torch.Tensor, e: int) -> torch.Tensor:
    """Token copies routed to each of the `e` experts, int32 `[e]` (the
    JAX path's `jnp.bincount(ei, length=e)`), counted on ei's device:
    `torch.bincount` on a CUDA tensor reads its input's max on the host
    to size its output, a sync a MoE layer."""
    return (ei[:, None] == torch.arange(e, device=ei.device)).sum(
        dim=0, dtype=torch.int32)


def ragged_dot_xla(xs, w, group_sizes):
    """`lax.ragged_dot` as XLA lowers it: one product per group over its
    rows (rows past the groups' total are zero), in xs's dtype. Reads the
    group sizes on the host."""
    out, start = [], 0
    for g, size in enumerate(group_sizes.tolist()):
        out.append(xs[start:start + size] @ w[g])
        start += size
    tail = xs.new_zeros(xs.shape[0] - start, w.shape[-1])
    return torch.cat(out + [tail], dim=0)


def _grouped_dot(xs, w, group_sizes, kernel: str = "xla"):
    """`xs[rows of g] @ w[g]` for each group: the ragged impl's product."""
    if kernel == "xla":
        return ragged_dot_xla(xs, w, group_sizes)
    if kernel != "pallas":
        raise ValueError(f"unknown moe_kernel {kernel!r}")
    return grouped_matmul(xs, w, group_sizes.to(torch.int32))


def ragged_moe(cfg, x, router, wi_gate, wi_up, wo,
               valid: torch.Tensor | None = None, group=None, tp=None):
    """Dropless sorted-gather MoE: x `[B, T, D]` -> (y `[B, T, D]`, aux).
    The stable sort keeps (token, k) order within an expert, so outputs do
    not depend on how tokens are batched or chunked. `tp`: the model
    axis's place, the tables holding its share of the FFN dimension (the
    expert outputs are summed over the axis before the gates weigh
    them)."""
    dtype = getattr(torch, cfg.dtype)
    b, t, d = x.shape
    k, e = cfg.moe_top_k, cfg.moe_experts
    n = b * t
    xf = x.reshape(n, d)
    vmask = None if valid is None else valid.reshape(n).float()

    logits = xf.float() @ router.float()
    idx, gates, aux = _topk_select(logits, k, vmask, group)

    ei = idx.reshape(n * k).long()
    order = torch.argsort(ei, stable=True)
    if tp is not None:       # the experts' input enters the TP region
        xf = tp_region_enter(xf, tp.group)
    xs = xf[order // k].to(dtype)
    group_sizes = expert_counts(ei, e)

    def gd(a, w):
        return _grouped_dot(a, w.to(dtype), group_sizes, cfg.moe_kernel)

    hg = gd(xs, wi_gate)
    hu = gd(xs, wi_up)
    ys = gd(F.silu(hg) * hu, wo)
    if tp is not None:
        ys = tp_region_exit(ys, tp.group)
    inv = torch.argsort(order, stable=True)
    yk = ys[inv].reshape(n, k, d)
    y = (yk * gates.to(dtype)[..., None]).sum(dim=1)
    return y.reshape(b, t, d).to(dtype), aux


class MoEMLP(nn.Module):
    """Drop-in replacement for `llm.MLP` when `cfg.moe_experts > 0`;
    `forward` returns `(y, aux)`. `group`: the process group whose batch
    the load-balance statistic is taken over (`data_parallel`), None for
    this process's batch alone.

    On a mesh (parallel/sharding.shard_model) `tp` is the model axis's
    place (the tables hold its share of the FFN dimension; the experts'
    input enters a TP region, the router's does not, and the expert
    outputs are summed over the axis before the combine, so the gates'
    gradient is whole on every process)
    and `ep` the expert axis's (the einsum impl's tables hold
    `E / n_expert` experts: the `[E, B, C, D]` dispatch buffer goes to the
    experts' owners with an all-to-all over "expert" and comes back with
    another; routing stays per row). The ragged impl has no expert-axis
    form, as in JAX (parallel/sharding.check_moe_mesh refuses it)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.cfg = cfg
        self.group = None
        self.tp = None
        self.ep = None
        d, e, f = cfg.hidden_size, cfg.moe_experts, cfg.ffn_size
        dtype = getattr(torch, cfg.dtype)
        self.compute_dtype = dtype
        self.router = nn.Parameter(
            torch.zeros(d, e, dtype=torch.float32, device=device))
        self.wi_gate = nn.Parameter(
            torch.zeros(e, d, f, dtype=dtype, device=device))
        self.wi_up = nn.Parameter(
            torch.zeros(e, d, f, dtype=dtype, device=device))
        self.wo = nn.Parameter(torch.zeros(e, f, d, dtype=dtype,
                                           device=device))

    def forward(self, x, valid=None, inference: bool = False, lora=None):
        cfg = self.cfg
        if lora is not None and any(n in lora.get("tables", {})
                                    for n in ("gate", "up", "down")):
            # serving adapters target the dense SwiGLU weights; ignoring
            # them here would serve an un-adapted FFN as adapted
            raise ValueError(
                "LoRA adapters target dense MLP kernels (gate/up/down); "
                "this model's FFN is a routed MoE — attention-only "
                "adapters are supported, MLP adapters are not")
        router, wi_gate, wi_up, wo = (dequantized(self, n) for n in
                                      ("router", "wi_gate", "wi_up", "wo"))
        if cfg.moe_impl == "ragged":
            return ragged_moe(cfg, x, router, wi_gate, wi_up,
                              wo, valid=valid, group=self.group, tp=self.tp)
        dtype = getattr(torch, cfg.dtype)
        b, t, d = x.shape
        # GShard groups (training only); inference routes whole chunks
        g = cfg.moe_group
        if (not inference) and 0 < g < t and t % g != 0:
            raise ValueError(
                f"moe_group={g} must divide the training sequence length "
                f"(got T={t}); pick a divisor or 0 for whole-row routing")
        if (not inference) and 0 < g < t:
            xr = x.reshape(b * (t // g), g, d)
            vr = None if valid is None else valid.reshape(b * (t // g), g)
        else:
            xr, vr = x, valid
        cap = moe_capacity(cfg, xr.shape[1], inference=inference)
        logits = torch.einsum("btd,de->bte", xr.float(), router.float())
        dispatch, combine, aux = top_k_routing(logits, cfg.moe_top_k, cap,
                                               valid=vr, group=self.group)
        if self.tp is not None:
            # the experts' input enters the TP region (its gradient is
            # partial over the FFN shards); the router's does not (the
            # gates' gradient is whole on every process)
            xr = tp_region_enter(xr, self.tp.group)
        xin = torch.einsum("btec,btd->ebcd", dispatch.to(dtype),
                           xr.to(dtype))
        ep = None if self.ep is None else self.ep.group
        # [E, B, C, D] -> [E / n, n * B, C, D]: each process's experts get
        # the rows of every process of the expert axis
        xin = all_to_all_autograd(xin, ep, 0, 1)
        gate = torch.einsum("ebcd,edf->ebcf", xin, wi_gate.to(dtype))
        up = torch.einsum("ebcd,edf->ebcf", xin, wi_up.to(dtype))
        out = torch.einsum("ebcf,efd->ebcd", F.silu(gate) * up,
                           wo.to(dtype))
        out = all_to_all_autograd(out, ep, 1, 0)
        if self.tp is not None:
            out = tp_region_exit(out, self.tp.group)
        y = torch.einsum("btec,ebcd->btd", combine.to(dtype), out)
        return y.reshape(b, t, d).to(dtype), aux


@contextlib.contextmanager
def data_parallel(model: nn.Module, group):
    """Within the block every routed FFN of `model` takes its load-balance
    statistic over the global batch of `group`'s processes (each returns
    its share of it); a no-op when `group` is None. The train steps hold
    it around the forward and the backward, so a recomputed layer sees the
    same group."""
    mods = [m for m in model.modules() if isinstance(m, MoEMLP)]
    for m in mods:
        m.group = group
    try:
        yield
    finally:
        for m in mods:
            m.group = None
