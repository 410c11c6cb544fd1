"""Pipeline parallelism over the mesh's "pipe" axis: microbatched layer
execution and interleaved-1F1B training (the port of
multi_spatialmllm_tpu/parallel/pipeline_parallel.py).

The layer stack is split into `P` contiguous stages; stage `s` is the
process at coordinate `s` of the "pipe" axis (its group from
`mesh.mesh_axis(mesh, "pipe")`). Stage parameters are stacked `[P,
layers_per_stage, ...]` (`stack_stage_params`) and a process reads only its
slice `[stage]`. Every process runs the same tick schedule and passes
activations to the next stage and cotangents to the previous one, each tick's
sends and receives in one `batch_isend_irecv` (parallel/sharding.exchange);
both ends derive every transfer from the schedule, never from data.

* `pipeline_forward`: GPipe forward for inference, `M + P - 1` ticks; the
  last stage's outputs reach every process.
* `pipeline_train_grads` / `pipeline_train_grads_full`: interleaved 1F1B.
  At tick t stage s forwards microbatch `f = t - s` and backwards `b = t -
  (2P - 1 - s)`; `M + 2(P - 1) + 1` ticks. The forward slot runs under
  `torch.no_grad()` and stashes its input; the backward slot re-runs the
  stage with grad from the stashed input and pulls the gradients through it
  (only inputs are stashed: the Megatron memory recipe). The last stage seeds
  its backward from `head_loss / M` and ignores the chain; its forward slot
  only stashes (the JAX schedule's output there feeds nothing). Bubbles are
  skipped. Parameter gradients accumulate in float32 in microbatch order,
  the loss sums in float32 on the last stage.

Departures from the JAX functions: the layer and head parameters are flat
dicts of tensors (`{name: tensor}`), not pytrees; `x` and `y` are tensors
whose dimension 1 holds a microbatch's rows, and with a "data" axis a
process takes its rows of each microbatch (`global_batch_slice`, as JAX's
`batch_spec` shards them), so `dx_inputs` holds this process's rows. A
tensor-parallel `apply_layer` calls `tp_region_enter` / `tp_region_exit`
(parallel/sharding.py, re-exported here) over the model axis's group on
stage parameters that are this process's shards; JAX's `param_specs` and
`manual_model` name that layout for `shard_map` and have no counterpart.
Not ported: `_pipe_mesh_config`, which sets up `shard_map`'s manual axes and
batch spec (as parallel/mesh.py does not port `shard_map_compat`).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .distributed import global_batch_slice
from .mesh import DATA_AXIS, MODEL_AXIS, PIPE_AXIS, mesh_axis
from .sharding import (
    all_gather,
    all_reduce_,
    broadcast_,
    exchange,
    tp_region_enter,
    tp_region_exit,
)
from .train import all_reduce_grads

__all__ = ["DATA_AXIS", "MODEL_AXIS", "PIPE_AXIS", "gather_stage",
           "make_pipe_mesh", "pipe_mesh_layout", "pipeline_forward",
           "pipeline_train_grads", "pipeline_train_grads_full",
           "stack_stage_params", "tp_region_enter", "tp_region_exit"]


def pipe_mesh_layout(n_stages: int, ranks, n_data: int = 1,
                     n_model: int = 1) -> tuple[tuple, np.ndarray]:
    """(axis names, ranks laid out on them) of `make_pipe_mesh`: the first
    `n_data * n_model * n_stages` of `ranks` reshaped as JAX reshapes its
    devices, so rank `d * (n_model * P) + m * P + s` is stage `s`."""
    n = n_data * n_model * n_stages
    if len(ranks) < n:
        raise ValueError(f"{n_data}x{n_model}x{n_stages} needs {n} "
                         f"processes, {len(ranks)} given")
    arr = np.asarray(list(ranks)[:n])
    if n_data == 1 and n_model == 1:
        return (PIPE_AXIS,), arr
    if n_model == 1:
        return (DATA_AXIS, PIPE_AXIS), arr.reshape(n_data, n_stages)
    return ((DATA_AXIS, MODEL_AXIS, PIPE_AXIS),
            arr.reshape(n_data, n_model, n_stages))


def make_pipe_mesh(n_stages: int, devices=None, n_data: int = 1,
                   n_model: int = 1):
    """A `DeviceMesh` over the default group's ranks (`devices`, by
    default all of them, in rank order) with the axes `(pipe)`, `(data,
    pipe)` or `(data, model, pipe)` (`pipe_mesh_layout`). The schedule runs
    over "pipe", a microbatch's rows split over "data", and a model put on
    the mesh by parallel/sharding.shard_model computes its stage layers'
    share over "model". Needs an initialised default group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("make_pipe_mesh needs a process group: call "
                           "parallel.distributed.initialize_multihost first")
    ranks = list(range(dist.get_world_size()) if devices is None
                 else devices)
    names, arr = pipe_mesh_layout(n_stages, ranks, n_data, n_model)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.from_numpy(arr),
                      mesh_dim_names=names)


def stack_stage_params(per_layer_params: list, n_stages: int) -> dict:
    """`[L x {name: tensor}]` -> `{name: [n_stages, L / n_stages, ...]}`,
    layer `i` at `[i // (L / n_stages), i % (L / n_stages)]`."""
    n_layers = len(per_layer_params)
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} layers do not split into {n_stages} "
                         f"stages")
    per_stage = n_layers // n_stages
    return {k: torch.stack([lp[k] for lp in per_layer_params]).reshape(
        (n_stages, per_stage) + tuple(per_layer_params[0][k].shape))
        for k in per_layer_params[0]}


def gather_stage(stage: dict, mesh, specs: dict | None = None) -> dict:
    """Every process's `[1, L/P, ...]` slice of a stacked stage tree (and,
    where `specs` names "model" for a dimension, its model shard) ->
    the whole `[P, L/P, ...]` tree on every process (a collective over the
    pipe and model axes)."""
    pgroup = mesh_axis(mesh, PIPE_AXIS)[0]
    mgroup = mesh_axis(mesh, MODEL_AXIS)[0]
    out = {}
    for k, t in stage.items():
        spec = (specs or {}).get(k, ())
        if MODEL_AXIS in spec:
            t = all_gather(t, mgroup, spec.index(MODEL_AXIS))
        out[k] = all_gather(t, pgroup, 0)
    return out


def _local_layers(stage_params: dict, stage: int, apply_layer: Callable
                  ) -> tuple[dict, Callable]:
    """This stage's slice of the stacked parameters, as leaves that take
    gradients, and the function that runs its layers on one microbatch."""
    local = {k: v[stage].detach().requires_grad_(True)
             for k, v in stage_params.items()}
    n = next(iter(local.values())).shape[0]

    def run(x):
        for j in range(n):
            x = apply_layer({k: v[j] for k, v in local.items()}, x)
        return x

    return local, run


def _join_group(group, device) -> None:
    """NCCL wants every rank of a group in the group's first batched
    send/receive; a collective first makes any subset valid after it."""
    if group is not None:
        all_reduce_(torch.zeros(1, device=device), group)


def pipeline_forward(stage_params: dict, x: torch.Tensor, mesh,
                     apply_layer: Callable) -> torch.Tensor:
    """Run microbatches `x` `[M, mb, ...]` (the same on every process)
    through the pipelined layer stack; `apply_layer(layer_params,
    activation)` runs ONE layer. Returns `[M, mb, ...]` outputs on every
    process (no gradient: the transfers are not differentiable)."""
    group, stage, n_stages = mesh_axis(mesh, PIPE_AXIS)
    _, run_stage = _local_layers(stage_params, stage, apply_layer)
    n_micro = x.shape[0]
    outputs = torch.empty_like(x)
    last = stage == n_stages - 1
    buf = None
    _join_group(group, x.device)
    with torch.no_grad():
        for t in range(n_micro + n_stages - 1):
            f = t - stage
            sends = []
            if 0 <= f < n_micro:
                out = run_stage(x[f] if stage == 0 else buf)
                if last:
                    outputs[f] = out
                else:
                    sends.append((out, stage + 1))
            # the previous stage's forward of this tick feeds the next
            recv = stage > 0 and 0 <= t - (stage - 1) < n_micro
            got = exchange(sends, [(x[0], stage - 1)] if recv else [], group)
            buf = got[0] if recv else None
        broadcast_(outputs, group, n_stages - 1)
    return outputs


def one_f_one_b(run_stage: Callable, stage_params: list, head_params: list,
                xs, ys, n_micro: int, head_loss: Callable, pipe: tuple,
                like: torch.Tensor):
    """This process's part of the interleaved-1F1B schedule.

    `run_stage(x)` runs this stage's layers on one microbatch; it may be
    called under `torch.no_grad()`. `stage_params` / `head_params`: the
    tensors whose gradients are taken (the head's on the last stage only).
    `xs[m]`: microbatch m's input (read on stage 0); `ys[m]`: its target
    (read on the last stage); `head_loss(out, y)` the microbatch's mean
    loss. `pipe`: (group, stage, stages) of the pipe axis. `like`: a tensor
    of one microbatch's activation shape, dtype and device, what crosses
    stages (JAX's buffers are `zeros_like` the inputs).

    Returns `(loss sum, stage grads, head grads, dx)`: the float32 sum of
    `head_loss / M` (last stage; 0 elsewhere), the float32 gradients of
    `stage_params`, those of `head_params` (last stage; None elsewhere) and
    each microbatch's input gradient (stage 0; None elsewhere)."""
    group, stage, n_stages = pipe
    last = stage == n_stages - 1
    grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for p in stage_params]
    hgrads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
              for p in head_params] if last else None
    dxs = [None] * n_micro if stage == 0 else None
    loss_sum = torch.zeros((), dtype=torch.float32, device=like.device)
    _join_group(group, like.device)
    stash, fwd_in, bwd_in = {}, None, None
    for t in range(n_micro + 2 * (n_stages - 1) + 1):
        sends = []
        # ---- forward slot: microbatch f = t - stage ----------------------
        f = t - stage
        if 0 <= f < n_micro:
            x_in = xs[f] if stage == 0 else fwd_in
            stash[f] = x_in
            if not last:
                with torch.no_grad():
                    sends.append((run_stage(x_in), stage + 1))
        # ---- backward slot: microbatch b = t - (2P - 1 - stage) -----------
        b = t - (2 * n_stages - 1 - stage)
        if 0 <= b < n_micro:
            x_b = stash.pop(b).detach().requires_grad_(True)
            with torch.enable_grad():
                out = run_stage(x_b)
                if last:
                    loss_b = head_loss(out, ys[b]) / n_micro
                    got = torch.autograd.grad(
                        loss_b, [*stage_params, *head_params, x_b])
                    loss_sum += loss_b.detach().float()
                else:
                    got = torch.autograd.grad(out, [*stage_params, x_b],
                                              bwd_in)
            del out
            for acc, g in zip(grads, got):
                acc.add_(g)
            if last:
                for acc, g in zip(hgrads, got[len(grads):-1]):
                    acc.add_(g)
            if stage == 0:
                dxs[b] = got[-1]
            else:
                sends.append((got[-1], stage - 1))
        # ---- transfers: what the neighbours' slots of this tick send -------
        recv_f = stage > 0 and 0 <= t - (stage - 1) < n_micro
        recv_b = not last and 0 <= t - (2 * n_stages - 2 - stage) < n_micro
        recvs = [(like, stage - 1)] * recv_f + [(like, stage + 1)] * recv_b
        got = exchange(sends, recvs, group)
        fwd_in = got.pop(0) if recv_f else None
        bwd_in = got.pop(0) if recv_b else None
    return loss_sum, grads, hgrads, dxs


def mean_over(tensors: list, group, n: int) -> list:
    """Each tensor summed over `group` and divided by its size `n` (JAX's
    `pmean`), in place; nothing without a group."""
    if group is not None:
        all_reduce_grads(tensors, [group] * len(tensors))
        for t in tensors:
            t.div_(n)
    return tensors


def broadcast_all_(tensors: list, group, src: int) -> list:
    """The tensors of the group's rank `src` on every rank, in place, in
    one flat broadcast a dtype."""
    if group is None or not tensors:
        return tensors
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = broadcast_(torch.cat([t.reshape(-1) for t in ts]), group, src)
        for t, piece in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(piece.view_as(t))
    return tensors


def replicate(loss_sum, grads: list, hgrads, head_params: list, mesh):
    """`one_f_one_b`'s results as the JAX functions return them: the loss
    and the head's gradients, which live on the last stage, on every
    process of the pipe, and those and the stage's gradients the means over
    the data replicas. Returns `(loss, grads, head grads)`, in place."""
    group, stage, n_stages = mesh_axis(mesh, PIPE_AXIS)
    dgroup, _, n_data = mesh_axis(mesh, DATA_AXIS)
    loss = mean_over([broadcast_(loss_sum, group, n_stages - 1)], dgroup,
                     n_data)[0]
    if stage == n_stages - 1:
        mean_over(hgrads, dgroup, n_data)
    else:
        hgrads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                  for p in head_params]
    broadcast_all_(hgrads, group, n_stages - 1)
    return loss, mean_over(grads, dgroup, n_data), hgrads


def _train(stage_params, head_params, x, y, mesh, apply_layer, head_loss,
           with_dx: bool):
    group, stage, n_stages = mesh_axis(mesh, PIPE_AXIS)
    dgroup, dcoord, n_data = mesh_axis(mesh, DATA_AXIS)
    start, per = global_batch_slice(x.shape[1], dcoord, n_data)
    xs, ys = x[:, start:start + per], y[:, start:start + per]
    local, run_stage = _local_layers(stage_params, stage, apply_layer)
    head = {k: v.detach().requires_grad_(True)
            for k, v in head_params.items()}
    loss_sum, grads, hgrads, dxs = one_f_one_b(
        run_stage, list(local.values()), list(head.values()), xs,
        ys, x.shape[0], lambda out, tgt: head_loss(head, out, tgt),
        (group, stage, n_stages), xs[0])
    loss, grads, hgrads = replicate(loss_sum, grads, hgrads,
                                    list(head.values()), mesh)
    stage_grads = {k: g[None] for k, g in zip(local, grads)}
    head_grads = dict(zip(head, hgrads))
    if not with_dx:
        return loss, stage_grads, head_grads, None
    # d(loss)/d(x), captured at stage 0: the replicas' mean is a 1/n scale
    dx = torch.stack(dxs) if stage == 0 else torch.empty_like(xs)
    if n_data > 1 and stage == 0:
        dx = dx / n_data
    return loss, stage_grads, head_grads, broadcast_(dx, group, 0)


def pipeline_train_grads(stage_params: dict, x: torch.Tensor,
                         y: torch.Tensor, mesh, apply_layer: Callable,
                         loss_fn: Callable):
    """Interleaved-1F1B training: loss and this stage's gradients.

    `x` `[M, mb, ...]` microbatched inputs and `y` `[M, mb, ...]` targets
    (the same on every process); `apply_layer(layer_params, activation)`
    runs ONE layer; `loss_fn(last_stage_output_mb, y_mb)` is one
    microbatch's mean loss. Returns `(loss, grads)`: the mean over
    microbatches (float32, on every process), and the float32 gradients of
    this process's slice of `stage_params`, `[1, L/P, ...]` (JAX's
    pipe-sharded layout; `gather_stage` makes them whole)."""
    loss, grads, _, _ = _train(
        stage_params, {}, x, y, mesh, apply_layer,
        lambda _, out, tgt: loss_fn(out, tgt), with_dx=False)
    return loss, grads


def pipeline_train_grads_full(stage_params: dict, head_params: dict,
                              x: torch.Tensor, y: torch.Tensor, mesh,
                              apply_layer: Callable, head_loss: Callable):
    """1F1B training with a trainable head and input gradients (the
    schedule of `pipeline_train_grads`, composed into a larger model):
    `head_loss(head_params, last_stage_out_mb, y_mb)` runs at the last
    stage. With a "data" axis each process takes its rows of every
    microbatch, and the loss and gradients are the replicas' means.

    Returns `(loss, stage_grads, head_grads, dx_inputs)` on every process:
    the float32 loss, this stage's float32 gradients `[1, L/P, ...]`, the
    head's float32 gradients, and d(loss)/d(x) for this process's rows
    `[M, rows, ...]` in `x`'s dtype (divided by the data axis's size, so
    the preamble's gradients summed over the replicas are their mean)."""
    return _train(stage_params, head_params, x, y, mesh, apply_layer,
                  head_loss, with_dx=True)
