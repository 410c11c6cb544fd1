"""Pipeline-parallel training of the FULL multi-frame MLLM (the port of
multi_spatialmllm_tpu/parallel/pipeline_mllm.py).

Composes the interleaved-1F1B decoder pipeline (pipeline_parallel.py) with
the rest of the model:

    preamble (stage 0): vision encoder + projector + token embedding ->
        spliced activations per microbatch
    pipe ("pipe" axis): the decoder layer stack in P contiguous stages
    head (last stage): final RMSNorm + lm head + masked next-token loss

Gradients flow end to end: the pipeline's d(loss)/d(activations) at stage 0
chains into the preamble's backward, the stage's gradients stay on its
processes (the pipe-sharded layout), and the preamble's and head's reach
every process, as JAX's replicated outputs do. The loss is the mean of the
microbatches' masked means (the standard pipeline decomposition; equal to
the global masked mean when microbatches carry equal supervised-token
counts).

A process holds the whole model, as the JAX function takes the whole
parameter tree, and computes its part: stage 0 the preamble, every stage
its layers, the last stage the head. On a mesh with a "model" axis the
model is put on the mesh first (parallel/sharding.shard_model): only the
decoder layers shard over "model", the preamble and the head replicate.
"""

from __future__ import annotations

import torch

from ..models.llm import DTYPES, cross_entropy_loss, rope_tables
from .mesh import DATA_AXIS, MODEL_AXIS, PIPE_AXIS, mesh_axis
from .pipeline_parallel import (
    broadcast_all_,
    one_f_one_b,
    replicate,
    stack_stage_params,
)
from .sharding import STAGE_PREFIX, spec_for_path
from .train import all_reduce_grads, local_rows

# the parameters of the preamble and of the head (the stage: STAGE_PREFIX)
PRE_PREFIXES = ("vision.", "projector.", "llm.embed.")
HEAD_PREFIXES = ("llm.final_norm.", "llm.lm_head.")


def split_params(state: dict, cfg, n_stages: int):
    """A full state dict -> (preamble, stage, head): the preamble's and the
    head's entries under their names, and the decoder layers' stacked
    `{name within a layer: [P, L/P, ...]}` (`stack_stage_params`)."""
    n_layers = cfg.llm.num_layers
    pre = {k: v for k, v in state.items() if k.startswith(PRE_PREFIXES)}
    head = {k: v for k, v in state.items() if k.startswith(HEAD_PREFIXES)}
    layers = [{} for _ in range(n_layers)]
    for k, v in state.items():
        if k.startswith(STAGE_PREFIX):
            i, rel = k[len(STAGE_PREFIX):].split(".", 1)
            layers[int(i)][rel] = v
    if len(pre) + len(head) + sum(map(len, layers)) != len(state):
        raise ValueError("the state has entries outside the preamble, the "
                         "decoder layers and the head")
    return pre, stack_stage_params(layers, n_stages), head


def merge_params(pre: dict, stage: dict, head: dict, cfg) -> dict:
    """Inverse of :func:`split_params` (e.g. after an optimizer update):
    the full state dict, in the model's order."""
    n_stages = next(iter(stage.values())).shape[0]
    per_stage = cfg.llm.num_layers // n_stages
    out = dict(pre)
    for i in range(cfg.llm.num_layers):
        s, k = divmod(i, per_stage)
        for rel, v in stage.items():
            out[f"{STAGE_PREFIX}{i}.{rel}"] = v[s, k]
    out.update(head)
    return out


def tp_decoder_layer(layer, x: torch.Tensor, rope) -> torch.Tensor:
    """One decoder layer of a stage: the model's own `DecoderLayer` (its
    rope tables `rope`), whose attention and MLP compute this process's
    share of the heads and the FFN when shard_model put it on a model axis
    (Megatron's f after each norm, g completing each row-parallel product
    before the residual add: activations stay replicated over "model"). A
    MoE layer's load-balance statistic is dropped, as JAX's stage body
    drops it."""
    out, _, _ = layer(x, rope)
    return out


def tp_stage_param_specs(stage_params: dict) -> dict:
    """Per dimension of each stacked stage tensor `[P, L/P, ...]`, the mesh
    axis that shards it: "pipe" first, then the "model" dimension of
    wq/wk/wv (heads), wo (heads), gate/up (F) and down (F); norm scales
    replicate over "model"."""
    return {rel: (PIPE_AXIS, None) + tuple(
        a if a == MODEL_AXIS else None
        for a in spec_for_path(STAGE_PREFIX + "0." + rel, v.dim() - 2))
        for rel, v in stage_params.items()}


def _check_mesh(model, mesh, n_stages: int, n_model: int) -> None:
    n_layers = model.cfg.llm.num_layers
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} decoder layers do not split into "
                         f"{n_stages} stages")
    plan = getattr(model, "mesh_plan", None)
    if n_model > 1 and (plan is None or plan.mesh is not mesh):
        raise ValueError("a mesh with a model axis needs the model on it "
                         "first: parallel/sharding.shard_model(model, mesh), "
                         "which checks that the heads, the kv heads and the "
                         "FFN divide over the axis")


def mllm_pipeline_loss_and_grads(model, batch: dict, mesh, n_micro: int):
    """Loss and full-model gradients with the decoder stack pipelined.

    `batch`: the global batch's `input_ids` `[B, T]`, `tiles` and `labels`
    (`B` divisible by `n_micro`); microbatch m is the consecutive rows
    `m * B/M ...`, and with a "data" axis each process takes its rows of
    every microbatch (parallel/train.local_rows). Positions count from 0 in
    every row; `positions` and `segment_ids` in the batch are not read, as
    in JAX.

    Returns `(loss, (pre_grads, stage_grads, head_grads))`: the float32
    loss, and the preamble's and head's float32 gradients under their
    parameter names on every process (JAX's replicated outputs), and
    `{name within a layer: [1, L/P, ...]}` for this process's stage, its
    model shard under a model axis (JAX's pipe-sharded layout; see
    `split_params`). Each is the mean over the data replicas."""
    group, stage, n_stages = mesh_axis(mesh, PIPE_AXIS)
    dgroup, _, n_data = mesh_axis(mesh, DATA_AXIS)
    mgroup, _, n_model = mesh_axis(mesh, MODEL_AXIS)
    _check_mesh(model, mesh, n_stages, n_model)
    cfg = model.cfg.llm
    n_rows, seq = batch["input_ids"].shape
    if n_rows % n_micro:
        raise ValueError(f"batch {n_rows} not divisible by {n_micro} "
                         f"microbatches")
    dev = next(model.parameters()).device
    rows = {k: batch[k] for k in ("input_ids", "tiles", "labels")}
    rows = {k: v.to(dev) for k, v in local_rows(rows, n_micro, mesh).items()}
    per = rows["input_ids"].shape[0] // n_micro

    per_stage = cfg.num_layers // n_stages
    first_layer = stage * per_stage
    layers = model.llm.layers[first_layer:first_layer + per_stage]
    rope = rope_tables(torch.arange(seq, device=dev).expand(per, seq),
                       cfg.head_dim, cfg.rope_theta)

    def run_stage(x):
        for layer in layers:
            x = tp_decoder_layer(layer, x, rope)
        return x

    def head_loss(x, labels):
        logits = model.llm.lm_head(model.llm.final_norm(x))
        return cross_entropy_loss(logits[:, :-1], labels[:, 1:])

    named = dict(model.named_parameters())
    stage_names = [n for n in named if n.startswith(tuple(
        f"{STAGE_PREFIX}{first_layer + j}." for j in range(per_stage)))]
    head_names = [n for n in named if n.startswith(HEAD_PREFIXES)]
    pre_names = [n for n in named if n.startswith(PRE_PREFIXES)]

    xs = embeds = None
    if stage == 0:
        embeds = model.spliced_embeds(rows["input_ids"], rows["tiles"])
        xs = embeds.detach().split(per)
    # what crosses stages: a microbatch's activations in the embeddings'
    # dtype (shape and dtype only: no memory behind it)
    like = torch.zeros((), dtype=DTYPES[cfg.dtype], device=dev).expand(
        per, seq, cfg.hidden_size)
    loss_sum, sgrads, hgrads, dxs = one_f_one_b(
        run_stage, [named[n] for n in stage_names],
        [named[n] for n in head_names], xs, rows["labels"].split(per),
        n_micro, head_loss, (group, stage, n_stages), like)

    # the preamble's backward at stage 0: dx over this replica's rows,
    # divided by the replicas, then summed over them
    if stage == 0:
        dx = torch.cat(dxs)
        if n_data > 1:
            dx = dx / n_data
        pgrads = list(torch.autograd.grad(embeds, [named[n] for n in
                                                   pre_names], dx))
        del embeds, dx
        all_reduce_grads(pgrads, [dgroup] * len(pgrads))
    else:
        pgrads = [torch.zeros(named[n].shape, dtype=torch.float32,
                              device=dev) for n in pre_names]
    broadcast_all_(pgrads, group, 0)

    # a replicated tensor used a share at a time sums over "model"
    summed = getattr(getattr(model, "mesh_plan", None), "model_summed", ())
    all_reduce_grads([g for n, g in zip(stage_names, sgrads) if n in summed],
                     [mgroup] * len(sgrads))
    loss, sgrads, hgrads = replicate(loss_sum, sgrads, hgrads,
                                     [named[n] for n in head_names], mesh)
    by_name = dict(zip(stage_names, sgrads))
    rels = [n.split(".", 3)[3] for n in stage_names[:len(stage_names)
                                                    // per_stage]]
    stage_grads = {rel: torch.stack([
        by_name[f"{STAGE_PREFIX}{first_layer + j}.{rel}"]
        for j in range(per_stage)])[None] for rel in rels}
    return loss, (dict(zip(pre_names, pgrads)), stage_grads,
                  dict(zip(head_names, hgrads)))
