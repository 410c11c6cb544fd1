"""Parameter layout over the mesh, the collective seam, and the
tensor-parallel regions (the port of multi_spatialmllm_tpu/parallel/
sharding.py).

Layout. `_RULES` is the JAX package's Megatron layout keyed to the port's
parameter names (models/convert.py maps the two): head and FFN dimensions
shard over the "model" axis, embeddings and the lm_head over the vocab,
the MoE expert tables over "expert" with their FFN dimension over "model";
norms, biases, the router, the ViT's patch embedding and position table
replicate. A spec names, per dimension of the port's tensor, the mesh axis
that shards it, or None. The ViT's `qkv` weight holds its outputs as
(3, heads, head_dim): its "model" dimension is split in each of the three
parts (`_BLOCKS`). With `fsdp`, `_add_fsdp` also shards the largest free
dimension that the data axis divides of every parameter of at least
`fsdp_min_size` elements over "data", as the JAX function does. Axes the
mesh does not carry drop out (on a (data, model) mesh the expert tables
replicate); an axis of one process shards nothing.

Execution. A process holds its shard of each parameter (`shard_model`)
and calls the collectives itself, where XLA inserts them in JAX:

* Megatron's f and g (`tp_region_enter`: identity forward, all-reduce of
  the gradient; `tp_region_exit`: all-reduce forward, identity backward)
  bracket each column-parallel group (wq/wk/wv, gate/up, the ViT's qkv and
  fc1, the projector's fc1) and follow each row-parallel product (wo,
  down, proj, fc2), whose bias is added once, after the reduction. The
  vocab-sharded embedding looks up the ids its shard holds and all-reduces;
  the lm_head's vocab shards are gathered for the loss (`gather_last`).
  A column-parallel layer's bias is replicated, as in JAX, and each process
  adds its share of it, so that bias's gradient is summed over "model".
* FSDP (`fsdp_gather`): a parameter sharded over "data" is all-gathered
  at each use (so again in a rematerialised layer's recompute), in the
  dtype its module computes in, and its gradient reduce-scattered back
  onto the shard.
* The loss (`vocab_parallel_nll`): a TP process's logits stay its vocab
  shard's; the logsumexp and the label's logit are reduced over "model".

Every collective goes through one seam (`all_reduce_`, `all_gather`,
`reduce_scatter`, `all_to_all`, `ring_pass`). Under NCCL it passes CUDA
tensors as they are. Under a gloo group, a CUDA tensor goes to gloo as it
is for every collective that gloo takes on CUDA, and through pinned host
memory for those it does not (point-to-point sends and receives, found
with scripts/torch_gloo_cuda_probe.py on torch 2.11: `ring_pass`); the
group's backend decides, and `STAGED` counts the bytes and seconds of
those copies. The seam never moves compute off the tensor's device.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist

from .mesh import DATA_AXIS, EXPERT_AXIS, MODEL_AXIS, SEQ_AXIS, axes_group

# (patterns that must each be a segment of the dotted parameter name,
#  {ndim: spec over the port tensor's dims})
_RULES: list[tuple[tuple[str, ...], dict[int, tuple]]] = [
    # LLM attention: wq/wk/wv [heads*head_dim, hidden] (column parallel)
    (("attn", "wq", "weight"), {2: (MODEL_AXIS, None)}),
    (("attn", "wk", "weight"), {2: (MODEL_AXIS, None)}),
    (("attn", "wv", "weight"), {2: (MODEL_AXIS, None)}),
    # wo [hidden, heads*head_dim]: row parallel
    (("attn", "wo", "weight"), {2: (None, MODEL_AXIS)}),
    # SwiGLU
    (("gate", "weight"), {2: (MODEL_AXIS, None)}),
    (("up", "weight"), {2: (MODEL_AXIS, None)}),
    (("down", "weight"), {2: (None, MODEL_AXIS)}),
    # embedding and head: the vocab
    (("embed", "weight"), {2: (MODEL_AXIS, None)}),
    (("lm_head", "weight"), {2: (MODEL_AXIS, None)}),
    # ViT attention qkv [(3, heads, head_dim), hidden] and proj
    (("qkv", "weight"), {2: (MODEL_AXIS, None)}),
    (("proj", "weight"), {2: (None, MODEL_AXIS)}),
    # ViT (and projector) MLP
    (("fc1", "weight"), {2: (MODEL_AXIS, None)}),
    (("fc2", "weight"), {2: (None, MODEL_AXIS)}),
    # MoE tables in the JAX layouts: experts over "expert", FFN over
    # "model"; the router replicates
    (("moe", "wi_gate"), {3: (EXPERT_AXIS, None, MODEL_AXIS)}),
    (("moe", "wi_up"), {3: (EXPERT_AXIS, None, MODEL_AXIS)}),
    (("moe", "wo"), {3: (EXPERT_AXIS, MODEL_AXIS, None)}),
]
# module name -> parts its output dimension is laid out in (the model axis
# splits each part)
_BLOCKS = {"qkv": 3}


def spec_for_path(name: str, ndim: int) -> tuple:
    """The rule's spec for a parameter of the port (dotted name, ndim), or
    all None (replicated)."""
    segs = name.split(".")
    for patterns, by_ndim in _RULES:
        if all(p in segs for p in patterns) and ndim in by_ndim:
            return by_ndim[ndim]
    return (None,) * ndim


def _add_fsdp(spec: tuple, shape: tuple, n_data: int, min_size: int
              ) -> tuple:
    """Also shard the largest dimension not already sharded that `n_data`
    divides over "data", for parameters of at least `min_size` elements
    (ZeRO-3)."""
    if int(np.prod(shape)) < min_size:
        return spec
    entries = list(spec)
    for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if entries[i] is None and shape[i] % n_data == 0:
            entries[i] = DATA_AXIS
            return tuple(entries)
    return spec


def mesh_sizes(mesh) -> dict:
    """{axis: size} of `mesh` ({} without one)."""
    if mesh is None:
        return {}
    return {n: mesh.size(i) for i, n in enumerate(mesh.mesh_dim_names)}


def params_shardings(model, mesh, fsdp: bool = False,
                     fsdp_min_size: int = 2 ** 16) -> dict:
    """{parameter name: spec} for a model holding FULL parameters (built
    on any device, the meta device included): per dimension, the mesh axis
    that shards it, or None. Axes the mesh does not carry drop out, as in
    JAX; `fsdp` adds the data axis (`_add_fsdp`)."""
    sizes = mesh_sizes(mesh)
    out = {}
    for name, p in model.named_parameters():
        spec = tuple(a if a in sizes else None
                     for a in spec_for_path(name, p.dim()))
        if fsdp:
            spec = _add_fsdp(spec, tuple(p.shape), sizes.get(DATA_AXIS, 1),
                             fsdp_min_size)
        out[name] = spec
    return out


def _blocks(name: str) -> int:
    segs = name.split(".")
    return next((n for m, n in _BLOCKS.items() if m in segs), 1)


def take_shard(t: torch.Tensor, dim: int, coord: int, size: int,
               blocks: int = 1) -> torch.Tensor:
    """Shard `coord` of `size` of `t` along `dim`: the dimension read as
    `blocks` equal parts, each split in `size` (a view when `blocks` is 1;
    differentiable)."""
    if size == 1:
        return t
    n = t.shape[dim]
    if n % (blocks * size):
        raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not "
                         f"split into {blocks} x {size} shards")
    part = n // blocks
    per = part // size
    pieces = [t.narrow(dim, b * part + coord * per, per)
              for b in range(blocks)]
    return torch.cat(pieces, dim=dim) if blocks > 1 else pieces[0]


def _coords(mesh) -> dict:
    from .mesh import mesh_axis

    return {n: mesh_axis(mesh, n)[1:] for n in mesh_sizes(mesh)}


def shard_params(state: dict, layout: dict, mesh) -> dict:
    """A FULL state dict -> this process's shards under `layout`
    (`params_shardings`); names the layout does not know pass whole."""
    coords = _coords(mesh)
    out = {}
    for name, t in state.items():
        spec = layout.get(name)
        if spec is not None:
            for dim, axis in enumerate(spec):
                if axis is not None:
                    coord, size = coords[axis]
                    t = take_shard(t, dim, coord, size,
                                   _blocks(name) if axis == MODEL_AXIS else 1
                                   ).contiguous()
        out[name] = t
    return out


def gather_params(state: dict, layout: dict, mesh) -> dict:
    """The inverse of `shard_params`: this process's shards -> FULL
    tensors (a collective: every process of the mesh calls it)."""
    from .mesh import mesh_axis

    out = {}
    for name, t in state.items():
        spec = layout.get(name, ())
        for dim in reversed(range(len(spec))):
            axis = spec[dim]
            if axis is None:
                continue
            group, _, size = mesh_axis(mesh, axis)
            if group is None:
                continue
            parts = all_gather(t, group, dim).chunk(size, dim)
            blocks = _blocks(name) if axis == MODEL_AXIS else 1
            if blocks > 1:
                per = [p.chunk(blocks, dim) for p in parts]
                t = torch.cat([per[r][b] for b in range(blocks)
                               for r in range(size)], dim=dim)
            else:
                t = torch.cat(parts, dim=dim)
        out[name] = t
    return out


# --- the collective seam ---------------------------------------------------

# what the gloo transport staged through host memory
STAGED = {"bytes": 0, "seconds": 0.0, "calls": 0}


def reset_staged() -> None:
    STAGED.update(bytes=0, seconds=0.0, calls=0)


def _to_host(t: torch.Tensor) -> torch.Tensor:
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    STAGED["bytes"] += t.numel() * t.element_size()
    return h


def _to_device(h: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    STAGED["bytes"] += h.numel() * h.element_size()
    return h.to(like.device, non_blocking=False)


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum `t` over `group`, in place (nothing without a group)."""
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


def all_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's tensors concatenated along `dim`, in rank order."""
    if group is None:
        return t
    n = dist.get_world_size(group)
    src = t.movedim(dim, 0).contiguous()
    out = src.new_empty((n * src.shape[0],) + src.shape[1:])
    dist.all_gather_into_tensor(out, src, group=group)
    return out.movedim(0, dim)


def reduce_scatter(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """`t` summed over the group, then this rank's chunk along `dim`."""
    if group is None:
        return t
    n = dist.get_world_size(group)
    src = t.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // n,) + src.shape[1:])
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim)


def all_to_all(t: torch.Tensor, group, split_dim: int, cat_dim: int
               ) -> torch.Tensor:
    """Chunk j of `t` along `split_dim` goes to rank j; the chunks
    received come back concatenated along `cat_dim`, in rank order."""
    if group is None:
        return t
    n = dist.get_world_size(group)
    src = t.movedim(split_dim, 0).contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    parts = out.chunk(n, 0)
    return torch.cat([p.movedim(0, split_dim) for p in parts], dim=cat_dim)


def ring_pass(tensors: list, group) -> list:
    """Each tensor sent to the next rank of `group` (ranks in a ring), and
    the previous rank's received in its place."""
    if group is None:
        return tensors
    rank, n = dist.get_rank(group), dist.get_world_size(group)
    nxt = dist.get_global_rank(group, (rank + 1) % n)
    prv = dist.get_global_rank(group, (rank - 1) % n)
    # point-to-point transfers of CUDA tensors crash gloo's TCP pairs
    # (scripts/torch_gloo_cuda_probe.py); every other collective here takes
    # CUDA tensors under gloo
    staged = tensors[0].is_cuda and dist.get_backend(group) == "gloo"
    t0 = time.perf_counter()
    sends = [(_to_host(t) if staged else t.contiguous()) for t in tensors]
    recvs = [torch.empty_like(s) for s in sends]
    if staged:
        recvs = [r.pin_memory() for r in recvs]
    ops = [dist.P2POp(dist.isend, s, nxt, group) for s in sends] + \
          [dist.P2POp(dist.irecv, r, prv, group) for r in recvs]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    if staged:
        recvs = [_to_device(r, t) for r, t in zip(recvs, tensors)]
        STAGED["seconds"] += time.perf_counter() - t0
        STAGED["calls"] += 1
    return recvs


# --- autograd regions ------------------------------------------------------

class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _Exit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def tp_region_enter(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's f: identity forward, gradient all-reduced over `group`
    (before column-parallel layers, whose input is replicated)."""
    return x if group is None else _Enter.apply(x, group)


def tp_region_exit(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's g: partial sums all-reduced over `group`, identity
    backward (after row-parallel layers)."""
    return x if group is None else _Exit.apply(x, group)


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.rank, ctx.n = dist.get_rank(group), dist.get_world_size(group)
        return all_gather(x, group, x.dim() - 1)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.n, -1)[ctx.rank].contiguous(), None


def gather_last(x: torch.Tensor, group) -> torch.Tensor:
    """The group's shards of the last dimension concatenated (the vocab
    shards of the logits); each rank's gradient is its own slice."""
    return x if group is None else _GatherLast.apply(x, group)


class _GatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group, ctx.dim), None, None


class _VocabParallelNLL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, tp):
        x = logits.float()
        lse_local = torch.logsumexp(x, dim=-1)
        lse = torch.logsumexp(all_gather(lse_local[None].contiguous(),
                                         tp.group, 0), dim=0)
        vl = x.shape[-1]
        local = labels - tp.coord * vl
        inside = (local >= 0) & (local < vl)
        idx = local.clamp(0, vl - 1)[..., None]
        target = torch.gather(x, -1, idx)[..., 0] * inside
        all_reduce_(target, tp.group)
        ctx.save_for_backward(x, lse, idx, inside)
        ctx.dtype = logits.dtype
        return lse - target

    @staticmethod
    def backward(ctx, g):
        x, lse, idx, inside = ctx.saved_tensors
        grad = torch.exp(x - lse[..., None])
        grad.scatter_add_(-1, idx, -inside[..., None].to(grad.dtype))
        return (grad * g[..., None]).to(ctx.dtype), None, None


def vocab_parallel_nll(logits: torch.Tensor, labels: torch.Tensor, tp
                       ) -> torch.Tensor:
    """Each position's `-log softmax(logits)[label]`, `[B, T]` float32,
    from this process's vocab shard of the logits (`tp` the model axis's
    place): the logsumexp of every shard's logsumexp (gathered, `[B, T]`
    a process) less the label's logit (summed over the shards, one holds
    it). The gradient is this shard's softmax less the label's one-hot."""
    return _VocabParallelNLL.apply(logits, labels, tp)


def fsdp_gather(shard: torch.Tensor, group, dim: int) -> torch.Tensor:
    """A parameter's full tensor from the data axis's shards (along `dim`);
    the gradient is reduce-scattered back onto the shard, summed over the
    group. Also the sequence gather of packed rows under ring attention."""
    return shard if group is None else _GatherDim.apply(shard, group, dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, cat_dim):
        ctx.group, ctx.dims = group, (split_dim, cat_dim)
        return all_to_all(x, group, split_dim, cat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, cat_dim = ctx.dims
        return all_to_all(g, ctx.group, cat_dim, split_dim), None, None, None


def all_to_all_autograd(x, group, split_dim: int, cat_dim: int):
    """`all_to_all` with its transpose as the backward (the expert axis's
    dispatch and combine)."""
    return x if group is None else _AllToAll.apply(x, group, split_dim,
                                                   cat_dim)


# --- a model over the mesh -------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TPShard:
    """A module's place on the model axis: its group, this process's
    coordinate and the axis size; `kind` "col" or "row" for a `Linear`,
    `blocks` the parts its output is laid out in."""
    group: object
    coord: int
    size: int
    kind: str = ""
    blocks: int = 1

    def take(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This process's share of a full tensor along `dim`."""
        return take_shard(t, dim, self.coord, self.size, self.blocks)


@dataclasses.dataclass
class MeshPlan:
    """How a model lies on a mesh (`shard_model`): the layout, the
    parameters whose gradient is summed over "model" (replicated tensors
    used a share at a time), and the mesh."""
    mesh: object
    layout: dict
    model_summed: frozenset

    def shard_axes(self, name: str) -> tuple:
        """Axes (of more than one process) that shard parameter `name`."""
        sizes = mesh_sizes(self.mesh)
        return tuple(a for a in self.layout.get(name, ())
                     if a is not None and sizes.get(a, 1) > 1)

    def grad_group(self, name: str, extra_model: bool = False):
        """The group a gradient is all-reduced over after the backward:
        the axes the batch is split over (data, expert, seq) that do not
        shard the parameter, and "model" for a tensor used a share at a
        time. A data-sharded (FSDP) gradient was reduce-scattered over
        "data" already, an expert table's gathered its tokens from the
        expert axis with the dispatch."""
        axes = set(BATCH_AXES) - set(self.shard_axes(name))
        if name in self.model_summed or extra_model:
            axes.add(MODEL_AXIS)
        return axes_group(self.mesh, axes)[0]

    def norm_group(self, name: str):
        """The group whose shards of parameter `name` make it whole (the
        clip's norm sums each shard's squares once over it)."""
        return axes_group(self.mesh, self.shard_axes(name))[0]


# the axes a batch is split over: rows over data and expert, each row's
# tokens over seq
BATCH_AXES = (DATA_AXIS, EXPERT_AXIS, SEQ_AXIS)
ROW_AXES = (DATA_AXIS, EXPERT_AXIS)


def shard_model(model, mesh, fsdp: bool = False,
                fsdp_min_size: int = 2 ** 16) -> MeshPlan:
    """Put `model` (holding FULL parameters) on `mesh`: each parameter
    becomes this process's shard (`params_shardings`), the modules learn
    their model-axis places (TP regions, local head counts), the expert
    tables their expert-axis place, and FSDP parameters gather at use.
    Returns the plan, also kept as `model.mesh_plan`. Raises when a
    sharded dimension does not divide, e.g. `num_kv_heads % n_model`."""
    from ..models.llm import Attention, DecoderLM, Embedding, Linear, MLP
    from ..models.mllm import Projector
    from ..models.moe import MoEMLP
    from ..models.vit import ViTBlock
    from .mesh import expert_axis, mesh_axis, model_axis

    layout = params_shardings(model, mesh, fsdp, fsdp_min_size)
    _check_divisible(model, mesh)
    check_moe_mesh(model.cfg, mesh)
    mgroup, mcoord, msize = model_axis(mesh)
    tp = TPShard(mgroup, mcoord, msize) if mgroup is not None else None
    summed = set()
    for mod_name, mod in model.named_modules():
        leaf = mod_name.rsplit(".", 1)[-1]
        if isinstance(mod, Linear) and tp is not None:
            # the model axis on the output dim: column parallel (its
            # replicated bias used a share at a time); on the input dim: row
            spec = layout[f"{mod_name}.weight"]
            kind = "col" if spec[0] == MODEL_AXIS else \
                "row" if spec[1] == MODEL_AXIS else ""
            if kind:
                mod.tp = dataclasses.replace(tp, kind=kind,
                                             blocks=_BLOCKS.get(leaf, 1))
                if kind == "col" and mod.bias is not None:
                    summed.add(f"{mod_name}.bias")
        elif isinstance(mod, (Attention, MLP, ViTBlock, Projector,
                              DecoderLM, Embedding)):
            mod.tp = tp
        elif isinstance(mod, MoEMLP):
            mod.tp = tp
            eg, ec, es = expert_axis(mesh)
            mod.ep = TPShard(eg, ec, es) if eg is not None else None
    coords = _coords(mesh)
    for name, p in list(model.named_parameters()):
        mod_name, leaf = name.rsplit(".", 1)
        mod = model.get_submodule(mod_name)
        local = shard_params({name: p.detach()}, layout, mesh)[name]
        if local.shape != p.shape:
            mod._parameters[leaf] = torch.nn.Parameter(
                local, requires_grad=p.requires_grad)
        spec = layout[name]
        if DATA_AXIS in spec and coords.get(DATA_AXIS, (0, 1))[1] > 1:
            group = mesh_axis(mesh, DATA_AXIS)[0]
            gathers = mod.__dict__.setdefault("_gather", {})
            gathers[leaf] = _fsdp_at_use(group, spec.index(DATA_AXIS),
                                         _compute_dtype(mod, leaf))
    plan = MeshPlan(mesh, layout, frozenset(summed))
    model.mesh_plan = plan
    return plan


def _compute_dtype(mod, leaf: str):
    """The dtype `mod` uses its parameter `leaf` in: the module's
    `compute_dtype` (the MoE router computes in float32). Only the modules
    that read their parameters through `quantize.dequantized` gather an
    FSDP shard at use, and each of them carries a `compute_dtype`."""
    return torch.float32 if leaf == "router" else mod.compute_dtype


def _fsdp_at_use(group, dim, dtype):
    """The gather of an FSDP shard, in the dtype it is used in (the cast
    the module makes at use moves before the gather: half the bytes for a
    bf16 model's float32 master weights, and the gradient reduce-scattered
    in that dtype, as the module's own product gives it)."""
    return lambda shard: fsdp_gather(shard.to(dtype), group, dim)


# the JAX step's refusal of the ragged MoE on an expert mesh
RAGGED_EP_MESSAGE = (
    "moe_impl='ragged' is single-chip/data-parallel only: its global sort "
    "+ ragged_dot dispatch cannot shard over the 'expert' mesh axis (size "
    "{n}). Use moe_impl='einsum' for expert-parallel meshes, or drop "
    "--expert-parallel.")


def check_moe_mesh(cfg, mesh) -> None:
    """Raise JAX's `ValueError` for a ragged MoE decoder (`cfg` an
    MLLMConfig) on a mesh with an expert axis: the ragged impl has no
    expert-parallel form."""
    from .mesh import expert_axis

    n = expert_axis(mesh)[2]
    if cfg.llm.moe_experts > 0 and cfg.llm.moe_impl == "ragged" and n > 1:
        raise ValueError(RAGGED_EP_MESSAGE.format(n=n))


def _check_divisible(model, mesh) -> None:
    cfg = model.cfg
    sizes = mesh_sizes(mesh)
    m, e = sizes.get(MODEL_AXIS, 1), sizes.get(EXPERT_AXIS, 1)
    need = {"llm.num_kv_heads": cfg.llm.num_kv_heads,
            "llm.num_heads": cfg.llm.num_heads,
            "llm.ffn_size": cfg.llm.ffn_size,
            "llm.vocab_size": cfg.llm.vocab_size,
            "vit.num_heads": cfg.vit.num_heads,
            "vit mlp": int(cfg.vit.hidden_size * cfg.vit.mlp_ratio),
            "llm.hidden_size (the projector's fc1)": cfg.llm.hidden_size}
    for what, n in need.items():
        if n % m:
            raise ValueError(f"{what} = {n} does not divide over the "
                             f"model axis of {m}")
    if cfg.llm.moe_experts and cfg.llm.moe_experts % e:
        raise ValueError(f"llm.moe_experts = {cfg.llm.moe_experts} does "
                         f"not divide over the expert axis of {e}")


def model_state(model) -> dict:
    """The model's FULL state dict (a collective under a mesh plan: every
    process calls it; without a plan, the state dict itself)."""
    plan = getattr(model, "mesh_plan", None)
    state = model.state_dict()
    if plan is None:
        return state
    return gather_params(state, plan.layout, plan.mesh)


def load_full_state(model, state: dict) -> None:
    """Load a FULL state dict into a model on a mesh plan (each process
    keeps its shards), or as it is without one."""
    plan = getattr(model, "mesh_plan", None)
    if plan is not None:
        state = shard_params(state, plan.layout, plan.mesh)
    model.load_state_dict(state)


def optimizer_state(optimizer, plan: MeshPlan | None) -> dict:
    """An AdamW's state with whole moments (gathered like their parameters:
    a collective under a plan)."""
    state = optimizer.state_dict()
    if plan is None:
        return state
    return {**state, "mu": gather_params(state["mu"], plan.layout, plan.mesh),
            "nu": gather_params(state["nu"], plan.layout, plan.mesh)}


def shard_optimizer_state(state: dict, plan: MeshPlan | None) -> dict:
    """`optimizer_state`'s inverse: whole moments -> this process's
    shards."""
    if plan is None:
        return state
    return {**state, "mu": shard_params(state["mu"], plan.layout, plan.mesh),
            "nu": shard_params(state["nu"], plan.layout, plan.mesh)}
