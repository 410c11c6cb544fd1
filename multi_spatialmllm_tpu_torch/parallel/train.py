"""Training step for the multi-frame MLLM (the port of
multi_spatialmllm_tpu/parallel/train.py), on one device or over a mesh.

The optimizer is the JAX package's optax chain, written out:
`clip_by_global_norm(grad_clip)` then `adamw(warmup_cosine_decay_schedule(
0, lr, warmup, total), b1, b2, eps=1e-8, weight_decay)`. What that fixes,
and a stock PyTorch optimizer would change:

* the schedule is read at the update count *before* the step, so the first
  update has learning rate 0;
* clipping scales by `max_norm / norm` only when `norm >= max_norm`, as
  `(g / norm) * max_norm`, with no epsilon;
* the reported `grad_norm` is the norm before clipping;
* Adam's eps is added after the square root of the bias-corrected second
  moment, and the decay is decoupled: `u += wd * p`, then `p -= lr * u`.

With a routed-MoE decoder the loss adds `MOE_AUX_WEIGHT` times the mean of
the layers' load-balance statistics, weighted by each microbatch's token
count as the JAX step's `loss_sum_of` does.

Over a mesh (`mesh=`, parallel/mesh.py): each process of the data and
expert axes holds its own rows of the global batch (`local_rows`), and
under a "seq" axis each row's block of the sequence (models/mllm.py,
ops/ring_attention.py). The JAX step shards that batch and XLA computes
every reduction over the global batch; here the step computes the same
global quantities with collectives. The token nll is `sum nll / global
token count`: the count is summed over the row axes before the division,
the nll over the row and seq axes, and after the backward each gradient
is summed over the axes the batch is split over that do not shard its
parameter (`MeshComm`, parallel/sharding.MeshPlan), once a step, before
the clip, whose global norm sums each shard's squares once over the group
its parameter is sharded over. A model put on the mesh by
parallel/sharding.shard_model runs tensor-parallel over "model" (its
Megatron regions' collectives inside the forward and backward), FSDP
over "data" (gathered at each use, gradients reduce-scattered) and its
expert tables over "expert". A MoE decoder's load-balance statistic is
the global batch's (`models/moe.data_parallel`). With one process on an
axis the axis's collectives are skipped, and the step is the
single-device step.

Parameters, gradients and both moments are float32 (the model holds float32
master weights, `MultiFrameMLLM(..., param_dtype=torch.float32)`). Unlike
the JAX step, which returns new trees, the step updates them in place.

Rolling checkpoints keep the JAX package's layout and crash safety: each
save lands in `{root}/step_{N:08d}/` (here one `torch.save` file), `LATEST`
flips to it only after the write, and older step directories beyond `keep`
are pruned. `AsyncRollingSaver` writes on a background thread from a host
copy taken before `save()` returns (the step updates tensors in place, so
a write of the live tensors would be torn), and flips `LATEST` only once a
write is complete.
"""

from __future__ import annotations

import dataclasses
import math
import os
import re
import shutil
import threading
from typing import Callable

import numpy as np
import torch

from ..models.llm import cross_entropy_sum
from ..models.moe import data_parallel
from ..utils.profiling import span
from .distributed import global_batch_slice

ADAM_EPS = 1e-8             # optax.adamw's default
MOE_AUX_WEIGHT = 0.01       # the JAX make_train_step's default
CHECKPOINT_FILE = "checkpoint.pt"


@dataclasses.dataclass
class TrainConfig:
    learning_rate: float = 1e-5
    weight_decay: float = 0.01
    b1: float = 0.9
    b2: float = 0.95
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000


def learning_rate(cfg: TrainConfig, count: int) -> float:
    """`optax.warmup_cosine_decay_schedule(0, lr, warmup, max(total,
    warmup + 1))` at update count `count`: linear from 0 over the warmup,
    then cosine decay to 0 at `total`."""
    warmup = cfg.warmup_steps
    total = max(cfg.total_steps, warmup + 1)
    if count < warmup:
        return cfg.learning_rate * count / warmup
    decay_steps = total - warmup
    c = min(count - warmup, decay_steps)
    return cfg.learning_rate * 0.5 * (1 + math.cos(math.pi * c / decay_steps))


class AdamW:
    """optax `chain(clip_by_global_norm, adamw)` over named float32
    parameters; `update(grads)` applies one step in place."""

    def __init__(self, named_params: list[tuple[str, torch.Tensor]],
                 cfg: TrainConfig):
        self.cfg = cfg
        self.names = [n for n, _ in named_params]
        self.params = [p for _, p in named_params]
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0
        # per parameter, the group whose shards make it whole (set by the
        # train steps on a mesh; None: every parameter whole here)
        self.norm_groups: list | None = None

    def global_norm(self, grads: list[torch.Tensor]) -> torch.Tensor:
        """The gradients' global norm: each shard's squares summed once
        over the group its parameter is sharded over."""
        if self.norm_groups is None:
            return torch.sqrt(sum(g.float().square().sum() for g in grads))
        sums: dict = {}
        for g, group in zip(grads, self.norm_groups):
            sq = g.float().square().sum()
            sums[group] = sq if group not in sums else sums[group] + sq
        from .sharding import all_reduce_

        return torch.sqrt(sum(all_reduce_(v, k) for k, v in sums.items()))

    @torch.no_grad()
    def update(self, grads: list[torch.Tensor]) -> torch.Tensor:
        """Clip, then one AdamW step; returns the global norm before
        clipping."""
        with span("msm.train.optimizer", device=True):
            return self._update(grads)

    def _update(self, grads: list[torch.Tensor]) -> torch.Tensor:
        cfg = self.cfg
        norm = self.global_norm(grads)
        # optax's select(norm < clip, g, (g / norm) * clip) on the device,
        # as g / den * scale in place: den = scale = 1 under the clip (the
        # same bits as g), no host read of the norm and no temporaries
        keep = norm < cfg.grad_clip
        torch._foreach_div_(grads, torch.where(keep, 1.0, norm))
        torch._foreach_mul_(grads, torch.where(keep, 1.0, cfg.grad_clip))
        lr = learning_rate(cfg, self.count)
        self.count += 1
        bc1 = 1 - cfg.b1 ** self.count
        bc2 = 1 - cfg.b2 ** self.count
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
            v.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
            u = (m / bc1).div_((v / bc2).sqrt_().add_(ADAM_EPS))
            u.add_(p, alpha=cfg.weight_decay)
            p.add_(u, alpha=-lr)
        return norm

    def state_dict(self) -> dict:
        return {"count": self.count,
                "mu": dict(zip(self.names, self.mu)),
                "nu": dict(zip(self.names, self.nu))}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        for name, m, v in zip(self.names, self.mu, self.nu):
            m.copy_(state["mu"][name])
            v.copy_(state["nu"][name])


def moe_aux_mean(auxes: list) -> torch.Tensor | float:
    """Mean of the per-layer MoE statistics (None entries, dense layers,
    left out), so the coefficient does not depend on the depth."""
    vals = [a for a in auxes if a is not None]
    return sum(vals) / max(len(vals), 1)


def all_reduce_grads(grads: list[torch.Tensor], groups: list) -> None:
    """Sum each gradient over its group's processes (None: nothing), in
    place. Gradients of a group travel in flat buckets of at most `_BUCKET`
    elements."""
    from .sharding import all_reduce_

    buckets: dict = {}
    for g, group in zip(grads, groups):
        if group is not None:
            buckets.setdefault((group, g.dtype), []).append(g)
    for (group, _), gs in buckets.items():
        start = 0
        while start < len(gs):
            end, size = start, 0
            while end < len(gs) and (end == start
                                     or size + gs[end].numel() <= _BUCKET):
                size += gs[end].numel()
                end += 1
            part = gs[start:end]
            flat = all_reduce_(torch.cat([g.reshape(-1) for g in part]),
                               group)
            for g, piece in zip(part, flat.split([g.numel() for g in part])):
                g.copy_(piece.view_as(g))
            start = end


_BUCKET = 1 << 26


def global_sum(t: torch.Tensor, group) -> torch.Tensor:
    """`t` summed over `group`'s processes (a copy; `t` itself without a
    group)."""
    if group is None:
        return t
    from .sharding import all_reduce_

    return all_reduce_(t.clone(), group)


class MeshComm:
    """The groups a train step on `mesh` reduces over: `rows` (the axes a
    batch's rows are split over: data and expert) for the token count,
    `tokens` (rows and, under a ring, each row's blocks over seq) for the
    nll and the MoE statistic, and per optimizer parameter the group its
    gradient is all-reduced over and the group its shards make it whole
    over (parallel/sharding.MeshPlan; a model without a plan is whole on
    every process). `model_summed` sums every gradient over "model" too
    (adapters used a share at a time on a TP model)."""

    def __init__(self, model, optimizer, mesh, model_summed=False):
        from .mesh import axes_group, model_axis
        from .sharding import BATCH_AXES, ROW_AXES, MeshPlan

        self.mesh = mesh
        self.rows = axes_group(mesh, ROW_AXES)[0]
        self.tokens = axes_group(mesh, BATCH_AXES)[0]
        plan = getattr(model, "mesh_plan", None) or \
            MeshPlan(mesh, {}, frozenset())
        extra = model_summed and model_axis(mesh)[0] is not None
        self.grad_groups = [plan.grad_group(n, extra)
                            for n in optimizer.names]
        norm = [plan.norm_group(n) for n in optimizer.names]
        if any(g is not None for g in norm):
            optimizer.norm_groups = norm


def next_token_nll(model, logits: torch.Tensor, labels: torch.Tensor):
    """`(nll sum, count)` of the next-token loss of `model`'s `logits`
    (its vocab shard's on the model axis: `vocab_shard=True`) for the
    rows' `labels` `[B, T]`; under a ring the logits are this process's
    block of the sequence and the labels of its positions' next tokens are
    taken (the last position of the row predicts nothing)."""
    from ..models.mllm import ring_block

    tp = model.llm.tp
    block = ring_block(labels.shape[1])
    if block is None:
        return cross_entropy_sum(logits[:, :-1], labels[:, 1:], tp=tp)
    nxt = torch.nn.functional.pad(labels[:, 1:], (0, 1), value=-100)
    return cross_entropy_sum(logits, nxt[:, block], tp=tp)


def make_train_step(model, optimizer: AdamW, accum_steps: int = 1,
                    mesh=None) -> Callable[[dict], dict]:
    """`step(batch) -> {"loss", "grad_norm"}` (0-d tensors on the model's
    device); `batch` is a dict of tensors leading with the batch dim
    (`input_ids`, `labels`, `tiles`, and `positions`/`segment_ids` for
    packed rows). With a `mesh`, `batch` holds this process's rows of the
    global batch (`local_rows`: for microbatch i, its share over the data
    and expert axes of the global microbatch i, as the JAX step shards
    each one), and the loss and grad norm returned are the global batch's,
    on every process. A model put on the mesh by
    parallel/sharding.shard_model runs tensor-parallel over "model", FSDP
    over "data" and its MoE tables over "expert"; with a "seq" axis the
    rows are whole and each process computes its block of the sequence,
    attention over the ring (ops/ring_attention.py).

    `accum_steps > 1` runs the batch as that many microbatches of
    consecutive rows before the one update. As in the JAX step, the loss
    is the summed token nll over the global count of supervised tokens
    (known from the labels before any forward), so accumulation equals the
    single-pass mean even when microbatches carry different token counts.
    A MoE decoder adds `MOE_AUX_WEIGHT * mean aux * count_mb` to each
    microbatch's nll before that one division (`loss_sum_of` in the JAX
    step; with one microbatch it equals `loss_of`'s mean + weight * aux).
    """
    from ..ops.ring_attention import ring_context
    from .sharding import check_moe_mesh

    params = optimizer.params
    use_moe = model.cfg.llm.moe_experts > 0
    check_moe_mesh(model.cfg, mesh)
    comm = MeshComm(model, optimizer, mesh)

    def step(batch: dict) -> dict:
        n = batch["input_ids"].shape[0]
        if n % accum_steps:
            raise ValueError(f"batch {n} not divisible by accum {accum_steps}")
        mb = n // accum_steps
        denom = global_sum((batch["labels"][:, 1:] != -100).sum(),
                           comm.rows).clamp_min(1).float()
        for p in params:
            p.grad = None
        nll = torch.zeros((), device=denom.device)
        with data_parallel(model, comm.tokens), ring_context(mesh):
            for i in range(accum_steps):
                sub = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                logits, auxes = model(sub["input_ids"], sub["tiles"],
                                      positions=sub.get("positions"),
                                      segment_ids=sub.get("segment_ids"),
                                      with_aux=True, vocab_shard=True)
                with span("msm.train.loss", device=True):
                    mb_nll, count = next_token_nll(model, logits,
                                                   sub["labels"])
                    del logits
                    if use_moe:
                        # the global microbatch's count weighs this
                        # process's share of its statistic
                        mb_nll = mb_nll + (
                            MOE_AUX_WEIGHT * moe_aux_mean(auxes)
                            * global_sum(count, comm.tokens).to(mb_nll.dtype))
                with span("msm.train.backward", device=True):
                    (mb_nll / denom).backward()
                nll += mb_nll.detach()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in params]
        all_reduce_grads(grads, comm.grad_groups)
        grad_norm = optimizer.update(grads)
        for p in params:
            p.grad = None
        return {"loss": global_sum(nll, comm.tokens) / denom,
                "grad_norm": grad_norm}

    return step


def local_rows(batch: dict, accum_steps: int, mesh) -> dict:
    """This process's rows of a global batch (numpy arrays or tensors
    leading with the batch dim), as `make_train_step` takes them: the JAX
    step splits the global batch into `accum_steps` microbatches of
    consecutive rows and shards each over the data axis, so the process
    keeps, of each microbatch, the rows `global_batch_slice` gives it. The
    rows are split over the data and expert axes together (coordinate
    `data * n_expert + expert`); the model and seq axes' processes hold
    the same rows."""
    from .mesh import axes_group
    from .sharding import ROW_AXES

    _, rank, size = axes_group(mesh, ROW_AXES)
    n = len(batch["input_ids"])
    if n % accum_steps:
        raise ValueError(f"batch {n} not divisible by accum {accum_steps}")
    mb = n // accum_steps
    start, per = global_batch_slice(mb, rank, size)
    idx = np.concatenate([np.arange(i * mb + start, i * mb + start + per)
                          for i in range(accum_steps)])
    return {k: v[idx] for k, v in batch.items()}


def make_chained_train_step(model, optimizer: AdamW, n_steps: int,
                            mesh=None) -> Callable[[dict], torch.Tensor]:
    """`run(batch) -> losses [n_steps]`: `n_steps` full train steps on one
    batch (forward, backward, clip and AdamW update of the parameters in
    place), each step's work `make_train_step`'s with one microbatch: the
    JAX package's `make_chained_train_step`, the harness behind bench.py's
    `model` block. As there, the loss is the masked mean cross entropy
    alone (no MoE load-balance term). The losses stay on the device,
    stacked, for one fetch by the caller; nothing in the chain reads the
    device from the host. With a `mesh`, `batch` is this process's rows of
    the global batch, as for `make_train_step`, and the losses are the
    global batch's."""
    from ..ops.ring_attention import ring_context

    params = optimizer.params
    comm = MeshComm(model, optimizer, mesh)

    def run(batch: dict) -> torch.Tensor:
        denom = global_sum((batch["labels"][:, 1:] != -100).sum(),
                           comm.rows).clamp_min(1).float()
        losses = []
        for _ in range(n_steps):
            for p in params:
                p.grad = None
            with ring_context(mesh):
                loss = masked_nll(model, batch) / denom
                loss.backward()
            grads = [torch.zeros_like(p) if p.grad is None else p.grad
                     for p in params]
            all_reduce_grads(grads, comm.grad_groups)
            optimizer.update(grads)
            losses.append(global_sum(loss.detach(), comm.tokens))
        for p in params:
            p.grad = None
        return torch.stack(losses)

    return run


def masked_nll(model, batch: dict) -> torch.Tensor:
    """The summed next-token nll of `batch` under `model` (no MoE term):
    `models/mllm.loss_fn`'s numerator (this block's, under a ring)."""
    logits = model(batch["input_ids"], batch["tiles"],
                   positions=batch.get("positions"),
                   segment_ids=batch.get("segment_ids"), vocab_shard=True)
    return next_token_nll(model, logits, batch["labels"])[0]


def _payload(params, optimizer, step: int) -> dict:
    """What a checkpoint holds: `params` (a model's state dict, or a state
    dict), the optimizer state when given (an AdamW, or its state dict),
    and the step."""
    state = params.state_dict() if hasattr(params, "state_dict") else params
    payload = {"params": state, "step": step}
    if optimizer is not None:
        payload["opt_state"] = optimizer if isinstance(optimizer, dict) \
            else optimizer.state_dict()
    return payload


def save_checkpoint(path: str, params, optimizer: AdamW | None = None,
                    step: int = 0) -> None:
    """One `torch.save` file under directory `path`: the state dict of
    `params` (a model, or a state dict such as merged LoRA weights), the
    optimizer state (when given) and the step."""
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, CHECKPOINT_FILE + ".tmp")
    torch.save(_payload(params, optimizer, step), tmp)
    os.replace(tmp, os.path.join(path, CHECKPOINT_FILE))


def _commit_latest(root: str, step: int, keep: int) -> None:
    """Atomically flip `{root}/LATEST` to step_{N} and prune completed step
    dirs beyond `keep`."""
    tmp = os.path.join(root, "LATEST.tmp")
    with open(tmp, "w") as f:
        f.write(f"step_{step:08d}\n")
    os.replace(tmp, os.path.join(root, "LATEST"))
    steps = sorted(d for d in os.listdir(root)
                   if re.fullmatch(r"step_\d{8}", d))
    for stale in steps[:-keep] if keep else []:
        shutil.rmtree(os.path.join(root, stale), ignore_errors=True)


def save_checkpoint_rolling(root: str, params,
                            optimizer: AdamW | None = None,
                            step: int = 0, keep: int = 2) -> str:
    """Crash-safe rolling save into `{root}/step_{N:08d}`; returns it."""
    os.makedirs(root, exist_ok=True)
    out = os.path.join(os.path.abspath(root), f"step_{step:08d}")
    save_checkpoint(out, params, optimizer, step=step)
    _commit_latest(root, step, keep)
    return out


_ASYNC_TMP = ".async-tmp"


def _host_copy(tree):
    """A host copy of every tensor of a nested dict, taken now."""
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        return t.clone() if t.device.type == "cpu" else t.cpu()
    return tree


class AsyncRollingSaver:
    """Asynchronous crash-safe rolling saves (the train CLI's
    `--async-save`).

    `save()` returns once a host copy of the state exists; the write then
    runs on a background thread, into `{root}/step_N.async-tmp`, renamed to
    `step_N` when it is complete. `LATEST` flips to a step only after its
    write has finished, on the next `save()` or on `wait()`, so an
    interrupted run never points `LATEST` at a half-written directory.
    Half-written leftovers of an earlier run are cleared at init."""

    def __init__(self, root: str, keep: int = 2):
        self.root = os.path.abspath(root)
        self.keep = keep
        self._pending: tuple[int, threading.Thread, list] | None = None
        os.makedirs(self.root, exist_ok=True)
        for d in os.listdir(self.root):
            if d.endswith(_ASYNC_TMP):
                shutil.rmtree(os.path.join(self.root, d), ignore_errors=True)

    def _write(self, payload: dict, step: int, errors: list) -> None:
        try:
            out = os.path.join(self.root, f"step_{step:08d}")
            tmp = out + _ASYNC_TMP
            os.makedirs(tmp, exist_ok=True)
            torch.save(payload, os.path.join(tmp, CHECKPOINT_FILE))
            if os.path.exists(out):
                shutil.rmtree(out)
            os.replace(tmp, out)
        except BaseException as exc:   # re-raised by the committing call
            errors.append(exc)

    def _commit(self) -> None:
        if self._pending is None:
            return
        step, thread, errors = self._pending
        thread.join()
        self._pending = None
        if errors:
            raise errors[0]
        _commit_latest(self.root, step, self.keep)

    def save(self, params, optimizer: AdamW | None = None,
             step: int = 0) -> str:
        """Finish the previous save, copy the state to the host and start
        its write; returns the step dir it will land in."""
        self._commit()
        payload = _host_copy(_payload(params, optimizer, step))
        errors: list = []
        thread = threading.Thread(target=self._write,
                                  args=(payload, step, errors), daemon=True)
        thread.start()
        self._pending = (step, thread, errors)
        return os.path.join(self.root, f"step_{step:08d}")

    def wait(self) -> None:
        """Block until every pending save is written and committed."""
        self._commit()


def resolve_checkpoint(path: str) -> str:
    """Accept a step directory or a rolling-save root (resolves
    `{path}/LATEST` to its step dir)."""
    latest = os.path.join(path, "LATEST")
    if os.path.exists(latest):
        with open(latest) as f:
            return os.path.join(path, f.read().strip())
    return path


def restore_checkpoint(path: str, map_location=None) -> dict:
    """The payload `save_checkpoint` wrote (`params`, `step`, and
    `opt_state` when saved) from a step dir or a rolling root."""
    return torch.load(os.path.join(resolve_checkpoint(path), CHECKPOINT_FILE),
                      map_location=map_location, weights_only=True)
