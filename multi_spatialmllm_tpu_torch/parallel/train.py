"""Training step for the multi-frame MLLM on one device (the port of
multi_spatialmllm_tpu/parallel/train.py, without its mesh).

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

Parameters, gradients and both moments are float32 (the model holds float32
master weights, `MultiFrameMLLM(..., param_dtype=torch.float32)`). Unlike
the JAX step, which returns new trees, the step updates them in place.

Rolling checkpoints keep the JAX package's layout and crash safety: each
save lands in `{root}/step_{N:08d}/` (here one `torch.save` file), `LATEST`
flips to it only after the write, and older step directories beyond `keep`
are pruned.
"""

from __future__ import annotations

import dataclasses
import math
import os
import re
import shutil
from typing import Callable

import torch

from ..models.llm import cross_entropy_sum

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

    @torch.no_grad()
    def update(self, grads: list[torch.Tensor]) -> torch.Tensor:
        """Clip, then one AdamW step; returns the global norm before
        clipping."""
        cfg = self.cfg
        norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
        if not float(norm) < cfg.grad_clip:
            for g in grads:
                g.div_(norm).mul_(cfg.grad_clip)
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


def make_train_step(model, optimizer: AdamW, accum_steps: int = 1
                    ) -> Callable[[dict], dict]:
    """`step(batch) -> {"loss", "grad_norm"}` (0-d tensors on the model's
    device); `batch` is a dict of tensors leading with the batch dim
    (`input_ids`, `labels`, `tiles`, and `positions`/`segment_ids` for
    packed rows).

    `accum_steps > 1` runs the batch as that many microbatches of
    consecutive rows before the one update. As in the JAX step, the loss
    is the summed token nll over the global count of supervised tokens
    (known from the labels before any forward), so accumulation equals the
    single-pass mean even when microbatches carry different token counts.
    A MoE decoder adds `MOE_AUX_WEIGHT * mean aux * count_mb` to each
    microbatch's nll before that one division (`loss_sum_of` in the JAX
    step; with one microbatch it equals `loss_of`'s mean + weight * aux).
    """
    params = optimizer.params
    use_moe = model.cfg.llm.moe_experts > 0

    def step(batch: dict) -> dict:
        n = batch["input_ids"].shape[0]
        if n % accum_steps:
            raise ValueError(f"batch {n} not divisible by accum {accum_steps}")
        mb = n // accum_steps
        denom = (batch["labels"][:, 1:] != -100).sum().clamp_min(1).float()
        for p in params:
            p.grad = None
        nll = torch.zeros((), device=denom.device)
        for i in range(accum_steps):
            sub = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            logits, auxes = model(sub["input_ids"], sub["tiles"],
                                  positions=sub.get("positions"),
                                  segment_ids=sub.get("segment_ids"),
                                  with_aux=True)
            mb_nll, count = cross_entropy_sum(logits[:, :-1],
                                              sub["labels"][:, 1:])
            del logits
            if use_moe:
                mb_nll = mb_nll + (MOE_AUX_WEIGHT * moe_aux_mean(auxes)
                                   * count.to(mb_nll.dtype))
            (mb_nll / denom).backward()
            nll += mb_nll.detach()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in params]
        grad_norm = optimizer.update(grads)
        for p in params:
            p.grad = None
        return {"loss": nll / denom, "grad_norm": grad_norm}

    return step


def save_checkpoint(path: str, model, optimizer: AdamW | None = None,
                    step: int = 0) -> None:
    """One `torch.save` file under directory `path`: the model's state
    dict, the optimizer state (when given) and the step."""
    os.makedirs(path, exist_ok=True)
    payload = {"params": model.state_dict(), "step": step}
    if optimizer is not None:
        payload["opt_state"] = optimizer.state_dict()
    tmp = os.path.join(path, CHECKPOINT_FILE + ".tmp")
    torch.save(payload, tmp)
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


def save_checkpoint_rolling(root: str, model, optimizer: AdamW | None = None,
                            step: int = 0, keep: int = 2) -> str:
    """Crash-safe rolling save into `{root}/step_{N:08d}`; returns it."""
    os.makedirs(root, exist_ok=True)
    out = os.path.join(os.path.abspath(root), f"step_{step:08d}")
    save_checkpoint(out, model, optimizer, step=step)
    _commit_latest(root, step, keep)
    return out


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
