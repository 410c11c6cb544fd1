"""LoRA adapters for training (port of multi_spatialmllm_tpu/parallel/
lora.py).

The reference's main-paper training is LoRA over InternVL-2. Low-rank
deltas `scale * (A @ B)` ride on selected weights of a frozen base; the
optimizer holds only the adapters, which is what lets the whole-depth
flagship train on one card (AdamW moments of the base would be another
64 GB).

* Adapters are a dict `{port weight name: {"a": [fan_in, r], "b": [r,
  fan_out]}}` of float32 tensors, for every `Linear` weight whose JAX path
  matches a target (`_target_of`, the JAX package's rule: a target name
  anywhere on the path, never under "moe"). Weights are held `[out, in]`
  with the JAX kernel's trailing dims flattened, so a delta on a weight is
  `((A @ B) * scale).T` (models/llm.merge_adapter).
* `B` starts at zero, so the merged model equals the base at init.
* `init_lora` draws A as JAX does: one key split per adapted weight in
  `jax.tree_util.tree_flatten_with_path` order (dict keys sorted at every
  level: `layer_10` before `layer_2`, `llm` before `projector` before
  `vision`), `normal / sqrt(fan_in)` in float32 (models/prng.py's
  `normal`; a few ulp from JAX's, see there).
* The train step merges each adapted weight inside its layer's forward
  (`W.float() + delta`, cast to W's dtype: the product, then the scale,
  then the add), so whole-layer remat recomputes the merge and no layer's
  merged weight outlives its layer; the base is never written.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable

import torch

from ..models.llm import Linear, merge_adapter
from ..models.prng import normal, split
from .train import MeshComm, all_reduce_grads, global_sum, masked_nll

# target name -> number of leading JAX kernel dims that are fan-in
_FAN_IN_DIMS = {
    "wq": 1, "wk": 1, "wv": 1, "wo": 2,          # LLM attention
    "gate": 1, "up": 1, "down": 1,               # LLM SwiGLU
    "qkv": 1, "proj": 2, "fc1": 1, "fc2": 1,     # ViT
    "lm_head": 1,
}


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    rank: int = 16
    alpha: float = 32.0
    # module names whose weight gets an adapter (keys of _FAN_IN_DIMS); the
    # reference-style default adapts the LLM attention projections
    targets: tuple[str, ...] = ("wq", "wk", "wv", "wo")

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


def jax_path(module_name: str) -> tuple[str, ...]:
    """The JAX param path of a port `Linear`'s weight: `blocks.i` ->
    `block_i`, `layers.i` -> `layer_i`, then `kernel`."""
    parts = module_name.split(".")
    out: list[str] = []
    i = 0
    while i < len(parts):
        if parts[i] in ("blocks", "layers") and i + 1 < len(parts):
            out.append(f"{parts[i][:-1]}_{parts[i + 1]}")
            i += 2
        else:
            out.append(parts[i])
            i += 1
    return tuple(out) + ("kernel",)


def _target_of(keys: tuple[str, ...], cfg: LoRAConfig) -> str | None:
    if not keys or keys[-1] != "kernel":
        return None
    if "moe" in keys:
        # routed-MoE expert tables are plain params (no "kernel"); the
        # guard keeps a Dense-based expert from matching "wo"
        return None
    for t in cfg.targets:
        if t in keys:
            return t
    return None


def adapted_weights(model: torch.nn.Module, cfg: LoRAConfig) -> list:
    """`(weight name, Linear module, target)` of every weight `cfg` adapts,
    in JAX flatten order."""
    found = []
    for name, mod in model.named_modules():
        if isinstance(mod, Linear):
            keys = jax_path(name)
            target = _target_of(keys, cfg)
            if target is not None:
                found.append((keys, f"{name}.weight", mod, target))
    found.sort(key=lambda f: f[0])
    return [f[1:] for f in found]


@torch.no_grad()
def init_lora(model: torch.nn.Module, cfg: LoRAConfig,
              key: torch.Tensor) -> dict:
    """`{weight name: {"a": [fan_in, r], "b": [r, fan_out]}}` (float32, on
    the model's device) for every weight `cfg.targets` matches. A is drawn
    on the host (the same bits on every device) from `key` (a
    models/prng.py key), B is zero. The model holds its full weights (call
    it before parallel/sharding.shard_model)."""
    out: dict = {}
    key = key.cpu()
    for name, mod, _ in adapted_weights(model, cfg):
        fan_out, fan_in = mod.weight.shape
        key, sub = split(key)
        a = normal(sub, (fan_in, cfg.rank)) / torch.tensor(
            math.sqrt(fan_in), dtype=torch.float32)
        dev = mod.weight.device
        out[name] = {"a": a.to(dev),
                     "b": torch.zeros(cfg.rank, fan_out, device=dev)}
    return out


@torch.no_grad()
def merge_lora(state: dict, lora: dict, cfg: LoRAConfig) -> dict:
    """A state dict with every adapted weight merged (`merge_adapter`: new
    tensors in the base dtypes); every other entry is the base's own
    tensor. Also the export path of a merged checkpoint."""
    return {k: merge_adapter(v, lora[k], cfg.scale) if k in lora else v
            for k, v in state.items()}


def lora_param_count(lora: dict) -> int:
    return sum(t.numel() for ad in lora.values() for t in ad.values())


def lora_named_tensors(lora: dict) -> list[tuple[str, torch.Tensor]]:
    """`(name, tensor)` of every adapter tensor (`<weight>:a`,
    `<weight>:b`): the optimizer's parameters."""
    return [(f"{w}:{part}", ad[part]) for w, ad in lora.items()
            for part in ("a", "b")]


def lora_from_optimizer(optimizer) -> dict:
    """The adapters an optimizer over `lora_named_tensors` updates."""
    lora: dict = {}
    for name, t in zip(optimizer.names, optimizer.params):
        w, part = name.rsplit(":", 1)
        lora.setdefault(w, {})[part] = t
    return lora


@contextlib.contextmanager
def merged(model: torch.nn.Module, lora: dict | None, cfg: LoRAConfig | None):
    """Within the block each weight `lora` adapts is a separate merged
    tensor (`merge_adapter`; on a mesh, of this process's whole TP shard,
    gathered first if FSDP shards it) and no `Linear` merges at its
    forward; on exit the base parameters, their FSDP gathering and every
    `Linear`'s adapter as it was are put back. The base tensors are never
    written. A no-op when `lora` is None."""
    if lora is None:
        yield model
        return
    before = [(m, m.adapter) for m in model.modules()
              if isinstance(m, Linear)]
    swapped = []
    try:
        for mod, _ in before:
            mod.adapter = None
        with torch.no_grad():
            for name, mod, _ in adapted_weights(model, cfg):
                gather = mod.__dict__.get("_gather", {}).pop("weight", None)
                swapped.append((mod, mod.weight, gather))
                w = mod.weight if gather is None else gather(mod.weight)
                mod.weight = torch.nn.Parameter(
                    merge_adapter(w, lora[name], cfg.scale, shard=mod.tp),
                    requires_grad=False)
        yield model
    finally:
        for mod, base, gather in swapped:
            mod.weight = base
            if gather is not None:
                mod._gather["weight"] = gather
        for mod, adapter in before:
            mod.adapter = adapter


def attach(model: torch.nn.Module, lora: dict, scale: float) -> None:
    """Make each adapted `Linear` merge its adapter at every forward."""
    for name, mod in model.named_modules():
        if isinstance(mod, Linear):
            ad = lora.get(f"{name}.weight")
            mod.adapter = None if ad is None else (ad, scale)


def make_lora_train_step(model, optimizer, cfg: LoRAConfig, mesh=None
                         ) -> Callable[[dict], dict]:
    """`step(batch) -> {"loss", "grad_norm"}` (0-d tensors): the masked
    next-token loss of the merged model, its gradients with respect to the
    adapters alone, and one update of `optimizer` (parallel/train.AdamW
    over `lora_named_tensors`). The base is frozen (`requires_grad_(False)`,
    so no gradient or moment is kept for it, and a tower with no adapter
    takes no backward); the adapters ride on the model (`attach`).

    With a `mesh` the step runs over it as `parallel/train.make_train_step`
    does: `batch` holds this process's rows of the global batch, the loss
    is the global nll sum over the global token count, and only the
    adapters' gradients are summed over the processes. The adapters
    replicate, as in JAX; on a tensor-parallel base (parallel/sharding.
    shard_model) each process merges the slice of a delta that matches its
    shard of the weight (models/llm.merge_adapter), so every adapter's
    gradient is also summed over "model"."""
    from ..ops.ring_attention import ring_context

    model.requires_grad_(False)
    lora = lora_from_optimizer(optimizer)
    for ad in lora.values():
        for t in ad.values():
            t.requires_grad_(True)
    attach(model, lora, cfg.scale)
    params = optimizer.params
    comm = MeshComm(model, optimizer, mesh, model_summed=True)

    def step(batch: dict) -> dict:
        for p in params:
            p.grad = None
        denom = global_sum((batch["labels"][:, 1:] != -100).sum(),
                           comm.rows).clamp_min(1).float()
        with ring_context(mesh):
            loss = masked_nll(model, batch) / denom
            loss.backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in params]
        all_reduce_grads(grads, comm.grad_groups)
        grad_norm = optimizer.update(grads)
        for p in params:
            p.grad = None
        return {"loss": global_sum(loss.detach(), comm.tokens),
                "grad_norm": grad_norm}

    return step
