"""Multi-LoRA serving: per-request adapters over one shared base model
(port of multi_spatialmllm_tpu/parallel/lora_serving.py).

Adapter pairs are stacked into `[n_adapters + 1, fan_in, r]` / `[.., r,
fan_out]` tables (index 0 is an all-zero base adapter); every row of a
batch gathers its own adapter by index, and the unmerged delta `y +=
scale * (x @ A[idx]) @ B[idx]` is added at each adapted weight
(models/llm.apply_lora_delta, plain `einsum`s, as the JAX package's are
XLA einsums outside any Pallas kernel). One batch mixes requests on
different adapters and on the base model; the base weights are never
copied or re-merged.

Serving supports the LLM decoder targets (attention projections and
SwiGLU). ViT, projector and lm-head adapters would change the vision
features and the logits per row and are refused here: merge those with
parallel/lora.merge_lora instead.
"""

from __future__ import annotations

import torch

from .lora import LoRAConfig, jax_path

_SERVING_TARGETS = ("wq", "wk", "wv", "wo", "gate", "up", "down")


def stack_adapters(adapters: list, num_layers: int,
                   cfg: LoRAConfig | None) -> dict:
    """`[adapter dict, ...]` (parallel/lora.init_lora's structure, trained
    or carried across by models/convert.jax_lora_to_port) -> serving
    tables `{"scale": alpha/rank, "layers": [{target: (A [N+1, fan_in,
    r], B [N+1, r, fan_out])} per decoder layer]}`.

    Adapter i of the list is served as index i + 1; index 0 is the zero
    adapter (the base model). All adapters must share one structure (the
    same weights and rank), and `cfg` must be the LoRAConfig they were
    trained with: the adapters carry the rank (checked) but not alpha."""
    if cfg is None:
        raise ValueError(
            "stack_adapters needs the adapters' LoRAConfig: the tree "
            "carries rank but not alpha, so a default would silently "
            "serve every adapter at the wrong scale")
    if not adapters:
        raise ValueError("need at least one adapter")
    for i, ad in enumerate(adapters[1:], start=1):
        extra = set(ad) ^ set(adapters[0])
        if extra:
            raise ValueError(
                f"adapter {i} and adapter 0 adapt different weights (e.g. "
                f"{sorted(extra)[0]}); all adapters must share one "
                f"structure")
    layers: list[dict] = [dict() for _ in range(num_layers)]
    for name, ad0 in adapters[0].items():
        keys = jax_path(name.rsplit(".", 1)[0])
        target = keys[-2]
        layer_key = next((k for k in keys if k.startswith("layer_")), None)
        if layer_key is None or "llm" not in keys \
                or target not in _SERVING_TARGETS:
            raise ValueError(
                f"multi-LoRA serving supports LLM decoder targets only; "
                f"got adapter at {name} — merge it with "
                f"parallel/lora.merge_lora instead")
        if ad0["a"].shape[-1] != cfg.rank:
            raise ValueError(
                f"adapter rank {ad0['a'].shape[-1]} != cfg.rank {cfg.rank} "
                f"at {name} — pass the training LoRAConfig")
        stacks = tuple(
            torch.stack([torch.zeros_like(ad0[part])]
                        + [ad[name][part] for ad in adapters])
            for part in ("a", "b"))
        layers[int(layer_key.split("_")[1])][target] = stacks
    return {"scale": cfg.scale, "layers": layers}


def shard_serving_tables(model, tables: dict) -> dict:
    """`stack_adapters`' tables as a process of a tensor-parallel model
    (parallel/sharding.shard_model) applies them: a column-parallel
    weight's B keeps its share of the outputs, a row-parallel weight's A
    its share of the inputs (that delta is then partial, and is summed over
    the model axis with the weight's own partial output). The tables as
    they are on a model without a model axis, and for a target the layer
    does not hold (a routed MoE's gate/up/down, which its FFN refuses)."""
    if model.llm.tp is None:
        return tables
    out = []
    for i, layer in enumerate(tables["layers"]):
        mods = {n.rsplit(".", 1)[-1]: m
                for n, m in model.llm.layers[i].named_modules()}
        new = {}
        for target, (a, b) in layer.items():
            shard = getattr(mods.get(target), "tp", None)
            if shard is not None and shard.kind == "col":
                b = shard.take(b, 2).contiguous()
            elif shard is not None and shard.kind == "row":
                a = shard.take(a, 1).contiguous()
            new[target] = (a, b)
        out.append(new)
    return {**tables, "layers": out}
