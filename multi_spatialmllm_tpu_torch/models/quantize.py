"""Weight-only int8 for serving: port of multi_spatialmllm_tpu/models/quantize.py.

A quantised weight is held as int8 with float32 scales, per output
channel, symmetric: half the bytes of bf16 weights at rest. The consuming
module dequantises it at use (`dequantized`: `int8.float() * scale`, then
the module's usual cast to the compute dtype), the same values the JAX
package's `maybe_dequantize` feeds its Flax modules, so torch needs no
counterpart of that function or of `quantize_weights`/`is_quantized`:
`quantize_model` quantises a model in place. A model holding quantised
weights computes exactly what a model holding `dequantize_weights` of its
state dict computes (the JAX package's oracle).

The filters are the JAX package's: floating weights of at least 2 dims
(as the JAX tree lays them out) and `min_size` elements, outside any
module whose name holds a `skip` substring (default "embed": the token
table, which a gather reads, and the ViT's `patch_embed` and `pos_embed`,
whose JAX paths hold it too). Norm scales, biases and small tables stay
as they are. The scale of a weight is per channel of its JAX kernel's
trailing axis: per output row of a `Linear` `[out, in]` (the JAX kernel is
`[in, out]`) and of a convolution `[O, C, kh, kw]`; per head-dim index of
the head-shaped projections `wq`/`wk`/`wv` and the ViT's `qkv` (their JAX
kernels end in `(heads, hd)`, so JAX reduces over the heads too); per
trailing channel of the tables kept in the JAX layout (MoE experts and
router, embeddings).

In a quantised model the weight's parameter becomes an int8 buffer of the
same name and shape, with its scale as the buffer `<name>_qscale`; its
state dict holds both.
"""

from __future__ import annotations

import torch
from torch import nn

SCALE = "_qscale"
DEFAULT_SKIP = ("embed",)
F32_TINY = torch.finfo(torch.float32).tiny


def dequantized(module: nn.Module, name: str) -> torch.Tensor:
    """`module.<name>`, dequantised to float32 when it is held in int8
    (`int8.float() * scale`), else the tensor itself. A parameter the
    module holds as an FSDP shard (parallel/sharding.shard_model) is
    gathered whole first."""
    scale = module._buffers.get(name + SCALE)
    w = getattr(module, name)
    gather = module.__dict__.get("_gather")
    if gather is not None and name in gather:
        w = gather[name](w)
    return w if scale is None else w.float() * scale


def _head_dim(cfg, name: str) -> int | None:
    """The head dim of a weight whose JAX kernel ends in `(heads, hd)`."""
    parts = name.split(".")
    if parts[0] == "llm" and parts[-2] in ("wq", "wk", "wv"):
        return cfg.llm.head_dim
    if parts[0] == "vision" and parts[-2] == "qkv":
        return cfg.vit.hidden_size // cfg.vit.num_heads
    return None


def _jax_ndim(module: nn.Module, name: str, p: torch.Tensor,
              hd: int | None) -> int:
    if hd is not None and name.endswith(".bias"):
        return 3                              # the ViT qkv bias [3, H, hd]
    if isinstance(module, nn.Linear) and name.endswith(".weight") \
            and hd is not None:
        return 3                              # DenseGeneral [D, H, hd]
    return p.dim()


def _scale(module: nn.Module, name: str, w: torch.Tensor,
           hd: int | None) -> torch.Tensor:
    """Per-channel scales `max|w| / 127` (floored at the float32 tiny),
    shaped to broadcast against `w`."""
    a = w.float().abs()
    if hd is not None:                        # per head-dim index
        lead = a.shape[0] // hd
        m = a.reshape(lead, hd, -1).amax(dim=(0, 2)).repeat(lead)
        m = m.reshape((a.shape[0],) + (1,) * (a.dim() - 1))
    elif isinstance(module, (nn.Linear, nn.Conv2d)) \
            and name.endswith(".weight"):     # torch puts the output first
        m = a.amax(dim=tuple(range(1, a.dim())), keepdim=True)
    else:                                     # the JAX layout: last axis
        m = a.amax(dim=tuple(range(a.dim() - 1)), keepdim=True)
    qmax = torch.full((), 127.0, device=a.device)     # true division
    return torch.clamp(m / qmax, min=F32_TINY)


def _eligible(name: str, p: torch.Tensor, ndim: int, min_size: int,
              skip: tuple) -> bool:
    if ndim < 2 or p.numel() < min_size or not p.is_floating_point():
        return False
    return not any(s in part for s in skip for part in name.split("."))


def quantize_tensor(w: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """`clip(rint(w / scale), -127, 127)` as int8."""
    return torch.clamp(torch.round(w.float() / scale), -127, 127).to(
        torch.int8)


def _targets(model: nn.Module, min_size: int, skip: tuple):
    cfg = model.cfg
    for mod_name, mod in model.named_modules():
        for leaf, p in list(mod.named_parameters(recurse=False)):
            name = f"{mod_name}.{leaf}" if mod_name else leaf
            hd = _head_dim(cfg, name)
            if _eligible(name, p, _jax_ndim(mod, name, p, hd), min_size,
                         skip):
                yield mod, leaf, name, p, hd


@torch.no_grad()
def quantize_model(model: nn.Module, min_size: int = 1 << 16,
                   skip: tuple = DEFAULT_SKIP) -> nn.Module:
    """Quantise the model's eligible weights in place (each parameter
    becomes an int8 buffer and its scale buffer; the float weight is
    freed) and return the model."""
    for mod, leaf, name, p, hd in list(_targets(model, min_size, skip)):
        s = _scale(mod, name, p, hd)
        q = quantize_tensor(p, s)
        del mod._parameters[leaf]
        mod.register_buffer(leaf, q)
        mod.register_buffer(leaf + SCALE, s)
    return model


def dequantize_weights(sd: dict) -> dict:
    """A quantised state dict with every int8 weight expanded to float32
    (`int8.float() * scale`) and the scales dropped: the oracle a
    quantised model is held to."""
    out = {}
    for k, v in sd.items():
        if k.endswith(SCALE):
            continue
        scale = sd.get(k + SCALE)
        out[k] = v if scale is None else v.float() * scale
    return out


def tree_nbytes(tree) -> int:
    """Bytes of a model's parameters and buffers, or of a state dict."""
    if isinstance(tree, nn.Module):
        tensors = list(tree.parameters()) + list(tree.buffers())
    else:
        tensors = list(tree.values())
    return sum(t.numel() * t.element_size() for t in tensors)
