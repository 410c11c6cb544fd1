"""InternViT-style vision transformer encoder in PyTorch.

Port of multi_spatialmllm_tpu/models/vit.py: pre-norm ViT with learned
position embeddings and a class token. Tiles come in NHWC, as in the JAX
package. Attention goes through the trainable flash op (forward K1,
backward K2/K3) with the token count (1 + grid^2 = 1025 at 448/14) padded
to a multiple of 128 and the pads in their own segment, so they are masked
exactly and the kernels skip their tiles. Weights are cast to the config
dtype at use (see models/llm.py); `remat` checkpoints each block, under
`remat_policy` (models/llm.remat_layer). On the model axis a block
computes its share of the heads and of the MLP (parallel/sharding.py).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import trainable_flash_attention_packed
from ..parallel.sharding import tp_region_enter
from .llm import DTYPES, Linear, check_remat_policy, remat_layer
from .quantize import dequantized


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 448
    patch_size: int = 14
    hidden_size: int = 1024
    num_layers: int = 6
    num_heads: int = 16
    mlp_ratio: float = 4.0
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    remat: bool = False  # recompute each block's activations in backward
    remat_policy: str | None = None  # see LLMConfig.remat_policy

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size


class LayerNorm(nn.Module):
    """Flax `nn.LayerNorm(dtype=...)` semantics: float32 statistics
    (variance as E[x^2] - E[x]^2, floored at 0), float32 scale and bias,
    result cast to `dtype`. Flax's default eps is 1e-6."""

    def __init__(self, dim: int, eps: float = 1e-6, dtype=None, device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.ones(dim, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(
            torch.zeros(dim, dtype=torch.float32, device=device))

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf.square().mean(dim=-1, keepdim=True)
               - mean.square()).clamp_min(0.0)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight)
        return (y + self.bias).to(self.dtype or x.dtype)


def gelu(x):
    """Flax `nn.gelu` is the tanh approximation."""
    return F.gelu(x, approximate="tanh")


class ViTBlock(nn.Module):
    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dtype = DTYPES[cfg.dtype]
        d = cfg.hidden_size
        kw = {"device": device, "dtype": dtype}
        self.norm1 = LayerNorm(d, cfg.norm_eps, dtype, device)
        self.qkv = Linear(d, 3 * d, **kw)          # out laid out (3, H, hd)
        self.proj = Linear(d, d, **kw)
        self.norm2 = LayerNorm(d, cfg.norm_eps, dtype, device)
        self.fc1 = Linear(d, int(d * cfg.mlp_ratio), **kw)
        self.fc2 = Linear(int(d * cfg.mlp_ratio), d, **kw)
        self.tp = None      # the model axis's place (parallel/sharding.py)

    def forward(self, x):
        """On the model axis the block computes its share of the heads and
        of the MLP (qkv and fc1 column-parallel, proj and fc2
        row-parallel)."""
        cfg = self.cfg
        group = None if self.tp is None else self.tp.group
        h = tp_region_enter(self.norm1(x), group)
        b, t, d = h.shape
        hd = d // cfg.num_heads
        nh = cfg.num_heads // (1 if self.tp is None else self.tp.size)
        qkv = self.qkv(h).view(b, t, 3, nh, hd)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        pad = (-t) % 128
        q, k, v = (F.pad(a, (0, 0, 0, pad)) for a in (q, k, v))
        seg = torch.cat([
            torch.zeros(b, t, dtype=torch.int32, device=x.device),
            torch.ones(b, pad, dtype=torch.int32, device=x.device)], dim=1)
        attn = trainable_flash_attention_packed(q, k, v, seg, False)
        attn = attn[:, :, :t].transpose(1, 2).reshape(b, t, nh * hd)
        x = x + self.proj(attn)
        h = tp_region_enter(self.norm2(x), group)
        return x + self.fc2(gelu(self.fc1(h)))


class VisionTransformer(nn.Module):
    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        check_remat_policy(cfg)
        self.cfg = cfg
        dtype = DTYPES[cfg.dtype]
        d, p = cfg.hidden_size, cfg.patch_size
        self.compute_dtype = dtype
        self.patch_embed = nn.Conv2d(3, d, p, stride=p, device=device,
                                     dtype=dtype)
        self.patch_embed.compute_dtype = dtype
        self.cls_token = nn.Parameter(
            torch.zeros(1, 1, d, dtype=dtype, device=device))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, 1 + cfg.num_patches, d, dtype=dtype,
                        device=device))
        self.blocks = nn.ModuleList(
            ViTBlock(cfg, device) for _ in range(cfg.num_layers))

    def forward(self, pixels):
        """pixels `[B, H, W, 3]` normalized tiles -> `[B, 1 + P, D]`."""
        dtype = DTYPES[self.cfg.dtype]
        conv = self.patch_embed
        x = F.conv2d(pixels.to(dtype).permute(0, 3, 1, 2),
                     dequantized(conv, "weight").to(dtype),
                     conv.bias.to(dtype), stride=conv.stride)
        x = x.flatten(2).transpose(1, 2)             # [B, P, D], row-major
        b = x.shape[0]
        cls = dequantized(self, "cls_token").to(dtype)
        x = torch.cat([cls.expand(b, -1, -1), x], dim=1)
        x = x + dequantized(self, "pos_embed").to(dtype)
        remat = self.cfg.remat and torch.is_grad_enabled()
        for block in self.blocks:
            x = remat_layer(block, self.cfg, x) if remat else block(x)
        return x
