"""Multi-frame spatial MLLM in PyTorch: ViT + pixel-shuffle projector +
decoder, with vision features spliced into the token stream at
IMG_CONTEXT positions. Port of multi_spatialmllm_tpu/models/mllm.py: the
training forward (`forward`, padded or packed rows) and `loss_fn`, and the
inference entry points `encode_tiles`, `spliced_embeds` (with `splice`,
which takes the vision features already projected) and `prefill`.

A model built with `param_dtype=torch.float32` holds float32 master
weights and computes in its config dtype, as the Flax modules do with
their float32 params (training); without it, the weights are held in the
compute dtype (serving)."""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from .llm import DTYPES, DecoderLM, Linear, LLMConfig, cross_entropy_loss
from .moe import MoEMLP
from .vit import LayerNorm, ViTConfig, VisionTransformer, gelu

IMG_CONTEXT_ID_DEFAULT = 3  # reserved token id for vision-token slots


@dataclasses.dataclass(frozen=True)
class MLLMConfig:
    vit: ViTConfig = ViTConfig()
    llm: LLMConfig = LLMConfig()
    img_context_id: int = IMG_CONTEXT_ID_DEFAULT
    downsample: int = 2  # pixel-shuffle factor (InternVL uses 0.5 scale)

    @property
    def tokens_per_tile(self) -> int:
        return self.vit.num_patches // (self.downsample ** 2)


def pixel_shuffle(x: torch.Tensor, grid: int, factor: int) -> torch.Tensor:
    """`[B, P, D] -> [B, P/f^2, D*f^2]` spatial-to-depth on the patch grid."""
    b, _, d = x.shape
    x = x.reshape(b, grid // factor, factor, grid // factor, factor, d)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (grid // factor) ** 2, d * factor * factor)


class Projector(nn.Module):
    def __init__(self, cfg: MLLMConfig, device=None):
        super().__init__()
        dtype = DTYPES[cfg.llm.dtype]
        d_in = cfg.vit.hidden_size * cfg.downsample ** 2
        d = cfg.llm.hidden_size
        self.norm = LayerNorm(d_in, 1e-6, dtype, device)
        self.fc1 = Linear(d_in, d, device=device, dtype=dtype)
        self.fc2 = Linear(d, d, device=device, dtype=dtype)

    def forward(self, vision_tokens):
        return self.fc2(gelu(self.fc1(self.norm(vision_tokens))))


class MultiFrameMLLM(nn.Module):
    def __init__(self, cfg: MLLMConfig, device=None, param_dtype=None):
        super().__init__()
        self.cfg = cfg
        self.vision = VisionTransformer(cfg.vit, device)
        self.projector = Projector(cfg, device)
        self.llm = DecoderLM(cfg.llm, device)
        if param_dtype is not None:
            self.to(param_dtype)

    def encode_tiles(self, tiles: torch.Tensor) -> torch.Tensor:
        """`[N_tiles, H, W, 3] -> [N_tiles, tokens_per_tile, llm_hidden]`."""
        feats = self.vision(tiles)[:, 1:]  # drop cls
        feats = pixel_shuffle(feats, self.cfg.vit.grid, self.cfg.downsample)
        return self.projector(feats)

    def spliced_embeds(self, input_ids: torch.Tensor,
                       tiles: torch.Tensor) -> torch.Tensor:
        """Token embeddings with vision features scattered into the
        IMG_CONTEXT slots by the clipped cumsum slot index. `input_ids`
        `[B, T]`, `tiles` `[B, N_tiles, H, W, 3]`."""
        b = input_ids.shape[0]
        n_tiles = tiles.shape[1]
        if n_tiles == 0:      # text-only prompt: nothing to splice
            return self.llm.embed(input_ids)
        vis = self.encode_tiles(
            tiles.reshape((b * n_tiles,) + tiles.shape[2:]))
        return self.splice(input_ids,
                           vis.reshape(b, n_tiles * vis.shape[1], -1))

    def splice(self, input_ids: torch.Tensor,
               vis: torch.Tensor) -> torch.Tensor:
        """Token embeddings of `input_ids` `[B, T]` with the projected
        vision features `vis` `[B, N, D]` (or `[1, N, D]`, shared by every
        row) in the IMG_CONTEXT slots, in order."""
        embeds = self.llm.embed(input_ids)
        if vis.shape[1] == 0:
            return embeds
        vis = vis.expand(input_ids.shape[0], -1, -1)
        is_ctx = input_ids == self.cfg.img_context_id
        slot = (torch.cumsum(is_ctx.long(), dim=1) - 1).clamp(
            0, vis.shape[1] - 1)
        gathered = torch.gather(
            vis, 1, slot[..., None].expand(-1, -1, vis.shape[-1]))
        return torch.where(is_ctx[..., None], gathered.to(embeds.dtype),
                           embeds)

    def forward(self, input_ids: torch.Tensor, tiles: torch.Tensor,
                positions: torch.Tensor | None = None,
                segment_ids: torch.Tensor | None = None,
                with_aux: bool = False):
        """Training forward: logits `[B, T, vocab]`, and with `with_aux`
        `(logits, per-layer MoE statistics)` (the JAX package's sown
        `moe_aux_loss` values; None for dense layers). `positions` and
        `segment_ids` `[B, T]` come with packed rows (models/data
        `pack_samples`): per-segment RoPE positions and a block-diagonal
        causal mask; without them, positions count from 0 and attention is
        causal over the whole row."""
        embeds = self.spliced_embeds(input_ids, tiles)
        b, t, _ = embeds.shape
        if positions is None:
            positions = torch.arange(t, device=embeds.device).expand(b, t)
        logits, _, auxes = self.llm(embeds, positions,
                                    segment_ids=segment_ids,
                                    inference=False, with_aux=True)
        return (logits, auxes) if with_aux else logits

    def prefill(self, input_ids: torch.Tensor, tiles: torch.Tensor,
                caches: list | None = None):
        """Prompt prefill -> `(logits, kv rows per layer)`, or with
        contiguous `caches` at index 0 (llm.init_cache) `(logits, None per
        layer)`, the prompt's kv written into them. Right padding is
        harmless: attention is causal, so logits at real positions never
        see pad keys, and the pad kv rows are never admitted by the decode
        mask (the caller rewinds the position to the true length)."""
        embeds = self.spliced_embeds(input_ids, tiles)
        b, t, _ = embeds.shape
        positions = torch.arange(t, device=embeds.device).expand(b, t)
        return self.llm(embeds, positions, caches, inference=True)


def loss_fn(model: MultiFrameMLLM, batch: dict):
    """Masked next-token loss over a batch dict of tensors with
    `input_ids`, `tiles`, `labels` (already shifted, -100 = ignore) and,
    for packed rows, `positions` and `segment_ids`."""
    logits = model(batch["input_ids"], batch["tiles"],
                   positions=batch.get("positions"),
                   segment_ids=batch.get("segment_ids"))
    return cross_entropy_loss(logits[:, :-1], batch["labels"][:, 1:])


def fan_in(module: nn.Module, leaf: str, p: torch.Tensor) -> int:
    """The true fan-in of a weight, keyed on its module and name: a
    `Linear` `[out, in]` -> in, a convolution `[O, C, kh, kw]` -> C*kh*kw,
    and the MoE tables in their JAX layouts: `router` `[D, E]` -> D,
    `wi_gate`/`wi_up` `[E, D, F]` -> D, `wo` `[E, F, D]` -> F."""
    if isinstance(module, MoEMLP):
        return p.shape[0] if leaf == "router" else p.shape[1]
    return math.prod(p.shape[1:])


@torch.no_grad()
def init_random_weights(model: MultiFrameMLLM, seed: int) -> None:
    """Seeded random weights on the model's device (serving smoke runs at
    full width without a checkpoint): matrices, convolutions and expert
    tables normal with std fan_in^-1/2 (`fan_in`), embeddings normal with
    std 0.02, biases zero, norm scales one. Parameters are drawn in
    `named_parameters` order."""
    device = next(model.parameters()).device
    gen = torch.Generator(device=device).manual_seed(seed)
    for mod_name, mod in model.named_modules():
        module = mod_name.rsplit(".", 1)[-1]
        for leaf, p in mod.named_parameters(recurse=False):
            if "norm" in module:
                p.fill_(1.0 if leaf == "weight" else 0.0)
            elif leaf == "bias" or leaf == "cls_token":
                p.zero_()
            elif module in ("embed",) or leaf == "pos_embed":
                p.normal_(0.0, 0.02, generator=gen)
            else:
                p.normal_(0.0, fan_in(mod, leaf, p) ** -0.5, generator=gen)


def tiny_config(**overrides) -> MLLMConfig:
    """Small config for tests/dry runs (same code path as full scale)."""
    vit = ViTConfig(image_size=56, patch_size=14, hidden_size=128,
                    num_layers=2, num_heads=4)
    llm = LLMConfig(vocab_size=512, hidden_size=128, num_layers=2,
                    num_heads=4, num_kv_heads=2, ffn_size=256,
                    max_seq_len=512)
    return MLLMConfig(vit=vit, llm=llm, **overrides)


def tiny_moe_config(num_experts: int = 4, **overrides) -> MLLMConfig:
    """tiny_config with every decoder MLP replaced by a top-2 routed MoE
    (models/moe.py)."""
    base = tiny_config(**overrides)
    return dataclasses.replace(base, llm=dataclasses.replace(
        base.llm, moe_experts=num_experts))


def bench_1chip_config() -> MLLMConfig:
    """The JAX package's `bench` config: flagship-shaped, ~700M params
    (GQA 2:1, SwiGLU, hd 128), remat on (whole layers here; the JAX
    config's selective policy is not ported)."""
    vit = ViTConfig(image_size=448, patch_size=14, hidden_size=1024,
                    num_layers=6, num_heads=16, remat=True)
    llm = LLMConfig(vocab_size=32000, hidden_size=2048, num_layers=8,
                    num_heads=16, num_kv_heads=8, ffn_size=8192,
                    max_seq_len=4096, remat=True)
    return MLLMConfig(vit=vit, llm=llm)


def bench_1chip_moe_config(num_experts: int = 4, impl: str = "einsum",
                           kernel: str = "xla") -> MLLMConfig:
    """The JAX package's `bench_1chip_moe_config`: the bench config with
    every decoder MLP swapped for a top-2 routed MoE at the same total
    parameter count (FFN 8192/E per expert), GShard groups of 256 tokens
    for the einsum impl's training. Remat recomputes whole layers (the
    JAX config's selective policy for the ragged impl is not ported)."""
    base = bench_1chip_config()
    return dataclasses.replace(base, llm=dataclasses.replace(
        base.llm, moe_experts=num_experts,
        ffn_size=base.llm.ffn_size // num_experts, moe_group=256,
        moe_impl=impl, moe_kernel=kernel))


def flagship_config() -> MLLMConfig:
    """InternVL2-8B-like shape (InternViT-300M + 7-8B decoder)."""
    vit = ViTConfig(image_size=448, patch_size=14, hidden_size=1024,
                    num_layers=24, num_heads=16)
    llm = LLMConfig(vocab_size=92544, hidden_size=4096, num_layers=32,
                    num_heads=32, num_kv_heads=8, ffn_size=14336,
                    max_seq_len=8192)
    return MLLMConfig(vit=vit, llm=llm)


CONFIGS = {"flagship": flagship_config, "tiny": tiny_config,
           "bench": bench_1chip_config}


def with_dtype(cfg: MLLMConfig, dtype: str) -> MLLMConfig:
    """`cfg` with both towers in `dtype` ("float32" or "bfloat16")."""
    return dataclasses.replace(
        cfg, vit=dataclasses.replace(cfg.vit, dtype=dtype),
        llm=dataclasses.replace(cfg.llm, dtype=dtype))
