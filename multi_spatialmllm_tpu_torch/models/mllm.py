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

from ..ops.ring_attention import active_ring_mesh
from ..parallel.sharding import tp_region_enter
from ..utils.profiling import span
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
        self.tp = None      # the model axis's place (parallel/sharding.py)

    def forward(self, vision_tokens):
        h = self.norm(vision_tokens)
        if self.tp is not None:     # fc1 column-, fc2 row-parallel
            h = tp_region_enter(h, self.tp.group)
        return self.fc2(gelu(self.fc1(h)))


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
        with span("msm.model.vit", device=True):
            feats = self.vision(tiles)[:, 1:]  # drop cls
            feats = pixel_shuffle(feats, self.cfg.vit.grid,
                                  self.cfg.downsample)
            return self.projector(feats)

    def spliced_embeds(self, input_ids: torch.Tensor,
                       tiles: torch.Tensor,
                       block: slice | None = None) -> torch.Tensor:
        """Token embeddings with vision features scattered into the
        IMG_CONTEXT slots by the clipped cumsum slot index. `input_ids`
        `[B, T]`, `tiles` `[B, N_tiles, H, W, 3]`; `block` keeps those
        positions only (a ring's block of the sequence)."""
        b = input_ids.shape[0]
        n_tiles = tiles.shape[1]
        if n_tiles == 0:      # text-only prompt: nothing to splice
            ids = input_ids if block is None else input_ids[:, block]
            return self.llm.embed(ids)
        vis = self.encode_tiles(
            tiles.reshape((b * n_tiles,) + tiles.shape[2:]))
        return self.splice(input_ids,
                           vis.reshape(b, n_tiles * vis.shape[1], -1), block)

    def splice(self, input_ids: torch.Tensor, vis: torch.Tensor,
               block: slice | None = None) -> torch.Tensor:
        """Token embeddings of `input_ids` `[B, T]` with the projected
        vision features `vis` `[B, N, D]` (or `[1, N, D]`, shared by every
        row) in the IMG_CONTEXT slots, in order. With `block`, the rows'
        positions in it only: the slots are counted over the whole rows,
        so each image token lands in the block that holds its position."""
        is_ctx = input_ids == self.cfg.img_context_id
        slot = torch.cumsum(is_ctx.long(), dim=1) - 1
        if block is not None:
            input_ids, is_ctx, slot = (a[:, block] for a in
                                       (input_ids, is_ctx, slot))
        embeds = self.llm.embed(input_ids)
        if vis.shape[1] == 0:
            return embeds
        vis = vis.expand(input_ids.shape[0], -1, -1)
        slot = slot.clamp(0, vis.shape[1] - 1)
        gathered = torch.gather(
            vis, 1, slot[..., None].expand(-1, -1, vis.shape[-1]))
        return torch.where(is_ctx[..., None], gathered.to(embeds.dtype),
                           embeds)

    def forward(self, input_ids: torch.Tensor, tiles: torch.Tensor,
                positions: torch.Tensor | None = None,
                segment_ids: torch.Tensor | None = None,
                with_aux: bool = False, vocab_shard: bool = False):
        """Training forward: logits `[B, T, vocab]`, and with `with_aux`
        `(logits, per-layer MoE statistics)` (the JAX package's sown
        `moe_aux_loss` values; None for dense layers). `positions` and
        `segment_ids` `[B, T]` come with packed rows (models/data
        `pack_samples`): per-segment RoPE positions and a block-diagonal
        causal mask; without them, positions count from 0 and attention is
        causal over the whole row.

        Under a ring (ops/ring_attention.ring_context) the rows are whole
        and this process computes its block of the sequence: the logits
        come back for the block's positions only (`ring_block`). With
        `vocab_shard` a tensor-parallel process's logits are its vocab
        shard's (for the vocab-parallel loss)."""
        block = ring_block(input_ids.shape[1])
        embeds = self.spliced_embeds(input_ids, tiles, block)
        b, t, _ = embeds.shape
        if positions is None:
            start = 0 if block is None else block.start
            positions = torch.arange(start, start + t,
                                     device=embeds.device).expand(b, t)
        elif block is not None:
            positions = positions[:, block]
        if segment_ids is not None and block is not None:
            segment_ids = segment_ids[:, block]
        with span("msm.model.llm", device=True):
            logits, _, auxes = self.llm(embeds, positions,
                                        segment_ids=segment_ids,
                                        inference=False, with_aux=True,
                                        vocab_shard=vocab_shard)
        return (logits, auxes) if with_aux else logits

    def prefill(self, input_ids: torch.Tensor, tiles: torch.Tensor,
                caches: list | None = None, lora: dict | None = None):
        """Prompt prefill -> `(logits, kv rows per layer)`, or with
        contiguous `caches` at index 0 (llm.init_cache) `(logits, None per
        layer)`, the prompt's kv written into them. Right padding is
        harmless: attention is causal, so logits at real positions never
        see pad keys, and the pad kv rows are never admitted by the decode
        mask (the caller rewinds the position to the true length). `lora`
        is a multi-adapter serving bundle (parallel/lora_serving.py's
        `stack_adapters` with a per-row `idx`)."""
        embeds = self.spliced_embeds(input_ids, tiles)
        b, t, _ = embeds.shape
        positions = torch.arange(t, device=embeds.device).expand(b, t)
        with span("msm.model.llm", device=True):
            return self.llm(embeds, positions, caches, inference=True,
                            lora=lora)


def ring_block(seq_len: int) -> slice | None:
    """This process's block of a row of `seq_len` tokens under the active
    ring, or None without one."""
    ring = active_ring_mesh()
    if ring is None:
        return None
    _, rank, n = ring
    if seq_len % n:
        raise ValueError(f"sequence length {seq_len} does not divide over "
                         f"the seq axis of {n}")
    blk = seq_len // n
    return slice(rank * blk, (rank + 1) * blk)


def loss_fn(model: MultiFrameMLLM, batch: dict):
    """Masked next-token loss over a batch dict of tensors with
    `input_ids`, `tiles`, `labels` (already shifted, -100 = ignore) and,
    for packed rows, `positions` and `segment_ids`."""
    logits = model(batch["input_ids"], batch["tiles"],
                   positions=batch.get("positions"),
                   segment_ids=batch.get("segment_ids"))
    return cross_entropy_loss(logits[:, :-1], batch["labels"][:, 1:])


def make_example_batch(cfg: MLLMConfig, batch: int = 1, n_tiles: int = 2,
                       seq_len: int = 512, seed: int = 0,
                       device="cuda") -> dict:
    """The JAX package's synthetic batch (`make_example_batch`) as
    bench.py's `model` block draws it (x64 off), from the same key, on
    `device`: `input_ids` of `jax.random.randint(key(seed), (batch,
    seq_len), 10, vocab)` with IMG_CONTEXT at positions 1 .. the tiles'
    tokens, `tiles` of `jax.random.normal(key(seed), ...)` in float32 (the
    same key: JAX draws both from it), `labels` the ids with -100 at
    IMG_CONTEXT. The ids are equal to JAX's; the tiles within the few ulp
    of `prng.normal`."""
    from . import prng

    key = prng.key(seed, device=device)
    t_img = cfg.tokens_per_tile * n_tiles
    if seq_len <= t_img + 2:
        raise ValueError(f"seq_len {seq_len} leaves no text beside "
                         f"{t_img} image tokens")
    ids = prng.randint(key, (batch, seq_len), 10, cfg.llm.vocab_size)
    ids[:, 1:1 + t_img] = cfg.img_context_id
    size = cfg.vit.image_size
    tiles = prng.normal(key, (batch, n_tiles, size, size, 3))
    labels = torch.where(ids == cfg.img_context_id, -100, ids)
    return {"input_ids": ids, "tiles": tiles, "labels": labels}


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
    (GQA 2:1, SwiGLU, hd 128), remat on with the JAX config's selective
    policy, `dots_and_flash_saveable`: a layer's backward keeps its matrix
    products and its flash forward's (o, lse), and recomputes only
    elementwise ops (models/llm.remat_layer). This is the config behind
    bench.py's `model` block (train tokens/s and MFU)."""
    pol = "dots_and_flash_saveable"
    vit = ViTConfig(image_size=448, patch_size=14, hidden_size=1024,
                    num_layers=6, num_heads=16, remat=True,
                    remat_policy=pol)
    llm = LLMConfig(vocab_size=32000, hidden_size=2048, num_layers=8,
                    num_heads=16, num_kv_heads=8, ffn_size=8192,
                    max_seq_len=4096, remat=True, remat_policy=pol)
    return MLLMConfig(vit=vit, llm=llm)


def bench_1chip_moe_config(num_experts: int = 4, impl: str = "einsum",
                           kernel: str = "xla") -> MLLMConfig:
    """The JAX package's `bench_1chip_moe_config`: the bench config with
    every decoder MLP swapped for a top-2 routed MoE at the same total
    parameter count (FFN 8192/E per expert), GShard groups of 256 tokens
    for the einsum impl's training. The ragged impl keeps the bench
    config's policy (K8's grouped products are recomputed under it); the
    einsum impl recomputes whole layers, as in JAX, where saving the
    dispatch and combine outputs of 8 layers did not fit one chip."""
    base = bench_1chip_config()
    pol = base.llm.remat_policy if impl == "ragged" else None
    return dataclasses.replace(base, llm=dataclasses.replace(
        base.llm, moe_experts=num_experts,
        ffn_size=base.llm.ffn_size // num_experts, moe_group=256,
        moe_impl=impl, moe_kernel=kernel, remat_policy=pol))


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
