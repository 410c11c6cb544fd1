"""LLaMA/InternLM2-style decoder (RMSNorm, RoPE, GQA, SwiGLU) in PyTorch.

Port of multi_spatialmllm_tpu/models/llm.py: the training forward and
prompt prefill (causal flash attention through the trainable op, with
per-segment positions and a block-diagonal mask for packed rows; prefill
without a cache returns the fresh kv rows), the decode forwards over a
kv cache, and the masked next-token losses. A layer's cache is one of:

* contiguous (`init_cache`): k/v `[B, KVH, max_len, hd]` written in place
  at `index`, a scalar shared by every row or a per-row `[B]` tensor
  (clamped so the t rows fit, as `dynamic_update_slice` clamps). A
  multi-token forward at a scalar index is the prompt prefill: it attends
  within the fresh kv through flash attention (the CUDA kernel on the
  card). Every other forward attends over the cache with the grouped
  masked einsums, query row i of a row admitting positions <= index + i
  (decode, and the speculative verify chain).
* paged (k_pages, v_pages, page_table, index, and k_scale/v_scale for
  int8 pools): one token a slot goes through the paged decode op (the
  CUDA kernel on the card lands the new kv row, native or int8, and
  attends); t > 1 tokens (chunked prefill, speculative verify) are
  scattered at their (page, offset), quantised first for int8 pools, and
  attend over each slot's gathered, dequantised page window with the same
  masked einsums.

The caches are updated in place; the caller sets `index`. With
`moe_experts > 0` every layer's FFN is a routed MoE (models/moe.py); each
layer returns its load-balance statistic, and `inference` (every forward
with a cache) selects the MoE's inference routing.

Numerics follow the Flax modules: RMSNorm and RoPE compute in float32 and
cast back; RoPE rotates split halves; every weight is cast to the config
dtype at use, as Flax `Dense`/`Embed` cast their float32 params, so a model
may hold float32 master weights (training), weights already in the
compute dtype (serving, where the casts are no-ops) or int8 weights with
their scales (models/quantize.py, dequantised to float32 at use); norm
scales stay float32. `remat` checkpoints each whole layer
(`torch.utils.checkpoint`).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import (
    trainable_flash_attention,
    trainable_flash_attention_packed,
)
from ..ops.paged_attention import (
    grouped_attention,
    paged_decode_attention,
    window_attention,
    write_kv_chain,
)
from .moe import MoEMLP
from .quantize import dequantized

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class LLMConfig:
    vocab_size: int = 32000
    hidden_size: int = 2048
    num_layers: int = 8
    num_heads: int = 16
    num_kv_heads: int = 4
    ffn_size: int = 5632
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    max_seq_len: int = 8192
    dtype: str = "bfloat16"
    remat: bool = False  # recompute each layer's activations in backward
    # routed MoE FFN (models/moe.py); 0 keeps the dense SwiGLU
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity: float = 2.0   # expert buffer = ceil(top_k*T*cap/E)
    moe_impl: str = "einsum"    # "einsum" (GShard dispatch) or "ragged"
    moe_group: int = 0          # training routes in groups of this many
    moe_kernel: str = "xla"     # ragged products: "pallas" = K8, "xla"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """`(cos, sin)` `[B, 1, T, head_dim/2]` f32 for positions `[B, T]`;
    computed once per forward and shared by every layer."""
    freqs = rope_frequencies(head_dim, theta, positions.device)
    angles = positions[:, None, :, None].float() * freqs
    return torch.cos(angles), torch.sin(angles)


def rotate(x: torch.Tensor, rope) -> torch.Tensor:
    """RoPE on x `[B, H, T, D]` with `rope_tables`' (cos, sin): split
    halves rotated in f32, cast back."""
    cos, sin = rope
    x1, x2 = x.float().chunk(2, dim=-1)
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return rotated.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x `[B, H, T, D]`; positions `[B, T]` (int)."""
    return rotate(x, rope_tables(positions, x.shape[-1], theta))


class Linear(nn.Linear):
    """`nn.Linear` with Flax `Dense(dtype=...)` semantics: input, weight and
    bias are cast to the compute dtype (the dtype it was built in) at use,
    whatever dtype the parameters are held in."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True,
                 device=None, dtype=None):
        super().__init__(d_in, d_out, bias=bias, device=device, dtype=dtype)
        self.compute_dtype = dtype

    def forward(self, x):
        cd = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(cd)
        return F.linear(x.to(cd), dequantized(self, "weight").to(cd), bias)


class Embedding(nn.Embedding):
    """`nn.Embedding` with Flax `Embed(dtype=...)` semantics: rows come out
    in the compute dtype (gathered, then cast: the same values as casting
    the table first)."""

    def __init__(self, n: int, d: int, device=None, dtype=None):
        super().__init__(n, d, device=device, dtype=dtype)
        self.compute_dtype = dtype

    def forward(self, ids):
        return F.embedding(ids, dequantized(self, "weight")).to(
            self.compute_dtype)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(
            torch.ones(dim, dtype=torch.float32, device=device))

    def forward(self, x):
        xf = x.float()
        var = xf.square().mean(dim=-1, keepdim=True)
        return (xf * torch.rsqrt(var + self.eps) * self.weight).to(x.dtype)


class Attention(nn.Module):
    def __init__(self, cfg: LLMConfig, device=None):
        super().__init__()
        self.cfg = cfg
        kw = {"bias": False, "device": device, "dtype": DTYPES[cfg.dtype]}
        hd, d = cfg.head_dim, cfg.hidden_size
        self.wq = Linear(d, cfg.num_heads * hd, **kw)
        self.wk = Linear(d, cfg.num_kv_heads * hd, **kw)
        self.wv = Linear(d, cfg.num_kv_heads * hd, **kw)
        self.wo = Linear(cfg.num_heads * hd, d, **kw)

    def forward(self, x, rope, cache=None, segment_ids=None):
        """`rope`: `rope_tables` of the positions. Without a cache
        (training, prefill): causal attention over the fresh kv
        (block-diagonal within equal `segment_ids` `[B, T]` for packed
        rows), returning `(out, (k, v))` with k/v `[B, KVH, T, hd]`. With a
        contiguous or paged cache (see the module docstring): `(out,
        None)`, the cache updated in place."""
        cfg = self.cfg
        b, t, _ = x.shape
        hd = cfg.head_dim
        q = self.wq(x).view(b, t, cfg.num_heads, hd).transpose(1, 2)
        k = self.wk(x).view(b, t, cfg.num_kv_heads, hd).transpose(1, 2)
        v = self.wv(x).view(b, t, cfg.num_kv_heads, hd).transpose(1, 2)
        q, k = rotate(q, rope), rotate(k, rope)
        kv = None
        if cache is None:
            if segment_ids is None:
                out = trainable_flash_attention(q, k, v, True)
            else:
                out = trainable_flash_attention_packed(q, k, v, segment_ids,
                                                       True)
            kv = (k, v)
        elif "k_pages" in cache:
            if t == 1:
                out = paged_decode_attention(
                    q, cache["k_pages"], cache["v_pages"],
                    cache["page_table"], cache["index"], k[:, :, 0],
                    v[:, :, 0], cache.get("k_scale"), cache.get("v_scale"))
            else:
                scales = (cache.get("k_scale"), cache.get("v_scale"))
                write_kv_chain(cache["k_pages"], cache["v_pages"],
                               cache["page_table"], cache["index"], k, v,
                               *scales)
                out = window_attention(q, cache["k_pages"], cache["v_pages"],
                                       cache["page_table"], cache["index"],
                                       *scales)
        else:
            idx = cache["index"]
            scalar = not isinstance(idx, torch.Tensor) or idx.dim() == 0
            write_cache_rows(cache, k, v)
            if t > 1 and scalar:
                # prompt prefill (index 0): attend within the fresh kv
                out = trainable_flash_attention(q, k, v, True)
            else:
                kv_len = cache["k"].shape[2]
                cur = (torch.as_tensor(idx, device=x.device).long()
                       .reshape(-1, 1) + torch.arange(t, device=x.device))
                valid = (torch.arange(kv_len, device=x.device)[None, None, :]
                         <= cur[:, :, None])
                out = grouped_attention(q, cache["k"], cache["v"], valid)
        out = out.transpose(1, 2).reshape(b, t, cfg.num_heads * hd)
        return self.wo(out), kv


def write_cache_rows(cache: dict, k: torch.Tensor, v: torch.Tensor) -> None:
    """Write k/v `[B, KVH, t, hd]` into a contiguous cache at its index (a
    scalar, or a per-row `[B]` tensor), in place; the start is clamped to
    `[0, max_len - t]` as `lax.dynamic_update_slice` clamps it."""
    max_len, t = cache["k"].shape[2], k.shape[2]
    idx = cache["index"]
    if not isinstance(idx, torch.Tensor) or idx.dim() == 0:
        start = min(max(int(idx), 0), max_len - t)
        cache["k"][:, :, start:start + t] = k
        cache["v"][:, :, start:start + t] = v
        return
    start = idx.long().clamp(0, max_len - t)
    pos = start[:, None] + torch.arange(t, device=k.device)         # [B, t]
    rows = torch.arange(k.shape[0], device=k.device)[:, None]
    cache["k"][rows, :, pos] = k.transpose(1, 2)
    cache["v"][rows, :, pos] = v.transpose(1, 2)


def init_cache(cfg: LLMConfig, batch: int, max_len: int, device=None):
    """An empty contiguous kv cache, one dict a layer: k/v `[batch, KVH,
    max_len, hd]` in the config dtype (zeros) and index 0."""
    dtype = DTYPES[cfg.dtype]
    shape = (batch, cfg.num_kv_heads, max_len, cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device),
             "index": 0} for _ in range(cfg.num_layers)]


class MLP(nn.Module):
    def __init__(self, cfg: LLMConfig, device=None):
        super().__init__()
        kw = {"bias": False, "device": device, "dtype": DTYPES[cfg.dtype]}
        self.gate = Linear(cfg.hidden_size, cfg.ffn_size, **kw)
        self.up = Linear(cfg.hidden_size, cfg.ffn_size, **kw)
        self.down = Linear(cfg.ffn_size, cfg.hidden_size, **kw)

    def forward(self, x):
        return self.down(F.silu(self.gate(x)) * self.up(x))


class DecoderLayer(nn.Module):
    def __init__(self, cfg: LLMConfig, device=None):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.hidden_size, cfg.norm_eps, device)
        self.attn = Attention(cfg, device)
        self.mlp_norm = RMSNorm(cfg.hidden_size, cfg.norm_eps, device)
        if cfg.moe_experts > 0:
            self.moe = MoEMLP(cfg, device)
        else:
            self.mlp = MLP(cfg, device)

    def forward(self, x, rope, cache=None, segment_ids=None,
                inference: bool = False):
        """-> `(x, kv, aux)`: aux is the MoE load-balance statistic (None
        for a dense FFN). Pads (segment id 0) take no expert capacity and
        leave the statistic; `inference` marks prefill and decode."""
        attn_out, kv = self.attn(self.attn_norm(x), rope, cache, segment_ids)
        x = x + attn_out
        h = self.mlp_norm(x)
        if hasattr(self, "moe"):
            valid = None if segment_ids is None else segment_ids != 0
            out, aux = self.moe(h, valid=valid, inference=inference)
            return x + out, kv, aux
        return x + self.mlp(h), kv, None


class DecoderLM(nn.Module):
    """Embeddings-in / logits-out decoder; `embed` is applied by the
    caller (the MLLM splices vision features into the embeddings)."""

    def __init__(self, cfg: LLMConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dtype = DTYPES[cfg.dtype]
        self.embed = Embedding(cfg.vocab_size, cfg.hidden_size,
                               device=device, dtype=dtype)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, device) for _ in range(cfg.num_layers))
        self.final_norm = RMSNorm(cfg.hidden_size, cfg.norm_eps, device)
        self.lm_head = Linear(cfg.hidden_size, cfg.vocab_size, bias=False,
                              device=device, dtype=dtype)

    def forward(self, input_embeds, positions, caches=None, segment_ids=None,
                inference: bool = False, with_aux: bool = False):
        """`caches`: None, or one contiguous or paged cache dict per layer
        (see the module docstring); `segment_ids` `[B, T]` for packed
        rows (with per-segment `positions`); `inference` True for prefill
        and decode (the MoE's inference routing), False for training.
        Returns `(logits, kv rows per layer)`, and with `with_aux` also the
        per-layer MoE statistics (None for dense layers)."""
        x = input_embeds
        rope = rope_tables(positions, self.cfg.head_dim, self.cfg.rope_theta)
        remat = self.cfg.remat and caches is None and torch.is_grad_enabled()
        kvs, auxes = [], []
        for i, layer in enumerate(self.layers):
            if remat:
                x, kv, aux = checkpoint(layer, x, rope, None, segment_ids,
                                        inference, use_reentrant=False)
            else:
                x, kv, aux = layer(x, rope,
                                   None if caches is None else caches[i],
                                   segment_ids, inference)
            kvs.append(kv)
            auxes.append(aux)
        logits = self.lm_head(self.final_norm(x))
        return (logits, kvs, auxes) if with_aux else (logits, kvs)


def cross_entropy_sum(logits, labels, ignore_index: int = -100):
    """Masked next-token loss, unnormalised: `(nll_sum, token_count)` with
    the log-softmax in float32. Summing these over microbatches and dividing
    once makes gradient accumulation equal to the single-batch mean."""
    mask = labels != ignore_index
    safe = torch.where(mask, labels, torch.zeros_like(labels)).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    return (nll * mask).sum(), mask.sum()


def cross_entropy_loss(logits, labels, ignore_index: int = -100):
    """Masked next-token loss; `labels` are already shifted by the caller."""
    nll_sum, count = cross_entropy_sum(logits, labels, ignore_index)
    return nll_sum / count.clamp_min(1)
