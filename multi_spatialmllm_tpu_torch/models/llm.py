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
scales stay float32. `remat` checkpoints each layer
(`torch.utils.checkpoint`); the config's `remat_policy` names what a
checkpointed layer keeps from its forward (the JAX config's names, see
`remat_layer()`): None recomputes the whole layer.

On a mesh (parallel/sharding.shard_model) a process holds its shard of
the heads, the FFN and the vocabulary and runs Megatron's regions: each
column-parallel group enters a TP region, each row-parallel product's
partial sums are all-reduced, the vocab shards' logits are gathered.
Under a ring (ops/ring_attention.ring_context) training attention runs
over the mesh's "seq" axis.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ..ops.attention import (
    FLASH_FWD_OP,
    trainable_flash_attention,
    trainable_flash_attention_packed,
)
from ..ops.ring_attention import (
    active_ring_mesh,
    ring_attention,
    seq_gathered_packed_attention,
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
    # what a rematerialised layer saves (`remat_policy`); None saves only
    # its inputs
    remat_policy: str | None = None
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


# unbatched matrix products: every Linear (`F.linear` runs `mm`, or `addmm`
# with a bias). The batched ones (`bmm`, `baddbmm`: attention einsums, the
# MoE's dispatch and combine) and K8's grouped products are recomputed, as
# JAX's `dots_with_no_batch_dims_saveable` recomputes dots with batch
# dimensions and the megablox `pallas_call`.
_UNBATCHED_DOTS = frozenset({torch.ops.aten.mm.default,
                             torch.ops.aten.addmm.default})
# the ops whose outputs each selective policy saves
REMAT_POLICIES = {
    "nothing_saveable": frozenset(),
    "dots_with_no_batch_dims_saveable": _UNBATCHED_DOTS,
    # the above plus the flash forward's (o, lse): the backward of a
    # rematerialised layer re-runs only elementwise ops, never a matmul or
    # a forward attention kernel (JAX's `_dots_and_flash_policy`)
    "dots_and_flash_saveable": _UNBATCHED_DOTS | {FLASH_FWD_OP},
}
# saves every activation, so it runs no checkpoint at all (a cache of every
# op's output would also hold buffers that later ops write in place, which
# selective checkpointing refuses)
EVERYTHING_SAVEABLE = "everything_saveable"


def check_remat_policy(cfg):
    """Raise `ValueError` unless `cfg.remat_policy` (LLMConfig or
    ViTConfig) is None, `everything_saveable` or a REMAT_POLICIES name."""
    names = (EVERYTHING_SAVEABLE, *REMAT_POLICIES)
    if cfg.remat_policy is not None and cfg.remat_policy not in names:
        raise ValueError(f"remat_policy {cfg.remat_policy!r} is not one of "
                         f"{sorted(names)}")


def remat_layer(layer, cfg, *args):
    """`layer(*args)` checkpointed under `cfg.remat_policy`: None
    recomputes the whole layer in the backward, `everything_saveable` runs
    no checkpoint, and a REMAT_POLICIES name checkpoints selectively,
    saving the outputs of the ops it names."""
    name = cfg.remat_policy
    if name == EVERYTHING_SAVEABLE:
        return layer(*args)
    kw = {}
    if name is not None:
        keep = REMAT_POLICIES[name]

        def policy(ctx, op, *a, **k):
            return (CheckpointPolicy.MUST_SAVE if op in keep
                    else CheckpointPolicy.PREFER_RECOMPUTE)

        kw["context_fn"] = lambda: create_selective_checkpoint_contexts(
            policy)
    return checkpoint(layer, *args, use_reentrant=False, **kw)


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
    whatever dtype the parameters are held in. A training adapter
    (`adapter`: `({"a", "b"}, scale)`, set by parallel/lora.py) is merged
    into the weight at every forward: `W.float() + ((A @ B) * scale).T`,
    cast back to W's dtype, a new tensor (the base is never written).

    On the model axis (`tp`, a parallel/sharding.TPShard set by
    `shard_model`) the weight is this process's shard: a column-parallel
    layer ("col") computes its share of the outputs, with its share of the
    replicated bias; a row-parallel one ("row") computes partial sums over
    its share of the inputs, adds `extra` (a serving adapter's delta,
    partial as well), all-reduces, then adds the bias once."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True,
                 device=None, dtype=None):
        super().__init__(d_in, d_out, bias=bias, device=device, dtype=dtype)
        self.compute_dtype = dtype
        self.adapter = None
        self.tp = None

    def forward(self, x, extra=None):
        cd = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(cd)
        w = dequantized(self, "weight")
        if self.adapter is not None:
            w = merge_adapter(w, *self.adapter, shard=self.tp)
        tp = self.tp
        if tp is None or tp.kind != "row":
            if tp is not None and bias is not None:
                bias = tp.take(bias, 0)
            return _plus(F.linear(x.to(cd), w.to(cd), bias), extra)
        from ..parallel.sharding import tp_region_exit

        y = tp_region_exit(_plus(F.linear(x.to(cd), w.to(cd)), extra),
                           tp.group)
        return _plus(y, bias)


def merge_adapter(w: torch.Tensor, ad: dict, scale: float,
                  shard=None) -> torch.Tensor:
    """`w` `[out, in]` plus its adapter's delta `((A @ B) * scale).T`
    (A `[in, r]`, B `[r, out]`), added in float32 and cast back to `w`'s
    dtype: the product, then the scale, then the add, as the JAX
    package's `merge_lora`. A new tensor; `w` is untouched. With a model
    axis `shard` (`w` a column- or row-parallel shard) the delta is the
    slice that matches it: B's share of the outputs, or A's of the
    inputs."""
    a, b = ad["a"], ad["b"]
    if shard is not None and shard.kind == "col":
        b = shard.take(b, 1)
    elif shard is not None and shard.kind == "row":
        a = shard.take(a, 0)
    return (w.float() + ((a @ b) * scale).T).to(w.dtype)


def _plus(y: torch.Tensor, d: torch.Tensor | None) -> torch.Tensor:
    return y if d is None else y + d


def apply_lora_delta(x: torch.Tensor, lora: dict | None, name: str,
                     dtype: torch.dtype) -> torch.Tensor | None:
    """Per-row LoRA delta for serving (parallel/lora_serving.py): `lora`
    carries the stacked tables `{name: (A [N, fan_in, r], B [N, r,
    fan_out])}`, a per-row adapter index `idx` `[B]` and the alpha/rank
    scale; each row gathers its own adapter (index 0 is the zero base
    adapter). `x` `[B, T, fan_in]` -> the delta `[B, T, fan_out]` in
    `dtype` (x in float32, `btd,bdr->btr` then `btr,bro->bto`, times the
    scale, then cast), or None when `name` has no adapter."""
    if lora is None or name not in lora["tables"]:
        return None
    a_stack, b_stack = lora["tables"][name]
    a = a_stack[lora["idx"]]
    b = b_stack[lora["idx"]]
    xa = torch.einsum("btd,bdr->btr", x.float(), a)
    return (torch.einsum("btr,bro->bto", xa, b) * lora["scale"]).to(dtype)


class Embedding(nn.Embedding):
    """`nn.Embedding` with Flax `Embed(dtype=...)` semantics: rows come out
    in the compute dtype (gathered, then cast: the same values as casting
    the table first). On the model axis (`tp`) the table is this process's
    shard of the vocabulary."""

    def __init__(self, n: int, d: int, device=None, dtype=None):
        super().__init__(n, d, device=device, dtype=dtype)
        self.compute_dtype = dtype
        self.tp = None

    def forward(self, ids):
        w = dequantized(self, "weight")
        if self.tp is None:
            return F.embedding(ids, w).to(self.compute_dtype)
        # vocab-sharded: this shard's rows, zero for the ids it does not
        # hold, summed over the model axis (one shard holds each id)
        from ..parallel.sharding import tp_region_exit

        local = ids - self.tp.coord * w.shape[0]
        inside = (local >= 0) & (local < w.shape[0])
        rows = F.embedding(local.clamp(0, w.shape[0] - 1), w)
        rows = rows * inside[..., None].to(rows.dtype)
        return tp_region_exit(rows, self.tp.group).to(self.compute_dtype)


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
        self.tp = None      # the model axis's place (parallel/sharding.py)

    @property
    def heads(self) -> tuple[int, int]:
        """(query heads, kv heads) this process computes: all of them, or
        its share on the model axis."""
        n = 1 if self.tp is None else self.tp.size
        return self.cfg.num_heads // n, self.cfg.num_kv_heads // n

    def forward(self, x, rope, cache=None, segment_ids=None, lora=None):
        """`rope`: `rope_tables` of the positions. Without a cache
        (training, prefill): causal attention over the fresh kv
        (block-diagonal within equal `segment_ids` `[B, T]` for packed
        rows), returning `(out, (k, v))` with k/v `[B, KVH, T, hd]`. With a
        contiguous or paged cache (see the module docstring): `(out,
        None)`, the cache updated in place. `lora`: a layer's serving
        adapters (`apply_lora_delta`) on wq, wk, wv and wo.

        On the model axis the layer computes its share of the heads (kv
        heads too, so caches hold `KVH / n_model` heads). Under a ring
        (ops/ring_attention.ring_context) `x` is this process's block of
        the sequence and training attention runs over the ring; packed
        rows gather the sequence and take K1's packed path."""
        cfg = self.cfg
        b, t, _ = x.shape
        hd = cfg.head_dim
        dt = DTYPES[cfg.dtype]
        nh, nkv = self.heads
        if self.tp is not None:
            from ..parallel.sharding import tp_region_enter

            x = tp_region_enter(x, self.tp.group)
        q = self.wq(x, apply_lora_delta(x, lora, "wq", dt))
        k = self.wk(x, apply_lora_delta(x, lora, "wk", dt))
        v = self.wv(x, apply_lora_delta(x, lora, "wv", dt))
        q = q.view(b, t, nh, hd).transpose(1, 2)
        k = k.view(b, t, nkv, hd).transpose(1, 2)
        v = v.view(b, t, nkv, hd).transpose(1, 2)
        q, k = rotate(q, rope), rotate(k, rope)
        kv = None
        ring = active_ring_mesh() if cache is None else None
        if ring is not None:
            if segment_ids is None:
                out = ring_attention(q, k, v, ring)
            else:
                out = seq_gathered_packed_attention(q, k, v, segment_ids,
                                                    ring)
            kv = (k, v)
        elif cache is None:
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
        out = out.transpose(1, 2).reshape(b, t, nh * hd)
        return self.wo(out, apply_lora_delta(out, lora, "wo", dt)), kv


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


def init_cache(cfg: LLMConfig, batch: int, max_len: int, device=None,
               kv_heads: int | None = None):
    """An empty contiguous kv cache, one dict a layer: k/v `[batch, KVH,
    max_len, hd]` in the config dtype (zeros) and index 0; `kv_heads` the
    heads a process holds on the model axis (`DecoderLM.kv_heads`), all of
    them by default."""
    dtype = DTYPES[cfg.dtype]
    shape = (batch, kv_heads or cfg.num_kv_heads, max_len, cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device),
             "index": 0} for _ in range(cfg.num_layers)]


class MLP(nn.Module):
    def __init__(self, cfg: LLMConfig, device=None):
        super().__init__()
        self.cfg = cfg
        kw = {"bias": False, "device": device, "dtype": DTYPES[cfg.dtype]}
        self.gate = Linear(cfg.hidden_size, cfg.ffn_size, **kw)
        self.up = Linear(cfg.hidden_size, cfg.ffn_size, **kw)
        self.down = Linear(cfg.ffn_size, cfg.hidden_size, **kw)
        self.tp = None      # the model axis's place (parallel/sharding.py)

    def forward(self, x, lora=None):
        dt = DTYPES[self.cfg.dtype]
        if self.tp is not None:
            from ..parallel.sharding import tp_region_enter

            x = tp_region_enter(x, self.tp.group)
        gate = self.gate(x, apply_lora_delta(x, lora, "gate", dt))
        up = self.up(x, apply_lora_delta(x, lora, "up", dt))
        h = F.silu(gate) * up
        return self.down(h, apply_lora_delta(h, lora, "down", dt))


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
                inference: bool = False, lora=None):
        """-> `(x, kv, aux)`: aux is the MoE load-balance statistic (None
        for a dense FFN). Pads (segment id 0) take no expert capacity and
        leave the statistic; `inference` marks prefill and decode; `lora`
        is the layer's serving adapters."""
        attn_out, kv = self.attn(self.attn_norm(x), rope, cache, segment_ids,
                                 lora)
        x = x + attn_out
        h = self.mlp_norm(x)
        if hasattr(self, "moe"):
            valid = None if segment_ids is None else segment_ids != 0
            out, aux = self.moe(h, valid=valid, inference=inference,
                                lora=lora)
            return x + out, kv, aux
        return x + self.mlp(h, lora), kv, None


class DecoderLM(nn.Module):
    """Embeddings-in / logits-out decoder; `embed` is applied by the
    caller (the MLLM splices vision features into the embeddings)."""

    def __init__(self, cfg: LLMConfig, device=None):
        super().__init__()
        check_remat_policy(cfg)
        self.cfg = cfg
        dtype = DTYPES[cfg.dtype]
        self.embed = Embedding(cfg.vocab_size, cfg.hidden_size,
                               device=device, dtype=dtype)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, device) for _ in range(cfg.num_layers))
        self.final_norm = RMSNorm(cfg.hidden_size, cfg.norm_eps, device)
        self.lm_head = Linear(cfg.hidden_size, cfg.vocab_size, bias=False,
                              device=device, dtype=dtype)
        self.tp = None      # the model axis's place (parallel/sharding.py)

    @property
    def kv_heads(self) -> int:
        """The kv heads a layer's cache holds in this process."""
        return self.layers[0].attn.heads[1] if len(self.layers) else \
            self.cfg.num_kv_heads

    def forward(self, input_embeds, positions, caches=None, segment_ids=None,
                inference: bool = False, with_aux: bool = False, lora=None,
                vocab_shard: bool = False):
        """`caches`: None, or one contiguous or paged cache dict per layer
        (see the module docstring); `segment_ids` `[B, T]` for packed
        rows (with per-segment `positions`); `inference` True for prefill
        and decode (the MoE's inference routing), False for training;
        `lora` a multi-adapter serving bundle (parallel/lora_serving.py's
        tables with a per-row `idx`); `vocab_shard` keeps a
        tensor-parallel process's logits to its vocab shard (for
        `cross_entropy_sum(tp=...)`). Returns `(logits, kv rows per
        layer)`, and with `with_aux` also the per-layer MoE statistics
        (None for dense layers)."""
        x = input_embeds
        rope = rope_tables(positions, self.cfg.head_dim, self.cfg.rope_theta)
        remat = self.cfg.remat and caches is None and torch.is_grad_enabled()
        kvs, auxes = [], []
        for i, layer in enumerate(self.layers):
            layer_lora = None
            if lora is not None and lora["layers"][i]:
                layer_lora = {"scale": lora["scale"], "idx": lora["idx"],
                              "tables": lora["layers"][i]}
            if remat:
                x, kv, aux = remat_layer(layer, self.cfg, x, rope, None,
                                         segment_ids, inference, layer_lora)
            else:
                x, kv, aux = layer(x, rope,
                                   None if caches is None else caches[i],
                                   segment_ids, inference, layer_lora)
            kvs.append(kv)
            auxes.append(aux)
        h = self.final_norm(x)
        if self.tp is None:
            logits = self.lm_head(h)
        else:       # the vocab shard's logits, gathered unless asked
            from ..parallel.sharding import gather_last, tp_region_enter

            logits = self.lm_head(tp_region_enter(h, self.tp.group))
            if not vocab_shard:
                logits = gather_last(logits, self.tp.group)
        return (logits, kvs, auxes) if with_aux else (logits, kvs)


def cross_entropy_sum(logits, labels, ignore_index: int = -100, tp=None):
    """Masked next-token loss, unnormalised: `(nll_sum, token_count)` with
    the log-softmax in float32. Summing these over microbatches and dividing
    once makes gradient accumulation equal to the single-batch mean. With
    the model axis's place `tp`, `logits` are this process's vocab shard
    (`vocab_shard=True`) and the loss is the vocab-parallel one
    (parallel/sharding.vocab_parallel_nll): no process gathers the
    logits."""
    mask = labels != ignore_index
    safe = torch.where(mask, labels, torch.zeros_like(labels)).long()
    if tp is not None:
        from ..parallel.sharding import vocab_parallel_nll

        nll = vocab_parallel_nll(logits, safe, tp)
    else:
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    return (nll * mask).sum(), mask.sum()


def cross_entropy_loss(logits, labels, ignore_index: int = -100):
    """Masked next-token loss; `labels` are already shifted by the caller."""
    nll_sum, count = cross_entropy_sum(logits, labels, ignore_index)
    return nll_sum / count.clamp_min(1)
