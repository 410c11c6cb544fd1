"""Required operations and bytes, from shapes alone.

Copied from `multi_spatialmllm_tpu_torch/utils/flops.py` and corrected:

* the count is of what the inputs require: real tiles only (not the pad
  tiles a packed row carries), each packed segment's causal pairs
  (S(S+1)/2 a segment, not a row), the ViT's 1 + grid^2 tokens;
* training counts 3x the forward for weights that train, 2x for frozen
  weights that a gradient passes through, and 1x for a tower that no
  gradient enters (the original charged 3x to every weight);
* recomputation (remat) and elementwise work are not counted.

A matmul of m x n x k counts 2mnk. `d` is `model.dims(cfg)`.
"""

from __future__ import annotations

# dense bf16 matmul peak and HBM bandwidth of one card, by
# `torch.cuda.get_device_name` (NVIDIA's H100 SXM data sheet, without
# sparsity, at its 700 W limit)
PEAKS = {"NVIDIA H100 80GB HBM3": {"bf16_flops": 989.4e12,
                                    "hbm_bytes": 3.35e12}}


def llm_weight_params(d: dict) -> int:
    """Weights each token's matmuls touch: the layers and the lm_head
    (the embedding is a lookup)."""
    h, hd = d["hidden"], d["head_dim"]
    attn = h * d["heads"] * hd * 2 + 2 * h * d["kv_heads"] * hd
    return d["layers"] * (attn + 3 * h * d["ffn"]) + h * d["vocab"]


def llm_attn_flops(d: dict, pairs: int) -> int:
    """QK^T and PV over `pairs` (query, key) pairs, every layer."""
    return d["layers"] * 4 * d["heads"] * d["head_dim"] * pairs


def causal_pairs(lengths) -> int:
    return sum(n * (n + 1) // 2 for n in lengths)


def vit_tokens(d: dict) -> int:
    return 1 + d["grid"] ** 2


def vit_weight_flops(d: dict, n_tiles: int) -> int:
    dv = d["v_hidden"]
    per_layer = 4 * dv * dv + 2 * dv * d["v_ffn"]
    t = n_tiles * vit_tokens(d)
    patch = 2 * t * 3 * d["patch"] ** 2 * dv
    return 2 * t * d["v_layers"] * per_layer + patch


def vit_attn_flops(d: dict, n_tiles: int) -> int:
    """Bidirectional attention over 1 + grid^2 tokens a tile."""
    return (d["v_layers"] * 4 * d["v_hidden"] * n_tiles
            * vit_tokens(d) ** 2)


def projector_flops(d: dict, n_tiles: int) -> int:
    din = d["v_hidden"] * d["shuffle"] ** 2
    return (2 * n_tiles * d["tokens_per_tile"]
            * (din * d["hidden"] + d["hidden"] ** 2))


def forward_flops(d: dict, segment_lengths, n_tiles: int) -> dict:
    """Forward FLOPs by part for packed segments and their real tiles."""
    return {"vision": vit_weight_flops(d, n_tiles) + vit_attn_flops(d, n_tiles),
            "projector": projector_flops(d, n_tiles),
            "llm": (2 * sum(segment_lengths) * llm_weight_params(d)
                    + llm_attn_flops(d, causal_pairs(segment_lengths)))}


ORDER = ("vision", "projector", "llm")   # the order a gradient flows back


def train_flops(d: dict, segment_lengths, n_tiles: int,
                trained=ORDER) -> int:
    """Required FLOPs of one training step: 3x forward for a part that
    trains, 2x for a frozen part that a gradient passes through (some part
    before it trains), 1x for a part no gradient enters."""
    fwd = forward_flops(d, segment_lengths, n_tiles)
    total = 0
    for i, part in enumerate(ORDER):
        if part in trained:
            mult = 3
        elif any(p in trained for p in ORDER[:i]):
            mult = 2
        else:
            mult = 1
        total += mult * fwd[part]
    return total


def train_attn_flops(d: dict, segment_lengths, n_tiles: int) -> int:
    """Required attention FLOPs of a training step (forward and the two
    backward products each), both towers."""
    return 3 * (llm_attn_flops(d, causal_pairs(segment_lengths))
                + vit_attn_flops(d, n_tiles))


def prefill_flops(d: dict, prompt_len: int, n_tiles: int) -> int:
    return sum(forward_flops(d, [prompt_len], n_tiles).values())


def prefill_attn_flops(d: dict, prompt_len: int, n_tiles: int) -> int:
    return (llm_attn_flops(d, causal_pairs([prompt_len]))
            + vit_attn_flops(d, n_tiles))


def decode_flops(d: dict, position: int) -> int:
    """One generated token whose query sits at `position` (it attends to
    position + 1 keys)."""
    return 2 * llm_weight_params(d) + llm_attn_flops(d, position + 1)


def decode_kv_bytes(d: dict, position: int, kv_bytes: int = 2) -> int:
    """Bytes one paged-attention step of one slot needs, every layer: the
    cached k and v rows of positions 0..position-1 read, the new k and v
    row read and written to the pool, the query in and the output out."""
    row = 2 * d["kv_heads"] * d["head_dim"] * kv_bytes
    qo = 2 * d["heads"] * d["head_dim"] * 2
    return d["layers"] * ((position + 2) * row + qo)
