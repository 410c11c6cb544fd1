"""Analytic model-FLOPs accounting for MFU reporting.

MFU = (model FLOPs the step REQUIRES) / (wall time x hardware peak).
Model FLOPs follow the standard convention (PaLM appendix B style):

* every matmul counts 2*m*n*k (multiply + add);
* training = 3x the forward matmul FLOPs (backward does ~2x: dX and dW);
* causal attention counts the VISIBLE half of the score/probability
  matmuls only;
* rematerialization's recompute FLOPs are NOT counted (they are not
  required by the model — counting them would inflate MFU), nor are
  elementwise/softmax/norm ops (HBM-bound, negligible FLOPs).

The reference's training is delegated to InternVL-2 + DeepSpeed on GPUs
(the reference's README); these numbers are how the port's
train step (parallel/train.py) on an NVIDIA GPU is compared against that
baseline and against hardware peak.
"""

from __future__ import annotations

from ..models.llm import LLMConfig
from ..models.mllm import MLLMConfig
from ..models.vit import ViTConfig

# dense bf16 peak matmul FLOP/s per card by `torch.cuda.get_device_name`
# (NVIDIA's H100 SXM data sheet, without sparsity, at its 700 W limit)
PEAK_BF16 = {
    "NVIDIA H100 80GB HBM3": 989.4e12,
}


def device_peak_flops(device) -> float | None:
    """Per-card bf16 peak for a torch device, or None for the CPU and for a
    card not in PEAK_BF16."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return None
    return PEAK_BF16.get(torch.cuda.get_device_name(device))


def llm_matmul_params(cfg: LLMConfig) -> int:
    """Weights each token's matmuls touch (embedding lookup excluded,
    lm_head included).

    MoE (cfg.moe_experts > 0): a token runs `moe_top_k` expert MLPs plus
    the router, NOT all E experts — MoE MFU counts activated-expert
    FLOPs only (the Switch/GShard convention). The dense dispatch/
    combine einsums the implementation uses are an implementation
    choice (a gather/scatter would avoid them), so their FLOPs are not
    "required by the model" and are excluded — MoE MFU is therefore an
    honest lower bound on hardware utilisation."""
    h, hd = cfg.hidden_size, cfg.head_dim
    attn = (h * cfg.num_heads * hd            # wq
            + 2 * h * cfg.num_kv_heads * hd   # wk, wv
            + cfg.num_heads * hd * h)         # wo
    ffn = 3 * h * cfg.ffn_size                # gate, up, down
    if cfg.moe_experts > 0:
        ffn = cfg.moe_top_k * ffn + h * cfg.moe_experts  # experts + router
    return cfg.num_layers * (attn + ffn) + h * cfg.vocab_size


def llm_fwd_flops(cfg: LLMConfig, batch: int, seq: int) -> int:
    """Forward matmul FLOPs for a [batch, seq] causal pass."""
    tokens = batch * seq
    weight_flops = 2 * tokens * llm_matmul_params(cfg)
    # qk^T and pv: 2 * H * hd * (visible pairs) each, per layer;
    # causal visible pairs = S*(S+1)/2 per sequence
    visible = batch * seq * (seq + 1) // 2
    attn_flops = cfg.num_layers * 4 * cfg.num_heads * cfg.head_dim * visible
    return weight_flops + attn_flops


def vit_fwd_flops(cfg: ViTConfig, n_tiles: int) -> int:
    """Forward matmul FLOPs for encoding `n_tiles` tiles."""
    h = cfg.hidden_size
    t = 1 + cfg.num_patches                   # cls + patch tokens
    per_layer_params = (3 * h * h             # qkv
                        + h * h               # proj
                        + 2 * h * int(h * cfg.mlp_ratio))  # fc1, fc2
    tokens = n_tiles * t
    weight_flops = 2 * tokens * cfg.num_layers * per_layer_params
    # bidirectional attention: full t^2 pairs
    attn_flops = cfg.num_layers * 4 * cfg.num_heads * \
        (h // cfg.num_heads) * n_tiles * t * t
    patch_flops = 2 * tokens * (cfg.patch_size ** 2 * 3) * h
    return weight_flops + attn_flops + patch_flops


def mllm_fwd_flops(cfg: MLLMConfig, batch: int, seq: int,
                   n_tiles: int) -> int:
    """Forward matmul FLOPs for one MLLM training forward:
    `batch` rows of `seq` tokens with `n_tiles` image tiles per row."""
    total_tiles = batch * n_tiles
    vis_tokens = total_tiles * cfg.tokens_per_tile
    d_in = cfg.vit.hidden_size * cfg.downsample ** 2
    proj = 2 * vis_tokens * (d_in * cfg.llm.hidden_size
                             + cfg.llm.hidden_size ** 2)
    return (vit_fwd_flops(cfg.vit, total_tiles) + proj
            + llm_fwd_flops(cfg.llm, batch, seq))


def mllm_train_flops(cfg: MLLMConfig, batch: int, seq: int,
                     n_tiles: int) -> int:
    """Model FLOPs for one full train step (fwd + bwd = 3x fwd)."""
    return 3 * mllm_fwd_flops(cfg, batch, seq, n_tiles)
