"""JAX/Flax parameter tree -> the port's `state_dict`.

The tree is the one `MultiFrameMLLM.init` returns in the JAX package
(`{"params": {"vision": ..., "projector": ..., "llm": ...}}` or its inner
dict), given as nested dicts of numpy arrays. Layouts:

* Flax `Dense` kernel `[in, out]` -> torch `Linear.weight` `[out, in]`.
* `DenseGeneral`: `wq`/`wk`/`wv` `[D, H, hd]` -> `[H*hd, D]`; `wo`
  `[H, hd, D]` -> `[D, H*hd]`; the ViT's `qkv` `[D, 3, H, hd]` (bias
  `[3, H, hd]`) -> `[3*H*hd, D]`, output order (3, H, hd); `proj`
  `[H, hd, D]` -> `[D, H*hd]`.
* `Conv` kernel HWIO (applied to NHWC tiles) -> OIHW.
* `Embed.embedding` `[V, D]` as is; LayerNorm/RMSNorm `scale` -> `weight`.
* MoE layers (`llm/layer_{i}/moe/{router, wi_gate, wi_up, wo}`, plain
  params with no `kernel` level) as they are: the port keeps the JAX
  layouts `[D, E]`, `[E, D, F]`, `[E, F, D]`.

Values stay float32; `load_state_dict` casts them to each parameter's
dtype (the same rounding as Flax's cast at compute time).
"""

from __future__ import annotations

import numpy as np
import torch

from .mllm import MLLMConfig


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a))


def _dense(p: dict) -> dict:
    """`[in, ...] -> [..., in]`: Dense and the input side of DenseGeneral."""
    k = np.asarray(p["kernel"])
    out = {"weight": _t(k.reshape(k.shape[0], -1).T)}
    if "bias" in p:
        out["bias"] = _t(np.asarray(p["bias"]).reshape(-1))
    return out


def _dense_in2(p: dict) -> dict:
    """DenseGeneral contracting two leading axes: `[H, hd, D] -> [D, H*hd]`."""
    k = np.asarray(p["kernel"])
    out = {"weight": _t(k.reshape(-1, k.shape[-1]).T)}
    if "bias" in p:
        out["bias"] = _t(p["bias"])
    return out


def _norm(p: dict) -> dict:
    out = {"weight": _t(p["scale"])}
    if "bias" in p:
        out["bias"] = _t(p["bias"])
    return out


def _put(sd: dict, prefix: str, entries: dict) -> None:
    for k, v in entries.items():
        sd[f"{prefix}.{k}"] = v


def jax_params_to_state_dict(params: dict, cfg: MLLMConfig) -> dict:
    """Map a Flax MultiFrameMLLM param tree onto `MultiFrameMLLM`'s
    parameter names (see the module docstring for the layouts)."""
    p = params.get("params", params)
    sd: dict[str, torch.Tensor] = {}

    vis = p["vision"]
    conv = np.asarray(vis["patch_embed"]["kernel"])          # HWIO
    sd["vision.patch_embed.weight"] = _t(conv.transpose(3, 2, 0, 1))
    sd["vision.patch_embed.bias"] = _t(vis["patch_embed"]["bias"])
    sd["vision.cls_token"] = _t(vis["cls_token"])
    sd["vision.pos_embed"] = _t(vis["pos_embed"])
    for i in range(cfg.vit.num_layers):
        blk, pre = vis[f"block_{i}"], f"vision.blocks.{i}"
        _put(sd, f"{pre}.norm1", _norm(blk["norm1"]))
        _put(sd, f"{pre}.qkv", _dense(blk["qkv"]))
        _put(sd, f"{pre}.proj", _dense_in2(blk["proj"]))
        _put(sd, f"{pre}.norm2", _norm(blk["norm2"]))
        _put(sd, f"{pre}.fc1", _dense(blk["fc1"]))
        _put(sd, f"{pre}.fc2", _dense(blk["fc2"]))

    proj = p["projector"]
    _put(sd, "projector.norm", _norm(proj["norm"]))
    _put(sd, "projector.fc1", _dense(proj["fc1"]))
    _put(sd, "projector.fc2", _dense(proj["fc2"]))

    llm = p["llm"]
    sd["llm.embed.weight"] = _t(llm["embed"]["embedding"])
    for i in range(cfg.llm.num_layers):
        lay, pre = llm[f"layer_{i}"], f"llm.layers.{i}"
        _put(sd, f"{pre}.attn_norm", _norm(lay["attn_norm"]))
        for name in ("wq", "wk", "wv"):
            _put(sd, f"{pre}.attn.{name}", _dense(lay["attn"][name]))
        _put(sd, f"{pre}.attn.wo", _dense_in2(lay["attn"]["wo"]))
        _put(sd, f"{pre}.mlp_norm", _norm(lay["mlp_norm"]))
        if "moe" in lay:
            _put(sd, f"{pre}.moe", {k: _t(lay["moe"][k]) for k in
                                    ("router", "wi_gate", "wi_up", "wo")})
        else:
            for name in ("gate", "up", "down"):
                _put(sd, f"{pre}.mlp.{name}", _dense(lay["mlp"][name]))
    _put(sd, "llm.final_norm", _norm(llm["final_norm"]))
    _put(sd, "llm.lm_head", _dense(llm["lm_head"]))
    return sd
