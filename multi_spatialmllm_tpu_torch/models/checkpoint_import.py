"""Pretrained-weight import and export: InternVL-2 HF safetensors <-> the
port's `state_dict` (port of multi_spatialmllm_tpu/models/
checkpoint_import.py).

The reference trains from released InternVL-2 checkpoints (InternVL2-8B =
InternViT-300M-448px + internlm2_chat_7b). This module maps that naming
onto `MultiFrameMLLM`'s parameters. torch `Linear` and HF both store
`[out, in]`, so most tensors carry over as they are; the translations are:

* InternViT's layer scales `ls1`/`ls2` multiply the residual branch
  output; they fold exactly into the following projection (`proj`, `fc2`):
  each row of the weight and each bias element times its scale, one
  rounding in the tensor's dtype, the products the JAX package forms
  (`_t(w) * ls[None, :]`, `b * ls`).
* InternLM2's `attention.wqkv` packs GQA groups interleaved as
  `[kv_head, (rep q heads, k, v), head_dim]` along the output dim; it is
  split into `wq` `[H*hd, D]` and `wk`/`wv` `[KVH*hd, D]`.
* `class_embedding`/`position_embedding` take the `[1, 1(+P), D]` shapes;
  the projector is `mlp1.{0,1,3}`; `language_model.output` is the lm head.

`load_internvl2_checkpoint` streams `.safetensors` shards through
`models/safetensors_io.py`, each tensor cast to the parameter dtype as it
is read (an 8 B checkpoint never exists in float32), on the device asked
for. `export_state_dict` inverts the mapping (layer scales stay folded).
"""

from __future__ import annotations

from typing import Iterable, Mapping

import numpy as np
import torch

from . import safetensors_io
from .llm import LLMConfig
from .mllm import MLLMConfig


def _own(t: torch.Tensor) -> torch.Tensor:
    """`t` in a storage of its own size (a view of a larger tensor, or a
    non-contiguous slice, is copied), so `torch.save` writes its bytes
    alone."""
    t = t.contiguous()
    if t.untyped_storage().nbytes() != t.numel() * t.element_size():
        t = t.clone()
    return t


def _split_wqkv(w: torch.Tensor, cfg: LLMConfig):
    """InternLM2 packed GQA projection `[(rep+2)*KVH*hd, D]` -> (wq
    `[H*hd, D]`, wk `[KVH*hd, D]`, wv `[KVH*hd, D]`)."""
    d, kvh, hd = cfg.hidden_size, cfg.num_kv_heads, cfg.head_dim
    rep = cfg.num_heads // kvh
    g = w.reshape(kvh, rep + 2, hd, d)
    return (g[:, :rep].reshape(-1, d), g[:, rep].reshape(-1, d),
            g[:, rep + 1].reshape(-1, d))


def _pack_wqkv(wq, wk, wv, cfg: LLMConfig) -> torch.Tensor:
    d, kvh, hd = cfg.hidden_size, cfg.num_kv_heads, cfg.head_dim
    rep = cfg.num_heads // kvh
    return torch.cat([wq.reshape(kvh, rep, hd, d), wk.reshape(kvh, 1, hd, d),
                      wv.reshape(kvh, 1, hd, d)], dim=1).reshape(-1, d)


def _scaled(w: torch.Tensor, ls) -> torch.Tensor:
    """Row o of `w` `[out, in]` (or element o of a bias) times `ls[o]`; no
    scale (`ls` None) multiplies by one."""
    if ls is None:
        return w
    return w * (ls[:, None] if w.dim() == 2 else ls)


def convert_state_dict(state: Mapping[str, torch.Tensor], cfg: MLLMConfig,
                       param_dtype: torch.dtype = torch.float32) -> dict:
    """HF InternVL-2 state dict -> `MultiFrameMLLM.state_dict()` names, in
    `param_dtype`. The layer-scale folds run in the dtype of the tensors
    given, then every tensor is cast, as the JAX package converts."""
    vt, lc = cfg.vit, cfg.llm
    d = vt.hidden_size
    sd: dict[str, torch.Tensor] = {}
    pre = "vision_model.embeddings."
    sd["vision.patch_embed.weight"] = state[pre + "patch_embedding.weight"]
    sd["vision.patch_embed.bias"] = state[pre + "patch_embedding.bias"]
    sd["vision.cls_token"] = state[pre + "class_embedding"].reshape(1, 1, d)
    sd["vision.pos_embed"] = state[pre + "position_embedding"].reshape(
        1, 1 + vt.num_patches, d)
    for i in range(vt.num_layers):
        lp, out = f"vision_model.encoder.layers.{i}.", f"vision.blocks.{i}."
        for n in ("norm1", "norm2"):
            sd[out + f"{n}.weight"] = state[lp + f"{n}.weight"]
            sd[out + f"{n}.bias"] = state[lp + f"{n}.bias"]
        sd[out + "qkv.weight"] = state[lp + "attn.qkv.weight"]
        sd[out + "qkv.bias"] = state[lp + "attn.qkv.bias"]
        ls1, ls2 = state.get(lp + "ls1"), state.get(lp + "ls2")
        sd[out + "proj.weight"] = _scaled(state[lp + "attn.proj.weight"], ls1)
        sd[out + "proj.bias"] = _scaled(state[lp + "attn.proj.bias"], ls1)
        sd[out + "fc1.weight"] = state[lp + "mlp.fc1.weight"]
        sd[out + "fc1.bias"] = state[lp + "mlp.fc1.bias"]
        sd[out + "fc2.weight"] = _scaled(state[lp + "mlp.fc2.weight"], ls2)
        sd[out + "fc2.bias"] = _scaled(state[lp + "mlp.fc2.bias"], ls2)
    for n, hf in (("norm", "mlp1.0"), ("fc1", "mlp1.1"), ("fc2", "mlp1.3")):
        sd[f"projector.{n}.weight"] = state[hf + ".weight"]
        sd[f"projector.{n}.bias"] = state[hf + ".bias"]
    sd["llm.embed.weight"] = state[
        "language_model.model.tok_embeddings.weight"]
    for i in range(lc.num_layers):
        lp, out = f"language_model.model.layers.{i}.", f"llm.layers.{i}."
        wq, wk, wv = _split_wqkv(state[lp + "attention.wqkv.weight"], lc)
        sd[out + "attn_norm.weight"] = state[lp + "attention_norm.weight"]
        sd[out + "attn.wq.weight"] = wq
        sd[out + "attn.wk.weight"] = wk
        sd[out + "attn.wv.weight"] = wv
        sd[out + "attn.wo.weight"] = state[lp + "attention.wo.weight"]
        sd[out + "mlp_norm.weight"] = state[lp + "ffn_norm.weight"]
        sd[out + "mlp.gate.weight"] = state[lp + "feed_forward.w1.weight"]
        sd[out + "mlp.up.weight"] = state[lp + "feed_forward.w3.weight"]
        sd[out + "mlp.down.weight"] = state[lp + "feed_forward.w2.weight"]
    sd["llm.final_norm.weight"] = state["language_model.model.norm.weight"]
    sd["llm.lm_head.weight"] = state["language_model.output.weight"]
    return {k: _own(v.to(param_dtype)) for k, v in sd.items()}


def export_state_dict(sd: Mapping[str, torch.Tensor],
                      cfg: MLLMConfig) -> dict:
    """Inverse of `convert_state_dict` (the layer scales come back folded:
    no `ls1`/`ls2`), in the JAX package's `export_state_dict` key order,
    which decides the shard boundaries of an export."""
    vt, lc = cfg.vit, cfg.llm
    state: dict[str, torch.Tensor] = {}
    pre = "vision_model.embeddings."
    state[pre + "class_embedding"] = sd["vision.cls_token"]
    state[pre + "position_embedding"] = sd["vision.pos_embed"]
    state[pre + "patch_embedding.weight"] = sd["vision.patch_embed.weight"]
    state[pre + "patch_embedding.bias"] = sd["vision.patch_embed.bias"]
    for i in range(vt.num_layers):
        lp, src = f"vision_model.encoder.layers.{i}.", f"vision.blocks.{i}."
        for hf, port in (("norm1.weight", "norm1.weight"),
                         ("norm1.bias", "norm1.bias"),
                         ("norm2.weight", "norm2.weight"),
                         ("norm2.bias", "norm2.bias"),
                         ("attn.qkv.weight", "qkv.weight"),
                         ("attn.qkv.bias", "qkv.bias"),
                         ("attn.proj.weight", "proj.weight"),
                         ("attn.proj.bias", "proj.bias"),
                         ("mlp.fc1.weight", "fc1.weight"),
                         ("mlp.fc1.bias", "fc1.bias"),
                         ("mlp.fc2.weight", "fc2.weight"),
                         ("mlp.fc2.bias", "fc2.bias")):
            state[lp + hf] = sd[src + port]
    for hf, port in (("mlp1.0", "norm"), ("mlp1.1", "fc1"), ("mlp1.3", "fc2")):
        state[hf + ".weight"] = sd[f"projector.{port}.weight"]
        state[hf + ".bias"] = sd[f"projector.{port}.bias"]
    state["language_model.model.tok_embeddings.weight"] = sd[
        "llm.embed.weight"]
    for i in range(lc.num_layers):
        lp, src = f"language_model.model.layers.{i}.", f"llm.layers.{i}."
        state[lp + "attention.wqkv.weight"] = _pack_wqkv(
            sd[src + "attn.wq.weight"], sd[src + "attn.wk.weight"],
            sd[src + "attn.wv.weight"], lc)
        state[lp + "attention.wo.weight"] = sd[src + "attn.wo.weight"]
        state[lp + "feed_forward.w1.weight"] = sd[src + "mlp.gate.weight"]
        state[lp + "feed_forward.w3.weight"] = sd[src + "mlp.up.weight"]
        state[lp + "feed_forward.w2.weight"] = sd[src + "mlp.down.weight"]
        state[lp + "attention_norm.weight"] = sd[src + "attn_norm.weight"]
        state[lp + "ffn_norm.weight"] = sd[src + "mlp_norm.weight"]
    state["language_model.model.norm.weight"] = sd["llm.final_norm.weight"]
    state["language_model.output.weight"] = sd["llm.lm_head.weight"]
    return state


def load_internvl2_checkpoint(path_or_paths: str | Iterable[str],
                              cfg: MLLMConfig,
                              param_dtype: torch.dtype = torch.float32,
                              device=None) -> dict:
    """Stream safetensors shard(s) (one file, a list, or a directory of
    `*.safetensors`) into the port's state dict on `device`; each tensor
    is cast to `param_dtype` as it is read."""
    state: dict[str, torch.Tensor] = {}
    for path in safetensors_io.shard_paths(path_or_paths):
        for name, t in safetensors_io.read_tensors(path, param_dtype, device):
            state[name] = t
    return convert_state_dict(state, cfg, param_dtype)


def write_sharded(state: Mapping[str, torch.Tensor], out_dir: str,
                  shard_bytes: int) -> list[str]:
    """HF-style shards of `state` under `out_dir`, filled in insertion
    order up to `shard_bytes` each: `model.safetensors`, or
    `model-0000i-of-0000n.safetensors` and `model.safetensors.index.json`
    (the JAX `export-checkpoint`'s files). Returns the shard names."""
    import json
    import os

    os.makedirs(out_dir, exist_ok=True)
    shards: list[dict] = [{}]
    size = 0
    for k, t in state.items():
        nbytes = t.numel() * t.element_size()
        if size and size + nbytes > shard_bytes:
            shards.append({})
            size = 0
        shards[-1][k] = t
        size += nbytes
    n = len(shards)
    names, weight_map = [], {}
    for i, shard in enumerate(shards, start=1):
        name = "model.safetensors" if n == 1 else \
            f"model-{i:05d}-of-{n:05d}.safetensors"
        safetensors_io.save_file(shard, os.path.join(out_dir, name))
        weight_map.update({k: name for k in shard})
        names.append(name)
    if n > 1:
        with open(os.path.join(out_dir, "model.safetensors.index.json"),
                  "w") as f:
            json.dump({"metadata": {"total_size": sum(
                t.numel() * t.element_size() for t in state.values())},
                "weight_map": weight_map}, f)
    return names


def fixture_spec(cfg: MLLMConfig, with_layer_scale: bool = True) -> list:
    """`(name, shape, offset)` of every tensor of an HF-layout InternVL-2
    state for `cfg`, in the JAX package's `make_fixture_state_dict` order
    (its draw order); `offset` is 1.0 for norm scales and layer scales
    (drawn as 1 + noise), else 0.0."""
    vt, lc = cfg.vit, cfg.llm
    d = vt.hidden_size
    proj_in = vt.hidden_size * cfg.downsample ** 2
    pre = "vision_model.embeddings."
    spec = [
        (pre + "class_embedding", (1, 1, d), 0.0),
        (pre + "position_embedding", (1, 1 + vt.num_patches, d), 0.0),
        (pre + "patch_embedding.weight",
         (d, 3, vt.patch_size, vt.patch_size), 0.0),
        (pre + "patch_embedding.bias", (d,), 0.0),
        ("mlp1.0.weight", (proj_in,), 0.0), ("mlp1.0.bias", (proj_in,), 0.0),
        ("mlp1.1.weight", (lc.hidden_size, proj_in), 0.0),
        ("mlp1.1.bias", (lc.hidden_size,), 0.0),
        ("mlp1.3.weight", (lc.hidden_size, lc.hidden_size), 0.0),
        ("mlp1.3.bias", (lc.hidden_size,), 0.0),
        ("language_model.model.tok_embeddings.weight",
         (lc.vocab_size, lc.hidden_size), 0.0),
        ("language_model.model.norm.weight", (lc.hidden_size,), 1.0),
        ("language_model.output.weight", (lc.vocab_size, lc.hidden_size),
         0.0),
    ]
    mlp_d = int(d * vt.mlp_ratio)
    for i in range(vt.num_layers):
        lp = f"vision_model.encoder.layers.{i}."
        spec += [
            (lp + "norm1.weight", (d,), 1.0), (lp + "norm1.bias", (d,), 0.0),
            (lp + "norm2.weight", (d,), 1.0), (lp + "norm2.bias", (d,), 0.0),
            (lp + "attn.qkv.weight", (3 * d, d), 0.0),
            (lp + "attn.qkv.bias", (3 * d,), 0.0),
            (lp + "attn.proj.weight", (d, d), 0.0),
            (lp + "attn.proj.bias", (d,), 0.0),
            (lp + "mlp.fc1.weight", (mlp_d, d), 0.0),
            (lp + "mlp.fc1.bias", (mlp_d,), 0.0),
            (lp + "mlp.fc2.weight", (d, mlp_d), 0.0),
            (lp + "mlp.fc2.bias", (d,), 0.0)]
        if with_layer_scale:
            spec += [(lp + "ls1", (d,), 1.0), (lp + "ls2", (d,), 1.0)]
    qkv_out = (lc.num_heads // lc.num_kv_heads + 2) * \
        lc.num_kv_heads * lc.head_dim
    h = lc.hidden_size
    for i in range(lc.num_layers):
        lp = f"language_model.model.layers.{i}."
        spec += [
            (lp + "attention.wqkv.weight", (qkv_out, h), 0.0),
            (lp + "attention.wo.weight", (h, lc.num_heads * lc.head_dim),
             0.0),
            (lp + "feed_forward.w1.weight", (lc.ffn_size, h), 0.0),
            (lp + "feed_forward.w3.weight", (lc.ffn_size, h), 0.0),
            (lp + "feed_forward.w2.weight", (h, lc.ffn_size), 0.0),
            (lp + "attention_norm.weight", (h,), 1.0),
            (lp + "ffn_norm.weight", (h,), 1.0)]
    return spec


def make_fixture_state_dict(cfg: MLLMConfig, seed: int = 0,
                            with_layer_scale: bool = True) -> dict:
    """Random HF-layout state dict (numpy float32, the JAX package's
    fixture: the same draws from `np.random.default_rng(seed)`), standing
    in for a real checkpoint download."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape, off in fixture_spec(cfg, with_layer_scale):
        r = rng.standard_normal(shape).astype(np.float32) * 0.02
        out[name] = off + r if off else r
    return out


def random_state_dict(cfg: MLLMConfig, seed: int = 0, device=None,
                      dtype: torch.dtype = torch.bfloat16,
                      with_layer_scale: bool = True) -> dict:
    """An HF-layout state of `fixture_spec`'s tensors drawn on `device`
    from a seeded `torch.Generator` (normal, std 0.02, plus the offsets),
    in `dtype`: a full-size stand-in that never passes through the
    host."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name, shape, off in fixture_spec(cfg, with_layer_scale):
        t = torch.empty(shape, dtype=torch.float32, device=device)
        t.normal_(0.0, 0.02, generator=gen).add_(off)
        out[name] = t.to(dtype)
    return out
