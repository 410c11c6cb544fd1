"""A configuration file -> the program's `MLLMConfig`, and the weights.

The weights are the benchmark's input: `weight_spec` lists every tensor
of the model (the program's parameter names, shapes and how each is
drawn) from the configuration alone, and `draw_weights` makes them on
the device from the seed in chunks of `CHUNK` values. The program and the
reference each call it and get the same bits.
"""

from __future__ import annotations

import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
CHUNK = 1 << 28                 # values drawn by one generator call


def load_config(name: str) -> dict:
    with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
        return json.load(f)


def dims(cfg: dict) -> dict:
    """The sizes every part of the benchmark reads, from the file."""
    v, lm = cfg["vision_config"], cfg["llm_config"]
    grid = v["image_size"] // v["patch_size"]
    shuffle = round(1 / cfg["downsample_ratio"])
    return {
        "image": v["image_size"], "patch": v["patch_size"], "grid": grid,
        "v_hidden": v["hidden_size"], "v_ffn": v["intermediate_size"],
        "v_layers": v["num_hidden_layers"], "v_heads": v["num_attention_heads"],
        "v_eps": v["layer_norm_eps"], "shuffle": shuffle,
        "tokens_per_tile": grid * grid // shuffle ** 2,
        "hidden": lm["hidden_size"], "ffn": lm["intermediate_size"],
        "layers": lm["num_hidden_layers"], "heads": lm["num_attention_heads"],
        "kv_heads": lm["num_key_value_heads"], "vocab": lm["vocab_size"],
        "theta": float(lm["rope_theta"]), "eps": lm["rms_norm_eps"],
        "head_dim": lm["hidden_size"] // lm["num_attention_heads"],
        "max_tiles": cfg["max_dynamic_patch"],
    }


def mllm_config(cfg: dict, mode: str, img_context_id: int):
    """The program's MLLMConfig for `mode` "train" (the file's remat) or
    "serve"."""
    from multi_spatialmllm_tpu_torch.models.llm import LLMConfig
    from multi_spatialmllm_tpu_torch.models.mllm import MLLMConfig
    from multi_spatialmllm_tpu_torch.models.vit import ViTConfig

    d = dims(cfg)
    run = cfg[mode]
    remat = run.get("remat") == "whole_layer"
    dtype = run.get("compute_dtype", run["param_dtype"])
    vit = ViTConfig(image_size=d["image"], patch_size=d["patch"],
                    hidden_size=d["v_hidden"], num_layers=d["v_layers"],
                    num_heads=d["v_heads"],
                    mlp_ratio=d["v_ffn"] / d["v_hidden"], norm_eps=d["v_eps"],
                    dtype=dtype, remat=remat)
    llm = LLMConfig(vocab_size=d["vocab"], hidden_size=d["hidden"],
                    num_layers=d["layers"], num_heads=d["heads"],
                    num_kv_heads=d["kv_heads"], ffn_size=d["ffn"],
                    rope_theta=d["theta"], norm_eps=d["eps"],
                    max_seq_len=cfg["llm_config"]["max_position_embeddings"],
                    dtype=dtype, remat=remat)
    return MLLMConfig(vit=vit, llm=llm, img_context_id=img_context_id,
                      downsample=d["shuffle"])


def weight_spec(cfg: dict) -> list[tuple[str, tuple, str, float]]:
    """`(name, shape, kind, std)` of every tensor, in draw order; kind is
    "normal" (std), "one" (1 + normal(std)) or "zero"."""
    d = dims(cfg)
    dv, dl = d["v_hidden"], d["hidden"]
    hd = d["head_dim"]
    p = d["patch"]
    spec = [("vision.patch_embed.weight", (dv, 3, p, p), "normal",
             (3 * p * p) ** -0.5),
            ("vision.patch_embed.bias", (dv,), "normal", 0.02),
            ("vision.cls_token", (1, 1, dv), "normal", 0.02),
            ("vision.pos_embed", (1, 1 + d["grid"] ** 2, dv), "normal", 0.02)]
    for i in range(d["v_layers"]):
        b = f"vision.blocks.{i}."
        spec += [(b + "norm1.weight", (dv,), "one", 0.02),
                 (b + "norm1.bias", (dv,), "normal", 0.02),
                 (b + "qkv.weight", (3 * dv, dv), "normal", dv ** -0.5),
                 (b + "qkv.bias", (3 * dv,), "normal", 0.02),
                 (b + "proj.weight", (dv, dv), "normal", dv ** -0.5),
                 (b + "proj.bias", (dv,), "normal", 0.02),
                 (b + "norm2.weight", (dv,), "one", 0.02),
                 (b + "norm2.bias", (dv,), "normal", 0.02),
                 (b + "fc1.weight", (d["v_ffn"], dv), "normal", dv ** -0.5),
                 (b + "fc1.bias", (d["v_ffn"],), "normal", 0.02),
                 (b + "fc2.weight", (dv, d["v_ffn"]), "normal",
                  d["v_ffn"] ** -0.5),
                 (b + "fc2.bias", (dv,), "normal", 0.02)]
    din = dv * d["shuffle"] ** 2
    spec += [("projector.norm.weight", (din,), "one", 0.02),
             ("projector.norm.bias", (din,), "normal", 0.02),
             ("projector.fc1.weight", (dl, din), "normal", din ** -0.5),
             ("projector.fc1.bias", (dl,), "normal", 0.02),
             ("projector.fc2.weight", (dl, dl), "normal", dl ** -0.5),
             ("projector.fc2.bias", (dl,), "normal", 0.02),
             ("llm.embed.weight", (d["vocab"], dl), "normal", 0.02)]
    for i in range(d["layers"]):
        b = f"llm.layers.{i}."
        spec += [(b + "attn_norm.weight", (dl,), "one", 0.02),
                 (b + "attn.wq.weight", (d["heads"] * hd, dl), "normal",
                  dl ** -0.5),
                 (b + "attn.wk.weight", (d["kv_heads"] * hd, dl), "normal",
                  dl ** -0.5),
                 (b + "attn.wv.weight", (d["kv_heads"] * hd, dl), "normal",
                  dl ** -0.5),
                 (b + "attn.wo.weight", (dl, d["heads"] * hd), "normal",
                  (d["heads"] * hd) ** -0.5),
                 (b + "mlp_norm.weight", (dl,), "one", 0.02),
                 (b + "mlp.gate.weight", (d["ffn"], dl), "normal", dl ** -0.5),
                 (b + "mlp.up.weight", (d["ffn"], dl), "normal", dl ** -0.5),
                 (b + "mlp.down.weight", (dl, d["ffn"]), "normal",
                  d["ffn"] ** -0.5)]
    spec += [("llm.final_norm.weight", (dl,), "one", 0.02),
             ("llm.lm_head.weight", (d["vocab"], dl), "normal", dl ** -0.5)]
    return spec


def draw_weights(spec, seed: int, device, dtype, sink=None) -> dict:
    """The tensors of `spec` in `dtype` on `device` from `seed`: standard
    normals drawn in float32 by one card generator, `CHUNK` values a call,
    laid end to end over the tensors in spec order, then scaled. `sink(name,
    tensor)` receives each tensor as it is made (the caller copies it into
    place); without it the dict of tensors is returned."""
    import torch

    gen = torch.Generator(device=device).manual_seed(int(seed))
    out = {}
    buf, at = None, CHUNK
    for name, shape, kind, std in spec:
        n = 1
        for s in shape:
            n *= s
        parts, need = [], n
        while need:
            if at == CHUNK:
                buf = torch.randn(CHUNK, generator=gen, device=device,
                                  dtype=torch.float32)
                at = 0
            take = min(need, CHUNK - at)
            parts.append(buf[at:at + take])
            at += take
            need -= take
        flat = parts[0] if len(parts) == 1 else torch.cat(parts)
        if kind == "zero":
            t = torch.zeros(shape, device=device, dtype=dtype)
        elif kind == "one":
            t = (1.0 + std * flat).view(shape).to(dtype)
        else:
            t = (std * flat).view(shape).to(dtype)
        if sink is None:
            out[name] = t
        else:
            sink(name, t)
    return out


def load_into(model, cfg: dict, seed: int) -> None:
    """Draw the weights straight into the program's parameters."""
    import torch

    params = dict(model.named_parameters())
    spec = weight_spec(cfg)
    if set(params) != {s[0] for s in spec}:
        raise ValueError(f"the program's parameters differ from the spec: "
                         f"{sorted(set(params) ^ {s[0] for s in spec})[:6]}")
    dev = next(iter(params.values())).device

    def sink(name, t):
        with torch.no_grad():
            params[name].copy_(t)

    draw_weights(spec, seed, dev, torch.float32, sink)
