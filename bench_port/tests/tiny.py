"""A model of published structure at widths a CPU test holds."""

# a model of published structure at widths a CPU test can hold
TINY = {
    "vision_config": {"image_size": 56, "hidden_size": 64,
                      "intermediate_size": 128, "num_hidden_layers": 2,
                      "num_attention_heads": 4},
    "llm_config": {"hidden_size": 64, "intermediate_size": 128,
                   "num_hidden_layers": 2, "num_attention_heads": 4,
                   "num_key_value_heads": 2, "vocab_size": 1024},
}


def tiny_overrides(cell: str, dtype: str = "float32", **params) -> dict:
    """`run.run_cell` overrides: the tiny model, small runs."""
    from bench_port import model
    from bench_port.harness import HERE, load_json

    spec = load_json(HERE, "workloads", f"{cell}.json")
    base = model.load_config(spec["config"])
    cfg = dict(TINY)
    if spec["driver"] == "sft":
        cfg["train"] = {**base["train"], "compute_dtype": dtype}
        small = {"seq_len": 512, "frame_pool": 4}
    else:
        cfg["serve"] = {**base["serve"], "param_dtype": dtype}
        small = {"frame_pool": 4, "clients": 4, "slots": 2,
                 "max_prompt_len": 512, "check_requests": 3,
                 "warmup_requests": 2}
    return {"config": cfg, "params": {**small, **params}}
