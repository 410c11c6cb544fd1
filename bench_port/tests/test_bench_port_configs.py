"""Every configuration file builds the program's model at its published
widths, and BENCHMARK.json, the cells and the metric readers agree."""

import json
import os

import pytest

from bench_port import harness, model

PUBLISHED = {
    # InternViT-300M-448px + internlm2-chat-1_8b
    "internvl2_2b": {"image": 448, "patch": 14, "v_hidden": 1024,
                     "v_ffn": 4096, "v_layers": 24, "v_heads": 16,
                     "tokens_per_tile": 256, "hidden": 2048, "ffn": 8192,
                     "layers": 24, "heads": 16, "kv_heads": 8,
                     "head_dim": 128, "vocab": 92553, "theta": 1e6},
    # InternViT-300M-448px + internlm2_5-7b-chat
    "internvl2_8b": {"image": 448, "patch": 14, "v_hidden": 1024,
                     "v_ffn": 4096, "v_layers": 24, "v_heads": 16,
                     "tokens_per_tile": 256, "hidden": 4096, "ffn": 14336,
                     "layers": 32, "heads": 32, "kv_heads": 8,
                     "head_dim": 128, "vocab": 92553, "theta": 1e6},
}
PARAMS = {"internvl2_2b": (2.20e9, 2.22e9), "internvl2_8b": (8.07e9, 8.09e9)}


@pytest.mark.parametrize("name", sorted(PUBLISHED))
def test_config_builds_the_published_widths(name):
    import torch

    from multi_spatialmllm_tpu_torch.models.mllm import MultiFrameMLLM

    cfg = model.load_config(name)
    d = model.dims(cfg)
    assert {k: d[k] for k in PUBLISHED[name]} == PUBLISHED[name]
    assert cfg["reduced"] == ["max_dynamic_patch"]
    assert d["max_tiles"] == 6
    mode = "train" if "train" in cfg else "serve"
    m = model.mllm_config(cfg, mode, img_context_id=3)
    assert (m.vit.hidden_size, m.vit.num_layers, m.llm.hidden_size,
            m.llm.num_layers, m.llm.head_dim, m.tokens_per_tile) == (
        d["v_hidden"], d["v_layers"], d["hidden"], d["layers"], 128, 256)
    assert m.vit.hidden_size * m.vit.mlp_ratio == d["v_ffn"]
    net = MultiFrameMLLM(m, device=torch.device("meta"))
    got = {n: tuple(p.shape) for n, p in net.named_parameters()}
    spec = {n: s for n, s, _, _ in model.weight_spec(cfg)}
    assert got == spec
    n = sum(p.numel() for p in net.parameters())
    assert PARAMS[name][0] < n < PARAMS[name][1]


def test_benchmark_json_cells_and_readers_agree():
    bench = harness.benchmark()
    names = {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        assert os.path.isfile(os.path.join(harness.ROOT, c["file"]))
        assert model.load_config(c["name"])["source"] == c["source"]
    for w in bench["workloads"]:
        spec = harness.load_json(harness.HERE, "workloads",
                                 f"{w['name']}.json")
        assert spec["config"] == w["config"] and w["config"] in names
        assert spec["chips"] == w["chips"] and spec["why"] == w["why"]
        assert os.path.isfile(os.path.join(harness.HERE, "traffic",
                                           f"{spec['driver']}.py"))
        e2e, layer = harness.cell_metrics(bench, w["name"])
        assert "setup_s" in e2e and len(e2e) >= 2 and layer
    for m in bench["per_layer"]:
        assert callable(harness.load_module("metrics", m["name"]).read)
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
    assert json.dumps(bench).isascii()
