"""The per-layer metrics that read the program's spans
(`multi_spatialmllm_tpu_torch/utils/profiling.py`): a traced run of each
cell reports every one of them as a number in ms, beside the metrics they
split; each BENCHMARK.json entry loads its reader; and against a program
without the span store each reader returns nothing. Tiny model on the
CPU, as the other tests of this folder."""

import pytest

from bench_port import harness, run

from .tiny import tiny_overrides

SPAN_METRICS = {
    "internvl2_2b.sft": [
        "frame_read_ms.train", "frame_tile_ms.train", "vit_ms.train",
        "llm_ms.train", "loss_ms.train", "backward_ms.train",
        "optimizer_ms.train"],
    "internvl2_8b.spatial_qa": [
        "frame_read_ms.serve", "frame_tile_ms.serve",
        "prefill_vit_ms.serve", "decode_launch_ms.serve",
        "decode_read_ms.serve"],
}


@pytest.mark.parametrize("cell", sorted(SPAN_METRICS))
def test_a_traced_run_reports_the_span_metrics(cell):
    from multi_spatialmllm_tpu_torch.utils import profiling

    profiling.reset()                   # one process runs both cells here
    res = run.run_cell(cell, 2 ** 33 + 91, 2.0, True, "cpu",
                       overrides=tiny_overrides(cell, "float32"))
    assert res["correct"], res["checks"]
    got = {n: m["value"] for n, m in res["metrics"].items()}
    for name in SPAN_METRICS[cell]:
        assert res["metrics"][name]["unit"] == "ms"
        assert isinstance(got[name], float) and got[name] > 0, name
    if cell == "internvl2_8b.spatial_qa":
        # both nest inside the dispatch; every request has a frame
        assert (got["decode_launch_ms.serve"] + got["decode_read_ms.serve"]
                <= got["decode_dispatch_ms.serve"])
        assert (got["frame_read_ms.serve"] + got["frame_tile_ms.serve"]
                <= got["window_prep_ms.serve"])


def test_each_entry_loads_its_reader():
    by_name = {m["name"]: m for m in harness.benchmark()["per_layer"]}
    for cell, names in SPAN_METRICS.items():
        for name in names:
            m = by_name[name]
            assert m["workloads"] == [cell] and m["unit"] == "ms"
            assert m["source"] == "program_span" and m["better"] == "lower"
            assert callable(harness.load_module("metrics", name).read)


def test_without_the_span_store_the_readers_read_nothing(monkeypatch):
    from multi_spatialmllm_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "snapshot")
    for names in SPAN_METRICS.values():
        for name in names:
            assert harness.load_module("metrics", name).read(None) is None
