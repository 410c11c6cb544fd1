"""The port's program spans (utils/profiling.py): with no torch.profiler
session a span opens no range, reads no clock and writes nothing; under
one, a train step records its five phases once each as host-only ranges,
the packed feed counts a frame's read and tiling once each from its
producer thread, and the serve loop counts a decode dispatch's launch and
read once each and the ViT once a pass, with the vision cache on or off.
Losses, gradients and served objects are the same bits with the profiler
on and off."""

import dataclasses
import json
import os
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from multi_spatialmllm_tpu_torch import __main__ as cli
from multi_spatialmllm_tpu_torch.ingest.png import imwrite_png
from multi_spatialmllm_tpu_torch.models import data as TD
from multi_spatialmllm_tpu_torch.models import mllm as TM
from multi_spatialmllm_tpu_torch.models import paged_kv as TK
from multi_spatialmllm_tpu_torch.models import preprocess as TP
from multi_spatialmllm_tpu_torch.models.tokenizer import SpatialTokenizer
from multi_spatialmllm_tpu_torch.parallel import train as PT
from multi_spatialmllm_tpu_torch.utils import profiling

TOK = SpatialTokenizer()
STEP_SPANS = ["msm.model.vit", "msm.model.llm", "msm.train.loss",
              "msm.train.backward", "msm.train.optimizer"]


def traced():
    return profile(activities=[ProfilerActivity.CPU])


def counts() -> dict:
    return {k: v["count"] for k, v in profiling.snapshot().items()}


@pytest.fixture(autouse=True)
def empty_store():
    profiling.reset()
    yield
    profiling.reset()


def test_a_span_with_the_profiler_off_does_nothing(monkeypatch):
    class Untouchable:
        def __getattr__(self, name):
            raise AssertionError(f"touched {name}")

        def __call__(self, *a, **k):
            raise AssertionError("called")

    monkeypatch.setattr(profiling, "_Range", Untouchable())
    monkeypatch.setattr(profiling, "time", Untouchable())
    monkeypatch.setattr(profiling, "STORE", Untouchable())
    for device in (False, True):
        with profiling.span("msm.model.vit", device=device):
            pass
    with pytest.raises(ValueError):       # an error passes through
        with profiling.span("msm.image.read"):
            raise ValueError
    monkeypatch.undo()
    assert profiling.snapshot() == {}


def test_the_store_sums_by_name_and_resets():
    with traced():
        for _ in range(3):
            with profiling.span("msm.image.read"):
                pass
        with profiling.span("msm.train.loss", device=True):
            with profiling.span("msm.image.read"):
                pass
    snap = profiling.snapshot()
    assert snap["msm.image.read"]["count"] == 4
    assert "device_s" not in snap["msm.image.read"]
    loss = snap["msm.train.loss"]
    assert loss["count"] == 1
    assert loss["device_s"] == loss["host_s"] >= snap["msm.image.read"][
        "host_s"] / 4           # no CUDA here: device seconds are host's
    profiling.reset()
    assert profiling.snapshot() == {}


def test_threads_lose_no_span():
    """More threads than cores, switching as often as the interpreter
    allows, each adding the same names in the same order (so they race to
    make each name's entry): no count is lost."""
    import sys

    n_threads, n_spans = 2 * (os.cpu_count() or 4), 300

    def work():
        for i in range(n_spans):
            with profiling.span(f"msm.t{i}", device=i % 2 == 0):
                pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with traced():
            threads = [threading.Thread(target=work)
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert counts() == {f"msm.t{i}": n_threads for i in range(n_spans)}


def _train(seed: int):
    cfg = TM.with_dtype(TM.tiny_config(), "float32")
    model = TM.MultiFrameMLLM(cfg, param_dtype=torch.float32)
    TM.init_random_weights(model, 0)
    opt = PT.AdamW(list(model.named_parameters()),
                   PT.TrainConfig(warmup_steps=1))
    step = PT.make_train_step(model, opt)
    batch = TM.make_example_batch(cfg, batch=2, n_tiles=2, seq_len=96,
                                  seed=seed, device="cpu")
    return model, opt, step, batch


def test_a_train_step_records_its_five_phases_as_host_ranges(tmp_path):
    _, _, step, batch = _train(1)
    step(batch)                          # untraced: nothing recorded
    assert counts() == {}
    with traced() as prof:
        step(batch)
    assert counts() == dict.fromkeys(STEP_SPANS, 1)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    cats = {}
    for e in events:
        if str(e.get("name", "")).startswith("msm."):
            cats.setdefault(e["name"], set()).add(e.get("cat"))
    assert cats == dict.fromkeys(STEP_SPANS, {"cpu_op"})


def test_losses_and_gradients_are_the_same_bits_traced_or_not():
    runs = []
    for trace in (False, True):
        model, opt, step, batch = _train(2)
        out = []
        for _ in range(2):
            if trace:
                with traced():
                    m = step(batch)
            else:
                m = step(batch)
            out.append((m["loss"].clone(), m["grad_norm"].clone()))
        runs.append((out, [p.detach().clone() for p in opt.params],
                     [m.clone() for m in opt.mu + opt.nu]))
    (a, pa, sa), (b, pb, sb) = runs
    for (la, ga), (lb, gb) in zip(a, b):
        assert torch.equal(la, lb) and torch.equal(ga, gb)
    for x, y in zip(pa + sa, pb + sb):    # moments hold the gradients
        assert torch.equal(x, y)


def _frames(root, n: int) -> list[str]:
    rng = np.random.default_rng(4)
    names = []
    for i in range(n):
        name = f"img{i}.png"
        imwrite_png(os.path.join(root, name), rng.integers(
            0, 256, (56 * (1 + i % 2), 112, 3), dtype=np.uint8))
        names.append(name)
    return names


def test_the_packed_feed_counts_each_frame_on_its_producer_thread(tmp_path):
    cfg = TM.tiny_config()
    names = _frames(tmp_path, 3)
    recs = []
    for i in range(6):
        imgs = [names[(i + k) % 3] for k in range(1 + i % 2)]
        recs.append({"id": i, "image": imgs, "conversations": [
            {"from": "human",
             "value": "<image>\n" * len(imgs) + f"Where is object {i}?"},
            {"from": "gpt", "value": f"Left of object {i + 1}."}]})
    data_cfg = TD.DataConfig(max_seq_len=320, max_tiles=8,
                             preprocess=TP.PreprocessConfig(
                                 tile_size=56, max_tiles=2, resize_hw=None))
    threads = []

    def loader(rel):
        threads.append(threading.get_ident())
        return cli._read_image(os.path.join(tmp_path, rel))

    with traced():
        batches = list(TD.prefetch_iterator(TD.packed_batch_iterator(
            recs, TOK, cfg, loader, 2, data_cfg, drop_remainder=False)))
    n_frames = sum(len(r["image"]) for r in recs)
    assert len(threads) == n_frames and batches
    assert threading.get_ident() not in threads
    got = counts()
    assert got["msm.image.read"] == got["msm.image.tile"] == n_frames
    assert got["msm.data.wait"] == len(batches) + 1   # and the end


def _serve(tmp_path, trace: bool, vision_cache: int):
    cfg = TM.tiny_config()
    cfg = dataclasses.replace(
        cfg, vit=dataclasses.replace(cfg.vit, dtype="float32"),
        llm=dataclasses.replace(cfg.llm, dtype="float32",
                                vocab_size=TOK.vocab_size))
    model = TM.MultiFrameMLLM(cfg)
    TM.init_random_weights(model, 3)
    model.eval()
    batcher = TK.PagedBatcher(model, TK.PagedConfig(
        slots=2, page_size=16, num_pages=64, max_prompt_len=256,
        max_new_tokens=6, chunk=2, length_bucket=64,
        prefill_chunk=64 if vision_cache else 0, vision_cache=vision_cache),
        pad_id=TOK.pad_id, eos_id=TOK.eos_id)
    pre = TP.PreprocessConfig(tile_size=56, max_tiles=2, resize_hw=None)
    to_request = cli.make_request_builder(
        cfg, TOK, batcher, lambda rel: TP.tile_image(
            cli._read_image(os.path.join(tmp_path, rel)), pre))
    names = _frames(tmp_path, 2)
    lines = [json.dumps({"id": f"q{i}", "text": "<image>\n" * (1 + i % 2)
                         + "Which moved?", "image": names[:1 + i % 2],
                         "max_new_tokens": 3 + i}) for i in range(3)]
    out = []
    if trace:
        with traced():
            cli.serve_lines(batcher, lines, to_request, TOK, out.append,
                            stream=True)
    else:
        cli.serve_lines(batcher, lines, to_request, TOK, out.append,
                        stream=True)
    return out, batcher.stats, lines


@pytest.mark.parametrize("vision_cache", [0, 4])
def test_the_serve_loop_counts_a_dispatch_launch_and_read(tmp_path,
                                                          vision_cache):
    plain, _, _ = _serve(tmp_path, False, vision_cache)
    assert counts() == {}
    out, stats, lines = _serve(tmp_path, True, vision_cache)
    assert out == plain                  # the same objects, traced or not
    got = counts()
    n = stats["decode_dispatches"]
    assert n > 0
    assert got["msm.serve.decode_launch"] == got["msm.serve.decode_read"] \
        == n
    assert stats["prefill_full"] == len(lines)
    # a whole prefill enters the LLM's span; a chunked one (which the
    # vision cache needs) runs its layers chunk by chunk, outside it
    assert got.get("msm.model.llm", 0) == (0 if vision_cache else len(lines))
    # the ViT runs once a request, or with the vision cache once a set of
    # frames (the cache's hits skip it)
    frame_sets = {tuple(json.loads(x)["image"]) for x in lines}
    assert len(frame_sets) < len(lines)
    assert got["msm.model.vit"] == (len(frame_sets) if vision_cache
                                    else len(lines))
    n_frames = sum(len(json.loads(x)["image"]) for x in lines)
    assert got["msm.image.read"] == got["msm.image.tile"] == n_frames
