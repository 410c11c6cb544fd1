"""Port paged serving (multi_spatialmllm_tpu_torch.models.paged_kv and the
serve JSONL loop) against the JAX package's `PagedBatcher` at the `tiny`
config in float32, with the same Flax-initialised weights (moved with
`models/convert.py`) and the same numpy requests.

Greedy tokens must be identical. The one admitted exception: at the
first step where the two disagree, the port's CPU top-2 logit margin is
below 1e-4 (a near tie that float reduction order may flip); the token
streams are compared only up to there. The exception is asserted, not
skipped."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_spatialmllm_tpu.models import mllm as JM
from multi_spatialmllm_tpu.models import paged_kv as JK
from multi_spatialmllm_tpu.models.tokenizer import SpatialTokenizer
from multi_spatialmllm_tpu_torch.__main__ import (
    make_request_builder,
    serve_lines,
)
from multi_spatialmllm_tpu_torch.models import mllm as TM
from multi_spatialmllm_tpu_torch.models import paged_kv as TK
from multi_spatialmllm_tpu_torch.models.convert import (
    jax_params_to_state_dict,
)

MARGIN = 1e-4
EOS = 2
TOK = SpatialTokenizer()


def _tiny_f32(jax_side: bool):
    """tiny in float32 with the tokenizer's vocabulary (the serve loop
    feeds real token ids)."""
    cfg = JM.tiny_config() if jax_side else TM.tiny_config()
    return dataclasses.replace(
        cfg, vit=dataclasses.replace(cfg.vit, dtype="float32"),
        llm=dataclasses.replace(cfg.llm, dtype="float32",
                                vocab_size=TOK.vocab_size))


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = _tiny_f32(True), _tiny_f32(False)
    jmodel = JM.MultiFrameMLLM(jcfg)
    ids = np.full((1, 32), 10, np.int32)
    ids[0, 1:1 + jcfg.tokens_per_tile] = jcfg.img_context_id
    tiles = np.zeros((1, 1, 56, 56, 3), np.float32)
    params = jax.jit(jmodel.init)(
        jax.random.key(0), jnp.asarray(ids), jnp.asarray(tiles))
    tmodel = TM.MultiFrameMLLM(tcfg)
    tmodel.load_state_dict(jax_params_to_state_dict(params, jcfg))
    tmodel.eval()
    return jmodel, params, tmodel


def _requests(cfg, lens, seed=5):
    rng = np.random.default_rng(seed)
    out = []
    for i, n in enumerate(lens):
        ids = rng.integers(10, cfg.llm.vocab_size, size=n).astype(np.int32)
        ids[1:1 + cfg.tokens_per_tile] = cfg.img_context_id
        tiles = np.random.default_rng(100 + i).standard_normal(
            (1, cfg.vit.image_size, cfg.vit.image_size, 3)).astype(np.float32)
        out.append((ids, tiles))
    return out


def top2_margin(model, ids, tiles, generated, step):
    """The port's CPU top-2 logit margin for generated token `step`, by a
    teacher-forced forward over the prompt and the tokens before it."""
    seq = np.concatenate([ids, np.asarray(generated[:step], np.int32)])
    with torch.no_grad():
        logits = model(torch.from_numpy(seq)[None].long(),
                       torch.from_numpy(tiles)[None])[0, -1]
    top = torch.topk(logits.float(), 2).values
    return float(top[0] - top[1])


def assert_same_greedy(model, requests, got, want):
    """Identical tokens, or a first difference at a near tie (asserted)."""
    for (ids, tiles), g, w in zip(requests, got, want):
        g, w = list(map(int, g)), list(map(int, w))
        if g == w:
            continue
        k = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b),
                 min(len(g), len(w)))
        assert k < min(len(g), len(w)), (g, w)  # a length-only mismatch
        margin = top2_margin(model, ids, tiles, g, k)
        assert margin < MARGIN, (k, margin, g, w)


def _pcfg(module, **kw):
    base = dict(slots=3, page_size=16, num_pages=64, max_prompt_len=128,
                max_new_tokens=8, chunk=4, length_bucket=64)
    base.update(kw)
    return module.PagedConfig(**base)


def test_generate_all_matches_jax(models):
    jmodel, params, tmodel = models
    requests = _requests(tmodel.cfg, (40, 56, 48, 63, 44))
    want = JK.PagedBatcher(jmodel, params, _pcfg(JK), pad_id=0,
                           eos_id=EOS).generate_all(requests)
    batcher = TK.PagedBatcher(tmodel, _pcfg(TK), pad_id=0, eos_id=EOS)
    got = batcher.generate_all(requests)
    assert_same_greedy(tmodel, requests, got, want)
    assert batcher.allocator.available == 63
    assert (batcher.page_table == 0).all()


def test_pool_pressure_defers_and_preempts(models):
    """9 usable pages, two slots wanting 5 each: the second request is
    deferred and preempted until the first finishes; tokens still match
    JAX's batcher under the same pressure."""
    jmodel, params, tmodel = models
    requests = _requests(tmodel.cfg, (63, 62), seed=9)
    kw = dict(slots=2, num_pages=10, max_prompt_len=64, max_new_tokens=6,
              chunk=2)
    want = JK.PagedBatcher(jmodel, params, _pcfg(JK, **kw), pad_id=0,
                           eos_id=EOS).generate_all(requests)
    batcher = TK.PagedBatcher(tmodel, _pcfg(TK, **kw), pad_id=0, eos_id=EOS)
    got = batcher.generate_all(requests)
    assert_same_greedy(tmodel, requests, got, want)
    assert batcher.stats["prefill_full"] > len(requests)  # replays
    assert batcher.allocator.available == 9


def test_serve_jsonl_loop(models):
    """The serve loop answers every good line with the batcher's tokens
    and their text, streams deltas that reassemble them, and answers a
    bad line with an error."""
    _, _, tmodel = models
    cfg = tmodel.cfg
    reqs = _requests(cfg, (40, 50, 44), seed=11)
    images = {f"img{i}.png": tiles for i, (_, tiles) in enumerate(reqs)}
    lines = [json.dumps({"id": "a", "text": "<image>\nHow far apart?",
                         "image": ["img0.png"]}),
             "{not json",
             json.dumps({"id": "b", "text": "<image>\n<image>\nWhich moved?",
                         "image": ["img1.png", "img2.png"],
                         "max_new_tokens": 3}),
             ""]
    for stream in (False, True):
        batcher = TK.PagedBatcher(tmodel, _pcfg(TK, max_prompt_len=256),
                                  pad_id=TOK.pad_id, eos_id=TOK.eos_id)
        to_request = make_request_builder(cfg, TOK, batcher, images.get)
        out = []
        serve_lines(batcher, lines, to_request, TOK, out.append,
                    window=2, stream=stream)
        direct = batcher.generate_all(
            [to_request(json.loads(lines[i])) for i in (0, 2)])
        expect = {"a": direct[0].tolist(), "b": direct[1].tolist()}
        assert len(expect["b"]) <= 3
        errors = [o for o in out if "error" in o]
        assert len(errors) == 1 and errors[0]["id"] == "line2"
        if stream:
            acc = {"a": [], "b": []}
            text = {"a": "", "b": ""}
            for o in out:
                if "error" not in o:
                    acc[o["id"]] += o["delta_ids"]
                    text[o["id"]] += o["delta"]
            assert acc == expect
            assert text == {k: TOK.decode(v) for k, v in expect.items()}
        else:
            finals = {o["id"]: o for o in out if "error" not in o}
            assert {k: v["token_ids"] for k, v in finals.items()} == expect
            assert finals["a"]["text"] == TOK.decode(expect["a"])


def test_unported_options_raise(models):
    """The six serving options and multi-LoRA serving are ported (they
    build; tests/test_torch_lora.py serves adapters); what raises is an
    adapter set without its LoRAConfig and an adapter name the batcher
    does not know (as in the JAX batcher), and an unknown kv dtype."""
    _, _, tmodel = models
    for kw in (dict(prefix_cache=True),
               dict(prefill_chunk=16), dict(vision_cache=2),
               dict(speculate=2), dict(sampling=True), dict(logprobs=True)):
        cfg = TK.PagedConfig(**kw)
        assert TK.PagedBatcher(tmodel, cfg).config == cfg
    assert TK.PagedConfig(kv_dtype="int8").kv_dtype == "int8"  # ported
    with pytest.raises(ValueError, match="needs lora_config"):
        TK.PagedBatcher(tmodel, TK.PagedConfig(), adapters={"a": {}})
    ids, tiles = _requests(tmodel.cfg, (40,))[0]
    with pytest.raises(ValueError, match="unknown adapter 'adapter'"):
        TK.PagedBatcher(tmodel, TK.PagedConfig()).generate_all(
            [(ids, tiles, "adapter")])
    with pytest.raises(ValueError, match="kv_dtype"):
        TK.PagedConfig(kv_dtype="fp8")


def test_bench_paged_config_matches_jax():
    for kv in ("native", "int8"):
        j, t = JK.bench_paged_config(kv_dtype=kv), TK.bench_paged_config(
            kv_dtype=kv)
        for field in dataclasses.fields(t):
            assert getattr(t, field.name) == getattr(j, field.name), \
                (kv, field.name)


@pytest.fixture(scope="module", params=["einsum", "ragged"])
def moe_models(request):
    """Tiny MoE in float32 with the tokenizer's vocabulary, the same
    weights on both sides; ragged runs the port on K8's plain version
    (`moe_kernel="pallas"`) against JAX's `lax.ragged_dot`."""
    impl = request.param
    jcfg, tcfg = _tiny_f32(True), _tiny_f32(False)
    jcfg = dataclasses.replace(jcfg, llm=dataclasses.replace(
        jcfg.llm, moe_experts=4, moe_impl=impl))
    tcfg = dataclasses.replace(tcfg, llm=dataclasses.replace(
        tcfg.llm, moe_experts=4, moe_impl=impl,
        moe_kernel="pallas" if impl == "ragged" else "xla"))
    jmodel = JM.MultiFrameMLLM(jcfg)
    ids = np.full((1, 32), 10, np.int32)
    ids[0, 1:1 + jcfg.tokens_per_tile] = jcfg.img_context_id
    params = jax.jit(jmodel.init)(jax.random.key(2), jnp.asarray(ids),
                                  jnp.zeros((1, 1, 56, 56, 3), jnp.float32))
    tmodel = TM.MultiFrameMLLM(tcfg)
    tmodel.load_state_dict(jax_params_to_state_dict(params, jcfg))
    tmodel.eval()
    return jmodel, params, tmodel


def test_moe_int8_kv_greedy_matches_jax(moe_models):
    """Tiny MoE served with int8 kv pools (quantised prefill insert and
    decode writes, dequantised windows): greedy tokens match JAX's
    `PagedBatcher`, which takes its XLA gather path on the CPU."""
    jmodel, params, tmodel = moe_models
    requests = _requests(tmodel.cfg, (40, 56, 48, 63))
    kw = dict(kv_dtype="int8", max_new_tokens=10)
    want = JK.PagedBatcher(jmodel, params, _pcfg(JK, **kw), pad_id=0,
                           eos_id=EOS).generate_all(requests)
    batcher = TK.PagedBatcher(tmodel, _pcfg(TK, **kw), pad_id=0, eos_id=EOS)
    got = batcher.generate_all(requests)
    assert_same_greedy(tmodel, requests, got, want)
    assert batcher.pools[0]["k_pages"].dtype == torch.int8
    assert batcher.pools[0]["k_scale"].dtype == torch.float32


def test_page_allocator():
    a = TK.PageAllocator(8)            # pages 1..7 usable, 0 is the sink
    got = a.alloc(7)
    assert sorted(got) == list(range(1, 8))
    assert a.alloc(1) is None and a.alloc(0) == []
    a.release(got[:3])
    assert a.alloc(4) is None          # all-or-nothing
    assert len(a.alloc(3)) == 3
    with pytest.raises(ValueError):
        a.release([0])


def test_make_serve_requests_shape():
    cfg = TM.tiny_config()
    reqs = TK.make_serve_requests(cfg, 4, questions_per_image=2)
    assert len(reqs) == 4
    for ids, tiles in reqs:
        assert tiles.shape == (1, 56, 56, 3) and tiles.dtype == np.float32
        assert (ids == cfg.img_context_id).sum() == cfg.tokens_per_tile
        assert 16 <= len(ids) - (cfg.tokens_per_tile + 26) < 176
    assert reqs[0][1] is reqs[1][1] and reqs[0][1] is not reqs[2][1]
    again = TK.make_serve_requests(cfg, 4, questions_per_image=2)
    assert all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
               for a, b in zip(reqs, again))
