"""The port's PagedBatcher options (prefix cache, chunked prefill, vision
cache, speculation, sampling, logprobs; each with int8 kv pools) and its
weight-only int8 (models/quantize.py) against the JAX package's, at a tiny
float32 config with the same weights and requests.

Tokens must equal JAX's batcher with the same option, greedy ones up to a
near tie and sampled ones up to a near tie of logits + Gumbel noise or a
top-p boundary (tests/test_torch_generate.py states the bounds). The JAX
package's invariants hold on the port by themselves: cached outputs equal
uncached ones, chunked prefill equals one-shot prefill, speculation equals
greedy, sampling is invariant to batch composition and preemption, and
page reference counts are conserved. Quantised int8 values and scales
equal JAX's leaf for leaf, and a quantised model gives exactly the tokens
of its dequantised copy."""

import copy

import jax
import numpy as np
import pytest
import torch

from multi_spatialmllm_tpu.models import paged_kv as JK
from multi_spatialmllm_tpu.models import quantize as JQ
from multi_spatialmllm_tpu.models.serving import SamplingParams as JSP
from multi_spatialmllm_tpu_torch.models import mllm as TM
from multi_spatialmllm_tpu_torch.models import paged_kv as TK
from multi_spatialmllm_tpu_torch.models import quantize as TQ
from multi_spatialmllm_tpu_torch.models.convert import (
    jax_params_to_state_dict,
)
from multi_spatialmllm_tpu_torch.models.serving import SamplingParams as TSP
from test_torch_generate import (
    EOS,
    SAMPLING,
    assert_same_greedy,
    assert_same_sampled,
    batcher_noise,
    make_pair,
    one_torch_thread,  # noqa: F401 (an autouse fixture)
    request_list,
)

BASE = dict(slots=2, page_size=16, num_pages=64, max_prompt_len=128,
            max_new_tokens=8, chunk=2, length_bucket=64)
LENS = (50, 66, 58, 73, 54)


@pytest.fixture(scope="module")
def pair():
    return make_pair()


@pytest.fixture(scope="module")
def requests(pair):
    return request_list(pair[0], LENS, shared_head=True)


def run(model, requests, **kw):
    b = TK.PagedBatcher(model, TK.PagedConfig(**{**BASE, **kw}), pad_id=0,
                        eos_id=EOS)
    return b, b.generate_all(requests)


def tagged(requests, sp):
    return [r + (sp(*k),) for r, k in zip(requests, SAMPLING)]


OPTIONS = [dict(prefix_cache=True), dict(prefill_chunk=16),
           dict(prefill_chunk=16, vision_cache=2),
           dict(prefill_chunk=16, prefix_cache=True, vision_cache=2),
           dict(speculate=3), dict(logprobs=True),
           dict(kv_dtype="int8", prefix_cache=True),
           dict(kv_dtype="int8", prefill_chunk=16, speculate=2),
           dict(kv_dtype="int8", prefill_chunk=16, vision_cache=2,
                logprobs=True)]


@pytest.mark.parametrize("kw", OPTIONS, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()))
def test_greedy_option_matches_jax(pair, requests, kw):
    """Each option's greedy tokens and counters equal JAX's batcher's
    (logprobs within 1e-5)."""
    cfg, jmodel, params, tmodel = pair
    jb = JK.PagedBatcher(jmodel, params, JK.PagedConfig(**BASE, **kw),
                         pad_id=0, eos_id=EOS)
    want = jb.generate_all(requests)
    tb, got = run(tmodel, requests, **kw)
    assert_same_greedy(tmodel, requests, got, want)
    for key, n in jb.stats.items():
        assert tb.stats[key] == n, (key, tb.stats, jb.stats)
    if kw.get("logprobs"):
        for rid, (g, w) in enumerate(zip(got, want)):
            assert len(tb.request_logprobs[rid]) == len(g)
            if np.array_equal(g, w):
                np.testing.assert_allclose(tb.request_logprobs[rid],
                                           jb.request_logprobs[rid],
                                           atol=1e-5)


@pytest.mark.parametrize("kw", [dict(), dict(prefill_chunk=16, top_k=20),
                                dict(kv_dtype="int8", logprobs=True),
                                dict(prefix_cache=True)])
def test_sampled_option_matches_jax(pair, requests, kw):
    cfg, jmodel, params, tmodel = pair
    jb = JK.PagedBatcher(jmodel, params,
                         JK.PagedConfig(**BASE, sampling=True, **kw),
                         pad_id=0, eos_id=EOS)
    want = jb.generate_all(tagged(requests, JSP))
    _, got = run(tmodel, tagged(requests, TSP), sampling=True, **kw)
    assert_same_sampled(
        tmodel, requests, got, want,
        batcher_noise(requests, SAMPLING, cfg.llm.vocab_size),
        np.asarray([k[0] for k in SAMPLING], np.float32), kw.get("top_k"),
        np.asarray([k[1] for k in SAMPLING], np.float32))


def test_cached_chunked_and_speculative_equal_plain(pair, requests):
    """The port's own invariants: prefix-cached, chunked (with and without
    the vision cache) and speculative outputs equal the plain greedy
    batcher's; the vision cache hits the repeated images."""
    tmodel = pair[3]
    _, want = run(tmodel, requests)
    for kw in (dict(prefix_cache=True), dict(prefill_chunk=16),
               dict(prefill_chunk=7, vision_cache=2, prefix_cache=True),
               dict(speculate=3), dict(speculate=2, prefix_cache=True,
                                       prefill_chunk=16)):
        b, got = run(tmodel, requests, **kw)
        assert_same_greedy(tmodel, requests, got, want)
    assert b.stats["prefill_resumed"] > 0 and b.stats["spec_verifies"] > 0


def test_prefix_refcounts_clear_and_eviction(pair, requests):
    tmodel = pair[3]
    b, want = run(tmodel, requests, prefix_cache=True)
    held = len(b.prefix_pages)
    assert held > 0 and b.stats["pages_reused"] > 0
    assert b.allocator.available == BASE["num_pages"] - 1 - held
    assert set(b.allocator.refs.values()) == {1}   # the cache's own refs
    b.clear_prefix_cache()
    assert b.allocator.available == BASE["num_pages"] - 1
    assert b.allocator.refs == {}
    # a pool too small to keep every cached page evicts LRU cache pages
    small, got = run(tmodel, requests, prefix_cache=True, num_pages=14)
    assert small.stats["pages_evicted"] > 0
    assert_same_greedy(tmodel, requests, got, want)
    # different pixels under the same ids share no vision page
    ids, tiles = requests[0]
    b2, _ = run(tmodel, [(ids, tiles), (ids, tiles + 1.0)],
                prefix_cache=True)
    assert b2.stats["pages_reused"] == 0


def test_sampling_invariant_to_composition_and_preemption(pair, requests):
    tmodel = pair[3]
    reqs = tagged(requests, TSP)
    _, want = run(tmodel, reqs, sampling=True)
    _, alone = run(tmodel, reqs, sampling=True, slots=1)
    _, pressed = run(tmodel, reqs, sampling=True, slots=3, num_pages=12)
    for a, b, c in zip(want, alone, pressed):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_stream_reassembles_and_logprobs_align(pair, requests):
    tmodel = pair[3]
    b = TK.PagedBatcher(tmodel, TK.PagedConfig(**BASE, speculate=3),
                        pad_id=0, eos_id=EOS)
    acc: dict[int, list[int]] = {}
    for rid, toks, _ in b.generate_stream(requests):
        acc.setdefault(rid, []).extend(toks)
    _, want = run(tmodel, requests, speculate=3)
    for rid, w in enumerate(want):
        np.testing.assert_array_equal(acc[rid], w)
    b, got = run(tmodel, requests, logprobs=True, max_new_tokens=5)
    for rid, g in enumerate(got):
        lp = b.request_logprobs[rid]
        assert len(lp) == len(g) and all(np.isfinite(lp)) and max(lp) <= 0


def test_refusals(pair):
    tmodel = pair[3]
    with pytest.raises(ValueError, match="greedy-exact"):
        TK.PagedBatcher(tmodel, TK.PagedConfig(speculate=2, sampling=True))
    with pytest.raises(ValueError, match="logprobs"):
        TK.PagedBatcher(tmodel, TK.PagedConfig(speculate=2, logprobs=True))
    ids, tiles = request_list(tmodel.cfg, (50,))[0]
    b = TK.PagedBatcher(tmodel, TK.PagedConfig(**BASE))
    with pytest.raises(ValueError, match="sampling=True"):
        b.generate_all([(ids, tiles, TSP(temperature=0.5))])


# -- weight-only int8 ---------------------------------------------------------


def _jax_leaves(q, key):
    """A params-shaped tree of a quantised tree's int8 values (`key`
    "w_int8") or scales broadcast to the kernel (`key` "w_scale")."""
    if isinstance(q, dict):
        if set(q) == {"w_int8", "w_scale"}:
            return np.broadcast_to(np.asarray(q[key], np.float32),
                                   q["w_int8"].shape)
        return {k: _jax_leaves(v, key) for k, v in q.items()}
    return np.asarray(q)


@pytest.mark.parametrize("moe", [0, 4])
@pytest.mark.parametrize("min_size,skip", [(1 << 16, ("embed",)), (1, ()),
                                           (1000, ("embed",))])
def test_quantize_weights_match_jax_leaf_for_leaf(moe, min_size, skip):
    cfg, _, params, tmodel = make_pair(**({"moe_experts": moe} if moe
                                          else {}))
    q = JQ.quantize_weights(params, min_size=min_size, skip=skip)
    want_q = jax_params_to_state_dict(_jax_leaves(q, "w_int8"), cfg)
    want_s = jax_params_to_state_dict(_jax_leaves(q, "w_scale"), cfg)
    n_jax = sum(1 for _ in jax.tree_util.tree_leaves(q)) - sum(
        1 for _ in jax.tree_util.tree_leaves(params))
    sd = TQ.quantize_model(copy.deepcopy(tmodel), min_size=min_size,
                           skip=skip).state_dict()
    names = [k[: -len(TQ.SCALE)] for k in sd if k.endswith(TQ.SCALE)]
    assert len(names) == n_jax > 0
    for name in names:
        assert sd[name].dtype == torch.int8
        torch.testing.assert_close(sd[name].float(), want_q[name],
                                   rtol=0, atol=0)
        torch.testing.assert_close(
            torch.broadcast_to(sd[name + TQ.SCALE], sd[name].shape),
            want_s[name], rtol=0, atol=0)
    assert TQ.dequantize_weights(sd).keys() == tmodel.state_dict().keys()


def test_quantized_model_equals_dequantized_oracle(pair, requests):
    """int8 weights x int8 kv x prefix cache x chunked prefill x sampling:
    the same tokens as a model holding the dequantised weights, for the
    paged batcher and the batched greedy path; the weights shrink."""
    from multi_spatialmllm_tpu_torch.models.generate import (
        greedy_generate_batched,
    )

    tmodel = pair[3]
    qmodel = TQ.quantize_model(copy.deepcopy(tmodel))
    oracle = TM.MultiFrameMLLM(tmodel.cfg)
    oracle.load_state_dict(TQ.dequantize_weights(qmodel.state_dict()))
    oracle.eval()
    assert TQ.tree_nbytes(qmodel) < TQ.tree_nbytes(tmodel)
    reqs = tagged(requests, TSP)
    kw = dict(kv_dtype="int8", prefix_cache=True, prefill_chunk=16,
              sampling=True)
    _, got = run(qmodel, reqs, **kw)
    _, want = run(oracle, reqs, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    ids, tiles = requests[0]
    a = greedy_generate_batched(qmodel, ids[None], tiles[None],
                                [len(ids)], max_new_tokens=6)
    b = greedy_generate_batched(oracle, ids[None], tiles[None],
                                [len(ids)], max_new_tokens=6)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
