"""Port generation (multi_spatialmllm_tpu_torch.models.generate and the
contiguous `ContinuousBatcher` of models/serving.py) against the JAX
package's, at a tiny float32 config with the same Flax-initialised weights
(moved with `models/convert.py`) and the same seeded numpy prompts.

Greedy, batched and speculative tokens must be identical; the one
admitted exception: at the first step where the two differ, the port's
CPU top-2 logit margin is below MARGIN (a near tie float reduction order
may flip). Sampled tokens must be identical; the admitted exception: at
the first difference, the top two of the port's masked logits plus its
Gumbel noise lie within MARGIN / temperature (JAX's float32 logs differ
from the port's rounded float64 ones by a few ulp, models/prng.py), or
the top-p boundary lies within TOP_P_EPS of the exclusive cumulative sum.
Both exceptions are asserted, never skipped."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_spatialmllm_tpu.models import generate as JG
from multi_spatialmllm_tpu.models import mllm as JM
from multi_spatialmllm_tpu.models import serving as JS
from multi_spatialmllm_tpu_torch.models import generate as TG
from multi_spatialmllm_tpu_torch.models import mllm as TM
from multi_spatialmllm_tpu_torch.models import prng
from multi_spatialmllm_tpu_torch.models import serving as TS
from multi_spatialmllm_tpu_torch.models.convert import (
    jax_params_to_state_dict,
)

MARGIN = 1e-4
TOP_P_EPS = 1e-5
EOS = 2


def f32(cfg):
    return dataclasses.replace(
        cfg, vit=dataclasses.replace(cfg.vit, dtype="float32"),
        llm=dataclasses.replace(cfg.llm, dtype="float32"))


def make_pair(seed=0, **llm):
    """(JAX config, JAX model, params, port model): tiny float32 with the
    same weights on both sides; `llm` overrides the decoder config."""
    jcfg, tcfg = f32(JM.tiny_config()), f32(TM.tiny_config())
    if llm:
        jcfg = dataclasses.replace(jcfg, llm=dataclasses.replace(jcfg.llm,
                                                                 **llm))
        tcfg = dataclasses.replace(tcfg, llm=dataclasses.replace(tcfg.llm,
                                                                 **llm))
    jmodel = JM.MultiFrameMLLM(jcfg)
    b = JM.make_example_batch(jcfg, batch=1, n_tiles=1, seq_len=64)
    params = jax.jit(jmodel.init)(jax.random.key(seed), b["input_ids"],
                                  b["tiles"])
    tmodel = TM.MultiFrameMLLM(tcfg)
    tmodel.load_state_dict(jax_params_to_state_dict(params, jcfg))
    tmodel.eval()
    return jcfg, jmodel, params, tmodel


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these tiny shapes: the suite's other
    workers share the cores, and spinning thread pools slow every one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    return make_pair()


def batch_prompts(cfg, b=3, t=64, seed=0):
    """`[b, t]` ids with one tile's image-context run, and tiles."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(10, cfg.llm.vocab_size, size=(b, t)).astype(np.int32)
    ids[:, 1:1 + cfg.tokens_per_tile] = cfg.img_context_id
    tiles = rng.standard_normal(
        (b, 1, cfg.vit.image_size, cfg.vit.image_size, 3)).astype(np.float32)
    return ids, tiles


def request_list(cfg, lens, seed=5, shared_head=False):
    """Requests (ids, tiles `[1, H, W, 3]`) of the given lengths; with
    `shared_head` consecutive pairs share a 42-token head and image."""
    rng = np.random.default_rng(seed)
    head = rng.integers(10, cfg.llm.vocab_size, size=42).astype(np.int32)
    head[1:1 + cfg.tokens_per_tile] = cfg.img_context_id
    out = []
    for i, n in enumerate(lens):
        tiles = np.random.default_rng(100 + (i // 2 if shared_head else i)) \
            .standard_normal((1, cfg.vit.image_size, cfg.vit.image_size, 3)) \
            .astype(np.float32)
        if shared_head:
            ids = np.concatenate([head, rng.integers(
                10, cfg.llm.vocab_size, size=n - 42).astype(np.int32)])
        else:
            ids = rng.integers(10, cfg.llm.vocab_size, size=n).astype(np.int32)
            ids[1:1 + cfg.tokens_per_tile] = cfg.img_context_id
        out.append((ids, tiles))
    return out


def teacher_logits(model, ids, tiles, generated, step):
    """The port's CPU logits for generated token `step` (a forward over
    the prompt and the tokens before it)."""
    seq = np.concatenate([np.asarray(ids), np.asarray(generated[:step])])
    with torch.no_grad():
        return model(torch.from_numpy(seq.astype(np.int64))[None],
                     torch.as_tensor(np.asarray(tiles))[None])[0, -1]


def first_difference(g, w):
    """Index of the first differing token, or None when equal; a pure
    length difference is a failure."""
    g, w = list(map(int, g)), list(map(int, w))
    if g == w:
        return None
    k = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b),
             min(len(g), len(w)))
    assert k < min(len(g), len(w)), (g, w)
    return k


def assert_same_greedy(model, prompts, got, want):
    """Identical tokens, or a first difference at a near tie."""
    for (ids, tiles), g, w in zip(prompts, got, want):
        k = first_difference(g, w)
        if k is None:
            continue
        top = torch.topk(teacher_logits(model, ids, tiles, g, k), 2).values
        assert float(top[0] - top[1]) < MARGIN, (k, g, w)


def assert_same_sampled(model, prompts, got, want, noise, temperature,
                        top_k, top_p):
    """Identical tokens, or at the first difference (row r, step k) a near
    tie of the port's masked logits + `noise(r, k)`, or a top-p boundary
    within TOP_P_EPS."""
    for r, ((ids, tiles), g, w) in enumerate(zip(prompts, got, want)):
        k = first_difference(g, w)
        if k is None:
            continue
        logits = teacher_logits(model, ids, tiles, g, k)[None]
        temp = float(temperature[r] if np.ndim(temperature) else temperature)
        tp = top_p[r] if np.ndim(top_p) else top_p
        if temp == 0.0:                           # a greedy row
            top = torch.topk(logits[0], 2).values
            assert float(top[0] - top[1]) < MARGIN, (r, k, g, w)
            continue
        z = TG.mask_logits(logits, temp, top_k, tp)[0] + noise(r, k)
        top = torch.topk(z, 2).values
        if float(top[0] - top[1]) < MARGIN / temp:
            continue
        assert tp is not None and top_p_gap(
            TG.mask_logits(logits, temp, top_k, None)[0], tp) < TOP_P_EPS, \
            (r, k, g, w)


def top_p_gap(scaled: torch.Tensor, top_p: float) -> float:
    """How close `top_p` comes to an exclusive cumulative sum of the
    sorted probabilities of `scaled` logits `[V]` (a nucleus boundary)."""
    probs = torch.softmax(torch.sort(scaled, descending=True).values
                          .double(), -1)
    return float(((torch.cumsum(probs, -1) - probs) - top_p).abs().min())


def trim(rows):
    """Rows of a `[B, n]` output cut at their first eos."""
    out = []
    for row in np.asarray(rows):
        hit = np.flatnonzero(row == EOS)
        out.append(row[: hit[0]] if len(hit) else row)
    return out


def row_prompts(ids, tiles, lens):
    return [(ids[r, :n], tiles[r]) for r, n in enumerate(lens)]


def test_greedy_generate_matches_jax(pair):
    cfg, jmodel, params, tmodel = pair
    ids, tiles = batch_prompts(cfg, b=2, t=48)
    want = JG.greedy_generate(jmodel, params, ids, tiles, max_new_tokens=10,
                              prompt_len=40)
    got = TG.greedy_generate(tmodel, ids, tiles, max_new_tokens=10,
                             prompt_len=40)
    assert got.shape == (2, 10)
    assert_same_greedy(tmodel, row_prompts(ids, tiles, [40, 40]),
                       np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("eos", [None, EOS])
def test_greedy_batched_matches_jax_and_rows(pair, eos):
    """Per-row prompt lengths: JAX's tokens, and each row equal to the
    port's greedy_generate of that row alone."""
    cfg, jmodel, params, tmodel = pair
    ids, tiles = batch_prompts(cfg)
    lens = np.asarray([50, 64, 40])
    want = np.asarray(JG.greedy_generate_batched(
        jmodel, params, ids, tiles, lens, max_new_tokens=12, eos_id=eos))
    got = TG.greedy_generate_batched(tmodel, ids, tiles, lens,
                                     max_new_tokens=12, eos_id=eos).numpy()
    prompts = row_prompts(ids, tiles, lens)
    assert_same_greedy(tmodel, prompts, trim(got), trim(want))
    for r in range(3):
        alone = TG.greedy_generate(tmodel, ids[r:r + 1], tiles[r:r + 1],
                                   max_new_tokens=12, eos_id=eos,
                                   prompt_len=lens[r]).numpy()
        np.testing.assert_array_equal(trim(alone)[0], trim(got)[r])


def test_eos_stop_fills_like_jax(pair):
    """A model whose every step emits eos stops at once: the undecoded
    slots hold the fill, as JAX's while_loop leaves them."""
    cfg, jmodel, params, tmodel = pair
    ids, tiles = batch_prompts(cfg, b=2, t=32)
    first = TG.greedy_generate(tmodel, ids, tiles, max_new_tokens=1).numpy()
    eos = int(first[0, 0])
    want = np.asarray(JG.greedy_generate(jmodel, params, ids, tiles,
                                         max_new_tokens=9, eos_id=eos))
    got = TG.greedy_generate(tmodel, ids, tiles, max_new_tokens=9,
                             eos_id=eos).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_draft", [1, 3, 5])
def test_speculative_equals_greedy_and_jax(pair, n_draft):
    cfg, jmodel, params, tmodel = pair
    ids, tiles = batch_prompts(cfg)
    lens = np.asarray([50, 64, 40])
    greedy = TG.greedy_generate_batched(tmodel, ids, tiles, lens,
                                        max_new_tokens=12, eos_id=EOS)
    spec, iters = TG.speculative_generate(
        tmodel, ids, tiles, max_new_tokens=12, eos_id=EOS, prompt_lens=lens,
        n_draft=n_draft, return_stats=True)
    np.testing.assert_array_equal(trim(spec), trim(greedy))
    jspec, jiters = JG.speculative_generate(
        jmodel, params, ids, tiles, max_new_tokens=12, eos_id=EOS,
        prompt_lens=lens, n_draft=n_draft, return_stats=True)
    assert_same_greedy(tmodel, row_prompts(ids, tiles, lens), trim(spec),
                       trim(jspec))
    assert 1 <= iters <= 11


def test_speculation_accepts_drafts_on_a_loop(pair):
    """A prompt that repeats one bigram chain: the port's speculation
    verifies several tokens a forward and still equals greedy."""
    cfg, jmodel, params, tmodel = pair
    ids, tiles = batch_prompts(cfg, b=1, t=64)
    greedy = TG.greedy_generate(tmodel, ids, tiles, max_new_tokens=24)
    cont = greedy.numpy()[0]
    loop = np.concatenate([ids[0, :20], np.tile(cont[:8], 5)])[:64]
    loop_ids = loop[None].astype(np.int32)
    base = TG.greedy_generate(tmodel, loop_ids, tiles, max_new_tokens=20)
    spec, iters = TG.speculative_generate(tmodel, loop_ids, tiles,
                                          max_new_tokens=20, n_draft=4,
                                          return_stats=True)
    np.testing.assert_array_equal(spec.numpy(), base.numpy())
    jspec = JG.speculative_generate(jmodel, params, loop_ids, tiles,
                                    max_new_tokens=20, n_draft=4)
    assert_same_greedy(tmodel, [(loop, tiles[0])], spec.numpy(),
                       np.asarray(jspec))
    assert iters <= 19


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (1.0, None, None), (0.7, None, 0.9), (1.3, 20, 0.8), (0.5, 5, None),
    (np.asarray([0.0, 0.9, 1.7], np.float32), None,
     np.asarray([1.0, 0.6, 0.95], np.float32))])
def test_mask_logits_matches_jax(temperature, top_k, top_p):
    """The masked set equals JAX's; a differing entry must sit at a top-p
    boundary within TOP_P_EPS of the exclusive cumulative sum."""
    rng = np.random.default_rng(0)
    logits = (4 * rng.standard_normal((3, 900))).astype(np.float32)
    want = np.asarray(JG._mask_logits(jnp.asarray(logits), temperature,
                                      top_k, top_p))
    got = TG.mask_logits(torch.from_numpy(logits), temperature, top_k,
                         top_p).numpy()
    same = np.isneginf(got) == np.isneginf(want)
    if not same.all():
        assert top_p is not None
        scaled = TG.mask_logits(torch.from_numpy(logits), temperature, top_k,
                                None)
        for r in np.flatnonzero(~same.all(axis=1)):
            tp = top_p[r] if np.ndim(top_p) else top_p
            assert top_p_gap(scaled[r], float(tp)) < TOP_P_EPS, r
    live = ~np.isneginf(got) & ~np.isneginf(want)
    np.testing.assert_array_equal(got[live], want[live])


@pytest.mark.parametrize("seed,temperature,top_k,top_p", [
    (0, 1.0, None, None), (3, 0.7, None, 0.9), (5, 1.3, 20, 0.8),
    (2**31 - 1, 0.9, None, 0.5), (7, 0.0, None, None)])
def test_sample_generate_matches_jax(pair, seed, temperature, top_k, top_p):
    cfg, jmodel, params, tmodel = pair
    ids, tiles = batch_prompts(cfg)
    lens = np.asarray([50, 64, 40])
    want = np.asarray(JG.sample_generate(
        jmodel, params, ids, tiles, jax.random.key(seed), max_new_tokens=12,
        eos_id=EOS, prompt_lens=lens, temperature=temperature, top_k=top_k,
        top_p=top_p))
    got = TG.sample_generate(
        tmodel, ids, tiles, prng.key(seed), max_new_tokens=12, eos_id=EOS,
        prompt_lens=lens, temperature=temperature, top_k=top_k,
        top_p=top_p).numpy()
    if temperature == 0.0:
        greedy = TG.greedy_generate_batched(tmodel, ids, tiles, lens,
                                            max_new_tokens=12, eos_id=EOS)
        np.testing.assert_array_equal(got, greedy.numpy())

    def noise(r, k):             # the key of step k: split once a step
        key = prng.key(seed)
        for _ in range(k + 1):
            key, sub = prng.split(key)
        return prng.gumbel(sub, (3, cfg.llm.vocab_size))[r]

    assert_same_sampled(tmodel, row_prompts(ids, tiles, lens), trim(got),
                        trim(want), noise, temperature, top_k, top_p)


SERVE = dict(slots=2, max_prompt_len=128, max_new_tokens=8, chunk=3,
             length_bucket=64)
SAMPLING = [(0.8, 0.9, 7), (0.0, 1.0, 0), (1.2, 1.0, 41), (1.0, 0.5, 3),
            (0.5, 1.0, 2**31 - 1)]


def batcher_noise(requests, knobs, vocab):
    """The Gumbel noise of request r's token k: key fold(seed, position)."""
    def noise(r, k):
        pos = len(requests[r][0]) - 1 + k
        key = prng.fold_in(prng.key(torch.tensor(knobs[r][2],
                                                 dtype=torch.int32)), pos)
        return prng.gumbel(key, (vocab,))
    return noise


@pytest.mark.parametrize("kw", [{}, {"speculate": 3}, {"logprobs": True},
                                {"sampling": True},
                                {"sampling": True, "top_k": 30,
                                 "logprobs": True}])
def test_continuous_batcher_matches_jax(pair, kw):
    """ContinuousBatcher: JAX's tokens for each option (logprobs within
    1e-5), speculation equal to the plain greedy batcher's."""
    cfg, jmodel, params, tmodel = pair
    requests = request_list(cfg, (50, 66, 58, 73, 54), shared_head=True)
    jreq, treq = requests, requests
    if kw.get("sampling"):
        jreq = [r + (JS.SamplingParams(*k),) for r, k in zip(requests,
                                                             SAMPLING)]
        treq = [r + (TS.SamplingParams(*k),) for r, k in zip(requests,
                                                             SAMPLING)]
    jb = JS.ContinuousBatcher(jmodel, params, JS.ServeConfig(**SERVE, **kw),
                              pad_id=0, eos_id=EOS)
    tb = TS.ContinuousBatcher(tmodel, TS.ServeConfig(**SERVE, **kw),
                              pad_id=0, eos_id=EOS)
    want, got = jb.generate_all(jreq), tb.generate_all(treq)
    if kw.get("sampling"):
        assert_same_sampled(
            tmodel, requests, got, want,
            batcher_noise(requests, SAMPLING, cfg.llm.vocab_size),
            np.asarray([k[0] for k in SAMPLING], np.float32), kw.get("top_k"),
            np.asarray([k[1] for k in SAMPLING], np.float32))
    else:
        assert_same_greedy(tmodel, requests, got, want)
    if kw.get("speculate"):
        plain = TS.ContinuousBatcher(tmodel, TS.ServeConfig(**SERVE),
                                     pad_id=0, eos_id=EOS)
        for a, b in zip(got, plain.generate_all(requests)):
            np.testing.assert_array_equal(a, b)
        assert tb.stats["spec_verifies"] > 0
    if kw.get("logprobs"):
        for rid, (g, w) in enumerate(zip(got, want)):
            if np.array_equal(g, w):
                np.testing.assert_allclose(tb.request_logprobs[rid],
                                           jb.request_logprobs[rid],
                                           atol=1e-5)
            assert len(tb.request_logprobs[rid]) == len(g)


def test_continuous_batcher_sampling_invariant_to_slots(pair):
    """A sampled stream is a function of (seed, position) only: one slot
    or three, the same tokens; temperature 0 rows equal greedy."""
    cfg, jmodel, params, tmodel = pair
    requests = request_list(cfg, (50, 66, 58, 73, 54))
    treq = [r + (TS.SamplingParams(*k),) for r, k in zip(requests,
                                                         SAMPLING)]
    outs = []
    for slots in (1, 3):
        cfg_s = TS.ServeConfig(**dict(SERVE, slots=slots), sampling=True)
        outs.append(TS.ContinuousBatcher(tmodel, cfg_s, pad_id=0,
                                         eos_id=EOS).generate_all(treq))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    greedy = TS.ContinuousBatcher(tmodel, TS.ServeConfig(**SERVE), pad_id=0,
                                  eos_id=EOS).generate_all(requests)
    np.testing.assert_array_equal(outs[0][1], greedy[1])


def test_continuous_batcher_rejects(pair):
    _, _, _, tmodel = pair
    with pytest.raises(ValueError, match="greedy-exact"):
        TS.ContinuousBatcher(tmodel, TS.ServeConfig(speculate=2,
                                                    sampling=True))
    b = TS.ContinuousBatcher(tmodel, TS.ServeConfig(**SERVE))
    ids, tiles = request_list(tmodel.cfg, (50,))[0]
    with pytest.raises(ValueError, match="sampling=True"):
        b.generate_all([(ids, tiles, TS.SamplingParams(temperature=1.0))])
    with pytest.raises(ValueError, match="max_new_tokens"):
        b.generate_all([(ids, tiles, 99)])
