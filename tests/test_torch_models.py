"""Port model stack (multi_spatialmllm_tpu_torch.models) against the JAX
package at the `tiny` config in float32: the same Flax-initialised
weights, moved with `models/convert.py`, and the same numpy inputs must
give the same ViT features, LLM logits, MLLM logits and prefill kv rows
within atol 1e-4 (f32, other reduction orders). The JAX side takes its
CPU reference paths (XLA attention)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_spatialmllm_tpu.models import llm as JL
from multi_spatialmllm_tpu.models import mllm as JM
from multi_spatialmllm_tpu.models import vit as JV
from multi_spatialmllm_tpu_torch.models import llm as TL
from multi_spatialmllm_tpu_torch.models import mllm as TM
from multi_spatialmllm_tpu_torch.models.convert import (
    jax_params_to_state_dict,
)

ATOL = 1e-4


def jax_tiny_f32():
    cfg = JM.tiny_config()
    return dataclasses.replace(
        cfg, vit=dataclasses.replace(cfg.vit, dtype="float32"),
        llm=dataclasses.replace(cfg.llm, dtype="float32"))


def make_inputs(cfg, seed, seq_len, n_tiles=1, batch=1):
    """Prompt ids with one tile's worth of IMG_CONTEXT slots per tile
    right after BOS, and normal tiles, all from numpy."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(10, cfg.llm.vocab_size,
                       size=(batch, seq_len)).astype(np.int32)
    ids[:, 1:1 + n_tiles * cfg.tokens_per_tile] = cfg.img_context_id
    tiles = rng.standard_normal(
        (batch, n_tiles, cfg.vit.image_size, cfg.vit.image_size, 3)
    ).astype(np.float32)
    return ids, tiles


@pytest.fixture(scope="module")
def pair():
    """(JAX cfg, JAX model, JAX params, port model) with equal weights."""
    cfg = jax_tiny_f32()
    jmodel = JM.MultiFrameMLLM(cfg)
    ids, tiles = make_inputs(cfg, 0, 48)
    params = jax.jit(jmodel.init)(
        jax.random.key(0), jnp.asarray(ids), jnp.asarray(tiles))
    tmodel = TM.MultiFrameMLLM(TM.with_dtype(TM.tiny_config(), "float32"))
    tmodel.load_state_dict(jax_params_to_state_dict(params, cfg))
    tmodel.eval()
    return cfg, jmodel, params, tmodel


def test_configs_match_jax():
    for jfn, tfn in ((JM.tiny_config, TM.tiny_config),
                     (JM.bench_1chip_config, TM.bench_1chip_config),
                     (JM.flagship_config, TM.flagship_config),
                     (JM.tiny_moe_config, TM.tiny_moe_config),
                     (lambda: JM.bench_1chip_moe_config(4, "ragged",
                                                        "pallas"),
                      lambda: TM.bench_1chip_moe_config(4, "ragged",
                                                        "pallas"))):
        jc, tc = jfn(), tfn()
        name = tfn.__name__
        for tower in ("vit", "llm"):
            tfields = dataclasses.asdict(getattr(tc, tower))
            jfields = dataclasses.asdict(getattr(jc, tower))
            assert {k: jfields[k] for k in tfields} == tfields, (name, tower)
        assert tc.tokens_per_tile == jc.tokens_per_tile
        assert tc.img_context_id == jc.img_context_id


def test_rope_and_pixel_shuffle_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 8, 16)).astype(np.float32)
    pos = np.stack([np.arange(8), np.arange(5, 13)]).astype(np.int32)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    got = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    f = rng.standard_normal((2, 16, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        TM.pixel_shuffle(torch.from_numpy(f), 4, 2).numpy(),
        np.asarray(JM.pixel_shuffle(jnp.asarray(f), 4, 2)))


def test_vit_matches_jax(pair):
    cfg, _, params, tmodel = pair
    tiles = np.random.default_rng(2).standard_normal(
        (3, cfg.vit.image_size, cfg.vit.image_size, 3)).astype(np.float32)
    want = JV.VisionTransformer(cfg.vit).apply(
        {"params": params["params"]["vision"]}, jnp.asarray(tiles))
    with torch.no_grad():
        got = tmodel.vision(torch.from_numpy(tiles))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_llm_logits_match_jax(pair):
    cfg, _, params, tmodel = pair
    ids = np.random.default_rng(3).integers(
        0, cfg.llm.vocab_size, size=(2, 40)).astype(np.int32)
    want = JL.DecoderLM(cfg.llm).apply(
        {"params": params["params"]["llm"]}, jnp.asarray(ids))
    ids_t = torch.from_numpy(ids).long()
    pos = torch.arange(40).expand(2, 40)
    with torch.no_grad():
        got, _ = tmodel.llm(tmodel.llm.embed(ids_t), pos)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("n_tiles", [1, 2])
def test_mllm_forward_matches_jax(pair, n_tiles):
    cfg, jmodel, params, tmodel = pair
    ids, tiles = make_inputs(cfg, 4 + n_tiles, 64, n_tiles=n_tiles)
    want = jmodel.apply(params, jnp.asarray(ids), jnp.asarray(tiles))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(ids).long(), torch.from_numpy(tiles))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_mllm_prefill_matches_jax(pair):
    """Bucketed prefill with right padding: logits up to the true length
    and the kv rows written to the cache match JAX's `prefill`."""
    cfg, jmodel, params, tmodel = pair
    ids, tiles = make_inputs(cfg, 7, 64)
    true_len = 50
    ids[:, true_len:] = 0                       # right padding
    caches = JL.init_cache(cfg.llm, 1, 64)
    logits_j, caches_j = jmodel.apply(
        params, jnp.asarray(ids), jnp.asarray(tiles), caches,
        jnp.asarray(true_len), method=JM.MultiFrameMLLM.prefill)
    with torch.no_grad():
        logits_t, kvs = tmodel.prefill(torch.from_numpy(ids).long(),
                                       torch.from_numpy(tiles))
    np.testing.assert_allclose(logits_t[:, :true_len].numpy(),
                               np.asarray(logits_j)[:, :true_len], atol=ATOL)
    for (k, v), cj in zip(kvs, caches_j):
        np.testing.assert_allclose(k.numpy(), np.asarray(cj["k"]), atol=ATOL)
        np.testing.assert_allclose(v.numpy(), np.asarray(cj["v"]), atol=ATOL)


def test_random_init_is_seeded_and_finite():
    cfg = TM.with_dtype(TM.tiny_config(), "float32")
    a, b = TM.MultiFrameMLLM(cfg), TM.MultiFrameMLLM(cfg)
    TM.init_random_weights(a, seed=3)
    TM.init_random_weights(b, seed=3)
    for (n, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), n
        assert torch.isfinite(pa).all(), n
    ids, tiles = make_inputs(cfg, 8, 32)
    with torch.no_grad():
        logits = a(torch.from_numpy(ids).long(), torch.from_numpy(tiles))
    assert logits.shape == (1, 32, cfg.llm.vocab_size)
    assert torch.isfinite(logits).all()


def _old_init_random_weights(model, seed):
    """`init_random_weights` as it was before the MoE tables: std
    prod(shape[1:])^-1/2 for every matrix and convolution."""
    import math

    device = next(model.parameters()).device
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            module = name.rsplit(".", 2)[-2] if name.count(".") >= 1 else ""
            if "norm" in module:
                p.fill_(1.0 if leaf == "weight" else 0.0)
            elif leaf == "bias" or leaf == "cls_token":
                p.zero_()
            elif module in ("embed",) or leaf == "pos_embed":
                p.normal_(0.0, 0.02, generator=gen)
            else:
                p.normal_(0.0, math.prod(p.shape[1:]) ** -0.5,
                          generator=gen)


def test_random_init_keeps_the_dense_draws():
    """The fan-in repair leaves a dense model's seeded weights as they
    were: the same seed gives the same tensors."""
    cfg = TM.with_dtype(TM.tiny_config(), "float32")
    a, b = TM.MultiFrameMLLM(cfg), TM.MultiFrameMLLM(cfg)
    TM.init_random_weights(a, seed=11)
    _old_init_random_weights(b, seed=11)
    for (n, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), n


def test_random_init_gives_moe_tables_their_fan_in():
    """router [D, E] and wi_gate/wi_up [E, D, F] draw with std D^-1/2, wo
    [E, F, D] with F^-1/2 (not prod(shape[1:])^-1/2)."""
    cfg = TM.with_dtype(TM.tiny_moe_config(), "float32")
    model = TM.MultiFrameMLLM(cfg)
    TM.init_random_weights(model, seed=0)
    d, f = cfg.llm.hidden_size, cfg.llm.ffn_size
    moe = model.llm.layers[0].moe
    for p, fan in ((moe.router, d), (moe.wi_gate, d), (moe.wi_up, d),
                   (moe.wo, f)):
        assert p.std().item() == pytest.approx(fan ** -0.5, rel=0.1)
    assert TM.fan_in(moe, "router", moe.router) == d
    assert TM.fan_in(moe, "wo", moe.wo) == f


@pytest.fixture(scope="module", params=["einsum", "ragged"])
def moe_pair(request):
    """(JAX cfg, JAX model, JAX params, port model) for tiny MoE in f32;
    the ragged impl with moe_kernel "pallas" on both sides (megablox in
    interpret mode on the JAX side)."""
    kw = {} if request.param == "einsum" else dict(moe_impl="ragged",
                                                    moe_kernel="pallas")
    jbase, tbase = JM.tiny_moe_config(), TM.tiny_moe_config()
    jcfg = dataclasses.replace(
        jbase, vit=dataclasses.replace(jbase.vit, dtype="float32"),
        llm=dataclasses.replace(jbase.llm, dtype="float32", **kw))
    tcfg = dataclasses.replace(
        tbase, vit=dataclasses.replace(tbase.vit, dtype="float32"),
        llm=dataclasses.replace(tbase.llm, dtype="float32", **kw))
    jmodel = JM.MultiFrameMLLM(jcfg)
    ids, tiles = make_inputs(jcfg, 0, 48)
    params = jax.jit(jmodel.init)(
        jax.random.key(1), jnp.asarray(ids), jnp.asarray(tiles))
    tmodel = TM.MultiFrameMLLM(tcfg)
    tmodel.load_state_dict(jax_params_to_state_dict(params, jcfg))
    tmodel.eval()
    return jcfg, jmodel, params, tmodel


def test_moe_mllm_forward_and_prefill_match_jax(moe_pair):
    """Tiny MoE through `convert.py`: training-forward logits and the
    prefill's logits and kv rows (inference routing) match JAX's."""
    cfg, jmodel, params, tmodel = moe_pair
    ids, tiles = make_inputs(cfg, 9, 64)
    want = jmodel.apply(params, jnp.asarray(ids), jnp.asarray(tiles))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(ids).long(), torch.from_numpy(tiles))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    caches = JL.init_cache(cfg.llm, 1, 64)
    logits_j, caches_j = jmodel.apply(
        params, jnp.asarray(ids), jnp.asarray(tiles), caches,
        jnp.asarray(64), method=JM.MultiFrameMLLM.prefill)
    with torch.no_grad():
        logits_t, kvs = tmodel.prefill(torch.from_numpy(ids).long(),
                                       torch.from_numpy(tiles))
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j),
                               atol=ATOL)
    for (k, v), cj in zip(kvs, caches_j):
        np.testing.assert_allclose(k.numpy(), np.asarray(cj["k"]), atol=ATOL)
        np.testing.assert_allclose(v.numpy(), np.asarray(cj["v"]), atol=ATOL)
