"""Tensor-parallel serving in the port: the tiny float32 model put on a
(1 data x 2 model) mesh (parallel/sharding.shard_model), two gloo
processes on the CPU started once (`dryrun.run_world`), against the JAX
package on one device with the same weights (models/convert.py) and
requests.

- Prefill and 6 teacher-forced decode steps (tests/test_tp_serving.py's):
  the logits within FORCED_ATOL 1e-4 of JAX's single-device program.
- Batched greedy tokens and the paged batcher's tokens (prefix cache,
  chunked prefill, vision cache and speculation at once, over native
  pools) equal JAX's single-device tokens; the same without speculation
  over int8 pools (K7's int8 path on each process's half of the kv heads)
  equal the port's single-device batcher's (tests/test_torch_paged_options.py
  holds that to JAX's); a near tie admitted as tests/test_torch_generate.py
  states it (MARGIN 1e-4 on the port's single-device logits).
- Multi-LoRA plus sampled rows (base, adapter, sampled, adapter and
  sampled, in one batch) equal the port's single-device batcher's, and
  the two processes' tokens are equal.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_spatialmllm_tpu.models import generate as JG
from multi_spatialmllm_tpu.models import paged_kv as JK
from multi_spatialmllm_tpu.models.llm import init_cache as j_init_cache
from multi_spatialmllm_tpu_torch.dryrun import run_world
from multi_spatialmllm_tpu_torch.models import paged_kv as TK
from multi_spatialmllm_tpu_torch.parallel import lora as TL
from test_torch_generate import (
    assert_same_greedy,
    batch_prompts,
    make_pair,
    request_list,
    trim,
)
from torch_mesh_ranks import (
    SERVE_BASE,
    SERVE_OPTIONS,
    serve_lora_run,
    serve_model,
)

FORCED_ATOL = 1e-4
LENS = (50, 66, 58, 73, 54)
PROMPT_LENS = [40, 48]


def _adapters(model):
    """Adapters on wq/wv/wo of the full model with A drawn by init_lora and
    B seeded normal (so that an adapter changes the tokens)."""
    from multi_spatialmllm_tpu_torch.models import prng

    lcfg = TL.LoRAConfig(rank=4, alpha=8.0, targets=("wq", "wv", "wo"))
    ads = TL.init_lora(model, lcfg, prng.key(11))
    rng = np.random.default_rng(12)
    for ad in ads.values():
        ad["b"] = torch.from_numpy(
            0.05 * rng.standard_normal(ad["b"].shape).astype(np.float32))
    return ads


def _jax_side(cfg, jmodel, params, ids, tiles, requests):
    """JAX's one-device forced logits, batched greedy tokens and paged
    tokens with every option over native pools."""
    lens = jnp.asarray(PROMPT_LENS, jnp.int32)
    caches = j_init_cache(cfg.llm, 2, 64)
    logits, caches = JG._prefill_fn(jmodel)(params, jnp.asarray(ids),
                                            jnp.asarray(tiles), caches, lens)
    forced = [np.asarray(jnp.take_along_axis(
        logits, (lens - 1)[:, None, None], axis=1)[:, 0], np.float32)]
    pos = lens
    for t in range(6):
        tok = jnp.asarray([[7 + t], [11 + t]], jnp.int32)
        lg, caches = JG.decode_logits(jmodel, params, tok, pos, caches)
        forced.append(np.asarray(lg, np.float32))
        pos = pos + 1
    b = JK.PagedBatcher(jmodel, params,
                        JK.PagedConfig(**SERVE_BASE, **SERVE_OPTIONS["native"]),
                        pad_id=0, eos_id=2)
    return {"forced": forced, "native": b.generate_all(requests),
            "greedy": np.asarray(JG.greedy_generate_batched(
                jmodel, params, ids, tiles, lens, max_new_tokens=8,
                eos_id=2))}


@pytest.fixture(scope="module")
def served():
    """(pair, prompts, requests, the world's results, JAX's results, the
    port's single-device multi-LoRA tokens)."""
    pair = make_pair()
    cfg, jmodel, params, tmodel = pair
    ids, tiles = batch_prompts(cfg, b=2, t=48)
    requests = request_list(cfg, LENS, shared_head=True)
    adapters = _adapters(tmodel)
    with ThreadPoolExecutor(1) as pool:
        world = pool.submit(
            run_world, 2, "torch_mesh_ranks:serve_rank",
            (tmodel.cfg, tmodel.state_dict(), ids, tiles, PROMPT_LENS,
             requests, adapters), device="cpu", timeout=600)
        jax_out = _jax_side(cfg, jmodel, params, ids, tiles, requests)
        whole = serve_model(tmodel.cfg, tmodel.state_dict())
        single = serve_lora_run(whole, adapters, requests)
        single_int8 = TK.PagedBatcher(
            whole, TK.PagedConfig(**SERVE_BASE, **SERVE_OPTIONS["int8"]),
            pad_id=0, eos_id=2).generate_all(requests)
        return (pair, (ids, tiles), requests, world.result(),
                dict(jax_out, int8=single_int8), single)


def test_forced_decode_logits_match_jax_single_device(served):
    _, _, _, world, jax_out, _ = served
    for r in world:
        for got, want in zip(r["forced"], jax_out["forced"]):
            np.testing.assert_allclose(got.numpy(), want, atol=FORCED_ATOL,
                                       rtol=FORCED_ATOL)


def test_greedy_tokens_match_jax_single_device(served):
    (_, _, _, tmodel), (ids, tiles), _, world, jax_out, _ = served
    prompts = [(ids[r, :n], tiles[r]) for r, n in enumerate(PROMPT_LENS)]
    for r in world:
        assert_same_greedy(tmodel, prompts, trim(r["greedy"]),
                           trim(jax_out["greedy"]))


@pytest.mark.parametrize("option", list(SERVE_OPTIONS))
def test_paged_tokens_match_jax_single_device(served, option):
    """Native pools against JAX's one-device batcher; int8 pools against
    the port's one-device batcher (tests/test_torch_paged_options.py holds
    that one to JAX's with the same option)."""
    (_, _, _, tmodel), _, requests, world, want, _ = served
    for r in world:
        assert_same_greedy(tmodel, requests, r[option], want[option])
    assert world[0][option + "_stats"]["prefill_resumed"] >= 1


def test_multi_lora_sampled_rows_match_single_device(served):
    _, _, _, world, _, single = served
    for r in world:
        assert len(r["lora"]) == len(single)
        for got, want in zip(r["lora"], single):
            np.testing.assert_array_equal(got, want)


def test_tp_model_axis_needs_kv_heads_divisible():
    """`num_kv_heads % n_model` must be 0: each process holds whole kv
    heads."""
    from multi_spatialmllm_tpu_torch.models import mllm as TM
    from multi_spatialmllm_tpu_torch.parallel import sharding as TS

    cfg = TM.tiny_config()
    cfg = dataclasses.replace(cfg, llm=dataclasses.replace(
        cfg.llm, num_kv_heads=1))
    model = TM.MultiFrameMLLM(cfg, device="meta")
    mesh = type("Mesh", (), {"mesh_dim_names": ("data", "model"),
                             "size": lambda self, i: (1, 2)[i]})()
    with pytest.raises(ValueError, match="num_kv_heads = 1 does not divide"):
        TS._check_divisible(model, mesh)
