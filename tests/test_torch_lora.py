"""LoRA in the port (parallel/lora.py, parallel/lora_serving.py, the
adapter deltas of models/llm.py and PagedBatcher(adapters=...)) against the
JAX package, at the tiny config in float32.

Bounds:
- `init_lora`: the same weights in the same order (JAX's flatten order,
  dict keys sorted), the same shapes, B zero; A within A_ULP float32 ulp of
  JAX's (models/prng.erfinv takes torch's log1p, not XLA's; JAX's A is
  float64 here, where x64 is on, and is compared after rounding to
  float32: 4 ulp measured);
- a zero B leaves every merged weight equal to the base bit for bit;
- `merge_lora` equals JAX's bit for bit on float32 adapters: torch's CPU
  matmul and XLA's CPU dot both accumulate the rank with fused
  multiply-adds in order where fan_out is a multiple of 64, as every tiny
  weight's is;
- three `make_lora_train_step` steps from JAX's adapters (cast to
  float32): loss and grad norm within STEP_REL relative, adapters within
  ADAPTER_ATOL of JAX's, dense and MoE (ragged, K8's plain version; the
  expert tables frozen);
- mixed-adapter PagedBatcher tokens equal to JAX's PagedBatcher (base and
  two adapters with non-zero B, native and int8 kv, the prefix cache,
  chunked prefill and speculation), a difference admitted only at a near
  tie (MARGIN) of the adapted model's logits, as tests/test_torch_generate
  admits one.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_spatialmllm_tpu.models import mllm as JM
from multi_spatialmllm_tpu.models import paged_kv as JK
from multi_spatialmllm_tpu.parallel import lora as JL
from multi_spatialmllm_tpu.parallel import lora_serving as JLS
from multi_spatialmllm_tpu.parallel import train as JT
from multi_spatialmllm_tpu.parallel.mesh import make_mesh
from multi_spatialmllm_tpu_torch.models import mllm as TM
from multi_spatialmllm_tpu_torch.models import paged_kv as TK
from multi_spatialmllm_tpu_torch.models import prng
from multi_spatialmllm_tpu_torch.models.convert import (
    jax_lora_to_port,
    jax_params_to_state_dict,
)
from multi_spatialmllm_tpu_torch.parallel import lora as TL
from multi_spatialmllm_tpu_torch.parallel import lora_serving as TLS
from multi_spatialmllm_tpu_torch.parallel import train as PT
from test_torch_generate import (
    EOS,
    MARGIN,
    first_difference,
    make_pair,
    one_torch_thread,  # noqa: F401 (an autouse fixture)
    request_list,
)
from test_torch_training import (
    jax_tiny_f32,
    jax_tiny_moe_f32,
    make_batch,
    port_tiny_moe_f32,
    to_torch,
)

A_ULP = 4
STEP_REL = 1e-5
ADAPTER_ATOL = 1e-5
ALL = tuple(JL._FAN_IN_DIMS)
SERVE_TARGETS = ("wq", "wk", "wv", "wo", "gate", "up", "down")


def _f32(tree):
    return jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float32),
                                  tree)


@pytest.fixture(scope="module")
def dense():
    cfg = jax_tiny_f32()
    jmodel = JM.MultiFrameMLLM(cfg)
    b = make_batch(cfg, False, 0)
    params = jax.jit(jmodel.init)(jax.random.key(0),
                                  jnp.asarray(b["input_ids"]),
                                  jnp.asarray(b["tiles"]))
    return cfg, jmodel, params


def _port(cfg, params, tcfg=None):
    tcfg = tcfg or TM.with_dtype(TM.tiny_config(), "float32")
    model = TM.MultiFrameMLLM(tcfg, param_dtype=torch.float32)
    model.load_state_dict(jax_params_to_state_dict(params, cfg))
    return model


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max())


@pytest.mark.parametrize("targets", [("wq", "wk", "wv", "wo"), ALL],
                         ids=["default", "all"])
@pytest.mark.parametrize("seed", [1, 7])
def test_init_lora_order_shapes_and_a(dense, targets, seed):
    cfg, _, params = dense
    lc = JL.LoRAConfig(rank=4, targets=targets)
    want = jax_lora_to_port(JL.init_lora(params, lc, jax.random.key(seed)))
    got = TL.init_lora(_port(cfg, params),
                       TL.LoRAConfig(rank=4, targets=targets),
                       prng.key(seed))
    assert list(got) == list(want)
    # JAX's flatten order: llm before projector before vision
    assert list(got)[0].startswith("llm.layers.0.")
    for k in got:
        assert got[k]["a"].shape == want[k]["a"].shape
        assert got[k]["b"].shape == want[k]["b"].shape
        assert got[k]["a"].dtype == got[k]["b"].dtype == torch.float32
        assert not got[k]["b"].any()
        assert _ulps(got[k]["a"].numpy(),
                     want[k]["a"].float().numpy()) <= A_ULP, k
    assert TL.lora_param_count(got) == JL.lora_param_count(
        JL.init_lora(params, lc, jax.random.key(seed)))


def test_layer_key_order_past_ten():
    """`layer_10` sorts before `layer_2`, as JAX's flatten sorts keys."""
    cfg = TM.tiny_config()
    cfg = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm,
                                                           num_layers=11))
    names = [n for n, _, _ in TL.adapted_weights(
        TM.MultiFrameMLLM(cfg), TL.LoRAConfig(targets=("wq",)))]
    assert names[:3] == ["llm.layers.0.attn.wq.weight",
                         "llm.layers.1.attn.wq.weight",
                         "llm.layers.10.attn.wq.weight"]


def _random_b(lora: dict, seed: int, scale: float = 0.05) -> dict:
    """A JAX adapter tree with float32 A and a seeded non-zero B."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.asarray(
            rng.standard_normal(x.shape) * scale if p[-1].key == "b"
            else x, jnp.float32), lora)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_zero_b_merge_is_the_base(dense, dtype):
    cfg, _, params = dense
    model = _port(cfg, params)
    state = {k: v.to(getattr(torch, dtype)) if v.dim() > 1 else v
             for k, v in model.state_dict().items()}
    lc = TL.LoRAConfig(rank=4, targets=ALL)
    merged = TL.merge_lora(state, TL.init_lora(model, lc, prng.key(3)), lc)
    for k, v in state.items():
        assert merged[k].dtype == v.dtype and torch.equal(merged[k], v), k


def test_merged_swaps_in_merge_lora_and_restores(dense):
    """Inside `merged` every adapted weight is `merge_lora`'s tensor and no
    `Linear` merges at its forward (the adapters attached for training are
    detached), so the logits equal those of the attached adapters merged
    at each forward; on exit the base parameters (the same tensors, their
    bits unchanged) and the attached adapters are back."""
    cfg, _, params = dense
    model = _port(cfg, params)
    lc = TL.LoRAConfig(rank=4, targets=ALL)
    lora = jax_lora_to_port(_random_b(_f32(JL.init_lora(
        params, JL.LoRAConfig(rank=4, targets=ALL), jax.random.key(2))), 9))
    base = {k: v.clone() for k, v in model.state_dict().items()}
    params_before = dict(model.named_parameters())
    want = TL.merge_lora(base, lora, lc)
    TL.attach(model, lora, lc.scale)
    adapters = {n: m.adapter for n, m in model.named_modules()
                if hasattr(m, "adapter")}
    b = make_batch(cfg, False, 0)
    ids = torch.from_numpy(np.asarray(b["input_ids"])).long()
    tiles = torch.from_numpy(np.asarray(b["tiles"]))
    with torch.no_grad():
        attached = model(ids, tiles)
        with TL.merged(model, lora, lc):
            assert all(m.adapter is None for n, m in model.named_modules()
                       if n in adapters)
            for k, v in model.state_dict().items():
                assert torch.equal(v, want[k]), k
            inside = model(ids, tiles)
    torch.testing.assert_close(inside, attached, rtol=1e-5, atol=1e-5)
    assert dict(model.named_parameters()).keys() == params_before.keys()
    for k, p in model.named_parameters():
        assert p is params_before[k] and torch.equal(p, base[k]), k
    assert {n: m.adapter for n, m in model.named_modules()
            if hasattr(m, "adapter")} == adapters
    with TL.merged(model, None, None):
        assert all(p is params_before[k]
                   for k, p in model.named_parameters())


def test_merge_lora_equals_jax(dense):
    cfg, _, params = dense
    lc = JL.LoRAConfig(rank=4, targets=ALL)
    jlora = _random_b(_f32(JL.init_lora(params, lc, jax.random.key(2))), 9)
    want = jax_params_to_state_dict(JL.merge_lora(params, jlora, lc), cfg)
    base = jax_params_to_state_dict(params, cfg)
    got = TL.merge_lora(base, jax_lora_to_port(jlora),
                        TL.LoRAConfig(rank=4, targets=ALL))
    changed = 0
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k
        changed += not torch.equal(got[k], base[k])
    assert changed == len(jax_lora_to_port(jlora))


def _steps_match(jcfg, jmodel, params, tmodel, targets, batches):
    lc = JL.LoRAConfig(rank=4, targets=targets)
    tlc = TL.LoRAConfig(rank=4, targets=targets)
    jlora = _f32(JL.init_lora(params, lc, jax.random.key(4)))
    tlora = jax_lora_to_port(jlora)
    train_cfg = dict(learning_rate=1e-3, warmup_steps=1,
                     total_steps=len(batches))
    tx = JT.make_optimizer(JT.TrainConfig(**train_cfg))
    mesh = make_mesh(n_data=1, devices=jax.devices()[:1])
    jstep = JL.make_lora_train_step(jmodel, tx, mesh, lc)
    jopt = tx.init(jlora)
    opt = PT.AdamW(TL.lora_named_tensors(tlora),
                   PT.TrainConfig(**train_cfg))
    step = TL.make_lora_train_step(tmodel, opt, tlc)
    base = {k: v.clone() for k, v in tmodel.state_dict().items()}
    for i, batch in enumerate(batches):
        jlora, jopt, jm = jstep(jlora, jopt, params,
                                {k: jnp.asarray(v) for k, v in batch.items()})
        tm = step(to_torch(batch))
        for key in ("loss", "grad_norm"):
            assert abs(float(tm[key]) - float(jm[key])) <= \
                STEP_REL * abs(float(jm[key])), (i, key, float(tm[key]),
                                                 float(jm[key]))
    want = jax_lora_to_port(jlora)
    for k, ad in tlora.items():
        for part in ("a", "b"):
            err = float((ad[part].detach() - want[k][part]).abs().max())
            assert err <= ADAPTER_ATOL, (k, part, err)
    assert any(float(ad["b"].detach().abs().max()) > 0
               for ad in tlora.values())
    # the base is frozen and untouched, and keeps no gradient
    for k, v in tmodel.state_dict().items():
        assert torch.equal(v, base[k]), k
    assert all(p.grad is None and not p.requires_grad
               for p in tmodel.parameters())


@pytest.mark.parametrize("targets", [("wq", "wk", "wv", "wo"), ALL],
                         ids=["default", "all"])
def test_lora_train_steps_match_jax(dense, targets):
    cfg, jmodel, params = dense
    _steps_match(cfg, jmodel, params, _port(cfg, params), targets,
                 [make_batch(cfg, True, 30 + i) for i in range(3)])


def test_moe_lora_train_steps_match_jax():
    """The ragged MoE (K8's plain version here) with its expert tables
    frozen: attention adapters only, as the CLI's note says."""
    kw = dict(moe_impl="ragged", moe_kernel="pallas")
    jcfg, tcfg = jax_tiny_moe_f32(**kw), port_tiny_moe_f32(**kw)
    jmodel = JM.MultiFrameMLLM(jcfg)
    b0 = make_batch(jcfg, True, 40)
    params = jax.jit(jmodel.init)(jax.random.key(5),
                                  jnp.asarray(b0["input_ids"]),
                                  jnp.asarray(b0["tiles"]))
    tmodel = TM.MultiFrameMLLM(tcfg, param_dtype=torch.float32)
    tmodel.load_state_dict(jax_params_to_state_dict(params, jcfg))
    _steps_match(jcfg, jmodel, params, tmodel, ("wq", "wk", "wv", "wo"),
                 [make_batch(jcfg, True, 41 + i) for i in range(3)])


def test_remat_recomputes_the_merge(dense):
    """Whole-layer remat gives the same loss and adapter gradients."""
    cfg, _, params = dense
    lc = TL.LoRAConfig(rank=4, targets=ALL)
    out = []
    for remat in (False, True):
        tcfg = TM.with_dtype(TM.tiny_config(), "float32")
        tcfg = dataclasses.replace(
            tcfg, llm=dataclasses.replace(tcfg.llm, remat=remat))
        model = _port(cfg, params, tcfg)
        lora = jax_lora_to_port(_random_b(_f32(JL.init_lora(
            params, JL.LoRAConfig(rank=4, targets=ALL),
            jax.random.key(6))), 3))
        opt = PT.AdamW(TL.lora_named_tensors(lora), PT.TrainConfig(
            learning_rate=1e-3, warmup_steps=1, total_steps=2))
        m = TL.make_lora_train_step(model, opt, lc)(
            to_torch(make_batch(cfg, True, 50)))
        out.append((float(m["loss"]), float(m["grad_norm"]),
                    [t.clone() for t in opt.mu]))
    assert out[0][:2] == pytest.approx(out[1][:2], rel=1e-6)
    for a, b in zip(out[0][2], out[1][2]):
        assert torch.allclose(a, b, rtol=1e-5, atol=1e-9)


# ---- serving ---------------------------------------------------------------

BASE = dict(slots=3, page_size=16, num_pages=64, max_prompt_len=128,
            max_new_tokens=8, chunk=2, length_bucket=64)
LENS = (50, 66, 58, 73, 54, 61)
NAMES = (None, "spatial", "depth")


@pytest.fixture(scope="module")
def served():
    """(pair, JAX adapters, port adapters, requests with adapter names,
    the port model merged with each adapter)."""
    pair = make_pair()
    cfg, _, params, tmodel = pair
    lc = JL.LoRAConfig(rank=4, targets=SERVE_TARGETS)
    jads = {n: _random_b(_f32(JL.init_lora(params, lc, jax.random.key(i))),
                         20 + i, 0.2)
            for i, n in enumerate(NAMES[1:])}
    tads = {n: jax_lora_to_port(t) for n, t in jads.items()}
    reqs = request_list(cfg, LENS, shared_head=True)
    tagged = [r + ((NAMES[i % 3],) if NAMES[i % 3] else ())
              for i, r in enumerate(reqs)]
    tlc = TL.LoRAConfig(rank=4, targets=SERVE_TARGETS)
    merged = {None: tmodel}
    for n, ad in tads.items():
        m = copy.deepcopy(tmodel)
        m.load_state_dict(TL.merge_lora(tmodel.state_dict(), ad, tlc))
        merged[n] = m
    return pair, jads, tads, tagged, merged


def _adapter_of(req):
    return next((x for x in req[2:] if isinstance(x, str)), None)


def _assert_same(merged, requests, got, want):
    """Identical tokens, or a first difference at a near tie of the
    request's adapted (merged) model."""
    for req, g, w in zip(requests, got, want):
        k = first_difference(g, w)
        if k is None:
            continue
        seq = np.concatenate([np.asarray(req[0]), np.asarray(g[:k])])
        with torch.no_grad():
            logits = merged[_adapter_of(req)](
                torch.from_numpy(seq.astype(np.int64))[None],
                torch.as_tensor(np.asarray(req[1]))[None])[0, -1]
        top = torch.topk(logits, 2).values
        assert float(top[0] - top[1]) < MARGIN, (k, g, w)


SERVE_OPTIONS = [dict(), dict(prefix_cache=True), dict(prefill_chunk=16),
                 dict(speculate=3),
                 dict(prefix_cache=True, prefill_chunk=16, vision_cache=2,
                      speculate=2),
                 dict(kv_dtype="int8"),
                 dict(kv_dtype="int8", prefix_cache=True, prefill_chunk=16,
                      speculate=2)]


@pytest.mark.parametrize("kw", SERVE_OPTIONS, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()) or "plain")
def test_mixed_adapter_batcher_matches_jax(served, kw):
    (cfg, jmodel, params, tmodel), jads, tads, reqs, merged = served
    lc = JL.LoRAConfig(rank=4, targets=SERVE_TARGETS)
    jb = JK.PagedBatcher(jmodel, params, JK.PagedConfig(**BASE, **kw),
                         pad_id=0, eos_id=EOS, adapters=jads, lora_config=lc)
    want = jb.generate_all(reqs)
    tb = TK.PagedBatcher(tmodel, TK.PagedConfig(**BASE, **kw), pad_id=0,
                         eos_id=EOS, adapters=tads,
                         lora_config=TL.LoRAConfig(rank=4,
                                                   targets=SERVE_TARGETS))
    got = tb.generate_all(reqs)
    _assert_same(merged, reqs, got, want)
    for key, n in jb.stats.items():
        assert tb.stats[key] == n, (key, tb.stats, jb.stats)


def test_adapters_change_tokens_and_base_rows_stay_base(served):
    """An adapter row's tokens equal its merged model's own batcher (a
    near tie aside), and base rows in a mixed batch equal an adapter-free
    batcher's exactly."""
    (cfg, _, _, tmodel), _, tads, reqs, merged = served
    tlc = TL.LoRAConfig(rank=4, targets=SERVE_TARGETS)
    mixed = TK.PagedBatcher(tmodel, TK.PagedConfig(**BASE), pad_id=0,
                            eos_id=EOS, adapters=tads,
                            lora_config=tlc).generate_all(reqs)
    plain = [r[:2] for r in reqs]
    alone = {}
    for name, model in merged.items():
        alone[name] = TK.PagedBatcher(model, TK.PagedConfig(**BASE), pad_id=0,
                                      eos_id=EOS).generate_all(plain)
        rows = [i for i, r in enumerate(reqs) if _adapter_of(r) == name]
        _assert_same(merged, [reqs[i] for i in rows],
                     [mixed[i] for i in rows],
                     [alone[name][i] for i in rows])
        if name is None:
            for i in rows:
                assert np.array_equal(mixed[i], alone[name][i])
    # the adapters do change what is served
    for i, r in enumerate(reqs):
        if _adapter_of(r) is not None:
            assert not np.array_equal(mixed[i], alone[None][i]), i


def test_prefix_pages_never_shared_across_adapters(served):
    (cfg, _, _, tmodel), _, tads, reqs, _ = served
    tlc = TL.LoRAConfig(rank=4, targets=SERVE_TARGETS)
    ids, tiles = reqs[0][:2]
    prompts = [(ids, tiles), (ids, tiles, "spatial"), (ids, tiles, "depth"),
               (ids, tiles, "spatial"), (ids, tiles)]
    b = TK.PagedBatcher(tmodel, TK.PagedConfig(**{**BASE, "slots": 1},
                                               prefix_cache=True),
                        pad_id=0, eos_id=EOS, adapters=tads,
                        lora_config=tlc)
    b.generate_all(prompts)
    full = len(ids) // BASE["page_size"]
    # the repeats of "spatial" and of the base reuse their pages; nothing
    # else does
    assert b.stats["prefill_resumed"] == 2
    assert b.stats["pages_reused"] == 2 * min(full, (len(ids) - 1)
                                              // BASE["page_size"])
    assert len(b.prefix_pages) == 3 * full
    assert len(set(b.prefix_pages.values())) == 3 * full


def test_stack_adapters_refusals(dense):
    """Each refusal of JAX `stack_adapters` is a refusal here too."""
    cfg, _, params = dense
    model = _port(cfg, params)

    def both(jads, tads, lc, tlc, n_layers=2):
        with pytest.raises(ValueError) as want:
            JLS.stack_adapters(jads, n_layers, lc)
        with pytest.raises(ValueError) as got:
            TLS.stack_adapters(tads, n_layers, tlc)
        return str(want.value), str(got.value)

    attn = JL.LoRAConfig(rank=4)
    ja = JL.init_lora(params, attn, jax.random.key(0))
    ta = TL.init_lora(model, TL.LoRAConfig(rank=4), prng.key(0))
    w, g = both([ja], [ta], None, None)
    assert w == g
    for target in ("qkv", "lm_head", "fc1"):
        lc = JL.LoRAConfig(rank=4, targets=(target,))
        both([JL.init_lora(params, lc, jax.random.key(0))],
             [TL.init_lora(model, TL.LoRAConfig(rank=4, targets=(target,)),
                           prng.key(0))], lc, TL.LoRAConfig(
                 rank=4, targets=(target,)))
    w, g = both([ja], [ta], JL.LoRAConfig(rank=8), TL.LoRAConfig(rank=8))
    assert "!= cfg.rank 8" in w and "!= cfg.rank 8" in g
    jmore = JL.init_lora(params, JL.LoRAConfig(rank=4, targets=SERVE_TARGETS),
                         jax.random.key(1))
    tmore = TL.init_lora(model, TL.LoRAConfig(rank=4, targets=SERVE_TARGETS),
                         prng.key(1))
    both([ja, jmore], [ta, tmore], attn, TL.LoRAConfig(rank=4))
    with pytest.raises(ValueError, match="needs lora_config"):
        TK.PagedBatcher(model, adapters={"x": ta})
    tables = TLS.stack_adapters([ta, ta], 2, TL.LoRAConfig(rank=4))
    a0, b0 = tables["layers"][1]["wo"]
    assert a0.shape == (3, 128, 4) and b0.shape == (3, 4, 128)
    assert not a0[0].any() and torch.equal(a0[2], ta[
        "llm.layers.1.attn.wo.weight"]["a"])


def test_moe_refuses_mlp_adapters_and_unknown_names(served):
    """A routed-MoE FFN raises on gate/up/down tables with the JAX
    message; an unknown adapter name raises at enqueue."""
    (cfg, _, _, tmodel), _, tads, reqs, _ = served
    moe = TM.MultiFrameMLLM(port_tiny_moe_f32())
    TM.init_random_weights(moe, 0)
    b = TK.PagedBatcher(moe, TK.PagedConfig(**BASE), pad_id=0, eos_id=EOS,
                        adapters=tads, lora_config=TL.LoRAConfig(
                            rank=4, targets=SERVE_TARGETS))
    with pytest.raises(ValueError, match="routed MoE"):
        b.generate_all([reqs[1]])
    b = TK.PagedBatcher(tmodel, TK.PagedConfig(**BASE), pad_id=0,
                        eos_id=EOS, adapters=tads,
                        lora_config=TL.LoRAConfig(rank=4,
                                                  targets=SERVE_TARGETS))
    with pytest.raises(ValueError, match="unknown adapter 'nope'"):
        b.generate_all([reqs[0][:2] + ("nope",)])
