"""The bench train harness of the port held against the JAX package on the
CPU: utils/flops.py's counts equal JAX's, integer for integer, for the
tiny, bench, bench MoE and flagship configs; the peak table names the H100
and nothing else; `prng.randint` and `make_example_batch` draw JAX's ids
(bench.py's model path: x64 off, int32) and labels exactly and the tiles
within TILE_ULP; `make_chained_train_step` equals JAX's
`make_chained_train_step` (losses and params) and the port's own
`make_train_step` run as often on the same batch."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_spatialmllm_tpu.models import mllm as JM
from multi_spatialmllm_tpu.parallel import train as JT
from multi_spatialmllm_tpu.parallel.mesh import make_mesh
from multi_spatialmllm_tpu.utils import flops as JF
from multi_spatialmllm_tpu_torch.models import mllm as TM
from multi_spatialmllm_tpu_torch.models import prng
from multi_spatialmllm_tpu_torch.models.convert import (
    jax_params_to_state_dict,
)
from multi_spatialmllm_tpu_torch.parallel import train as PT
from multi_spatialmllm_tpu_torch.utils import flops as TF

# prng.normal's float32 erf_inv against XLA's (models/prng.py); measured 3
TILE_ULP = 4
REL = 1e-4          # f32 train steps against JAX (tests/test_torch_training)
CHAIN = 3
# each parameter's change over the chain against JAX's, relative in norm:
# measured 9.3e-3 on the ViT's qkv biases (the key part has a zero gradient
# up to rounding, which Adam's normalisation amplifies), <= 5.6e-4 on the
# rest; a wrong update direction or size is off by O(1)
UPDATE_REL = 2e-2

CONFIGS = {
    "tiny": (JM.tiny_config, TM.tiny_config),
    "bench": (JM.bench_1chip_config, TM.bench_1chip_config),
    "bench_moe": (lambda: JM.bench_1chip_moe_config(impl="ragged"),
                  lambda: TM.bench_1chip_moe_config(impl="ragged")),
    "flagship": (JM.flagship_config, TM.flagship_config),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_counts_equal_jax(name):
    jcfg, tcfg = (make() for make in CONFIGS[name])
    for b, s, tiles in ((1, 512, 2), (4, 2048, 2), (2, 4096, 6)):
        for fn, args in (("llm_fwd_flops", (b, s)),
                         ("mllm_fwd_flops", (b, s, tiles)),
                         ("mllm_train_flops", (b, s, tiles))):
            cfg = jcfg.llm if fn.startswith("llm") else jcfg
            tc = tcfg.llm if fn.startswith("llm") else tcfg
            want = getattr(JF, fn)(cfg, *args)
            got = getattr(TF, fn)(tc, *args)
            assert type(got) is int and got == want, (fn, args)
        assert TF.vit_fwd_flops(tcfg.vit, b * tiles) == \
            JF.vit_fwd_flops(jcfg.vit, b * tiles)
    assert TF.llm_matmul_params(tcfg.llm) == JF.llm_matmul_params(jcfg.llm)


def test_peak_table(monkeypatch):
    assert TF.PEAK_BF16 == {"NVIDIA H100 80GB HBM3": 989.4e12}
    assert TF.device_peak_flops("cpu") is None
    assert TF.device_peak_flops(torch.device("cpu")) is None
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA H100 80GB HBM3")
    assert TF.device_peak_flops("cuda") == 989.4e12
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA A100-SXM4-80GB")
    assert TF.device_peak_flops("cuda:0") is None


def _ulps(a, b):
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max())


@pytest.fixture
def x64_off():
    """JAX as bench.py's model path runs it (x64 off: int32 ids)."""
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", True)


@pytest.mark.parametrize("seed", [0, 1, 7, 2**32 + 5])
def test_randint_bit_equal(seed):
    # spans below 2**16, past it (the uint32 multiplier wraps to 0: the
    # flagship's vocabulary) and near 2**31
    for lo, hi in ((10, 32000), (0, 2), (10, 92544), (-5, 2**31 - 6)):
        want = jax.random.randint(jax.random.key(seed), (3, 50), lo, hi,
                                  dtype=jnp.int32)
        got = prng.randint(prng.key(seed), (3, 50), lo, hi)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="span"):
        prng.randint(prng.key(seed), (2,), 5, 5)


@pytest.mark.parametrize("seed", [0, 3])
def test_example_batch_equals_jax(seed, x64_off):
    want = JM.make_example_batch(JM.tiny_config(), batch=2, n_tiles=2,
                                 seq_len=64, seed=seed)
    want = {k: np.asarray(v) for k, v in want.items()}
    got = TM.make_example_batch(TM.tiny_config(), batch=2, n_tiles=2,
                                seq_len=64, seed=seed, device="cpu")
    assert want["input_ids"].dtype == np.int32
    np.testing.assert_array_equal(got["input_ids"].numpy(),
                                  want["input_ids"])
    np.testing.assert_array_equal(got["labels"].numpy(), want["labels"])
    assert got["tiles"].dtype == torch.float32
    assert _ulps(got["tiles"].numpy(), want["tiles"]) <= TILE_ULP
    with pytest.raises(ValueError, match="image tokens"):
        TM.make_example_batch(TM.tiny_config(), n_tiles=2, seq_len=8,
                              device="cpu")


def _f32(cfg):
    return dataclasses.replace(
        cfg, vit=dataclasses.replace(cfg.vit, dtype="float32"),
        llm=dataclasses.replace(cfg.llm, dtype="float32"))


def test_chained_steps_equal_jax_and_single_steps():
    jcfg = _f32(JM.tiny_config())
    tcfg_m = TM.with_dtype(TM.tiny_config(), "float32")
    jmodel = JM.MultiFrameMLLM(jcfg)
    batch = TM.make_example_batch(tcfg_m, batch=2, n_tiles=2, seq_len=64,
                                  seed=1, device="cpu")
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    params = jax.jit(jmodel.init)(jax.random.key(2), jbatch["input_ids"],
                                  jbatch["tiles"])
    tcfg = PT.TrainConfig(learning_rate=1e-3, warmup_steps=1,
                          total_steps=CHAIN)
    tx = JT.make_optimizer(JT.TrainConfig(learning_rate=1e-3,
                                          warmup_steps=1, total_steps=CHAIN))
    mesh = make_mesh(n_data=1, devices=jax.devices()[:1])
    jrun = JT.make_chained_train_step(jmodel, tx, mesh, CHAIN)
    jparams, _, jlosses = jrun(jax.tree_util.tree_map(jnp.array, params),
                               tx.init(params), jbatch)

    runs = []
    for chained in (True, False):
        model = TM.MultiFrameMLLM(tcfg_m, param_dtype=torch.float32)
        model.load_state_dict(jax_params_to_state_dict(params, jcfg))
        opt = PT.AdamW(list(model.named_parameters()), tcfg)
        if chained:
            losses = PT.make_chained_train_step(model, opt, CHAIN)(batch)
        else:
            step = PT.make_train_step(model, opt)
            losses = torch.stack([step(batch)["loss"] for _ in range(CHAIN)])
        assert all(p.grad is None for p in model.parameters())
        runs.append((losses, model.state_dict()))
    (losses, state), (single, single_state) = runs
    assert losses.shape == (CHAIN,) and losses.dtype == torch.float32
    np.testing.assert_allclose(losses.numpy(), single.numpy(), rtol=1e-6)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=REL)
    assert losses[-1] < losses[0]
    init = jax_params_to_state_dict(params, jcfg)
    p_j = jax_params_to_state_dict(jparams, jcfg)
    for name, p in state.items():
        torch.testing.assert_close(p, single_state[name], rtol=1e-6,
                                   atol=1e-7)
        moved, want = p - init[name], p_j[name] - init[name]
        err = ((moved - want).norm() / want.norm()).item()
        assert err <= UPDATE_REL, (name, err)
