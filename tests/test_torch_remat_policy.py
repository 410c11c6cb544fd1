"""The port's selective remat policies (models/llm.remat_policy) held
against the JAX package's (models/llm._remat_policy) on the CPU, as
tests/test_models.py:173 holds the JAX ones: under each of the four named
policies the loss and the gradients equal the port's without remat and the
JAX model's under the same policy, within GRAD_TOL, for the tiny config and
the tiny MoE with the ragged impl on K8's plain path. A TorchDispatchMode
counts what a forward and backward run: under `dots_and_flash_saveable`
the matrix products (`mm`, `addmm`) and the flash forward calls equal the
no-remat model's (nothing is recomputed but elementwise ops); whole-layer
recompute runs both again."""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from multi_spatialmllm_tpu.models import mllm as JM
from multi_spatialmllm_tpu_torch.models import llm as TL
from multi_spatialmllm_tpu_torch.models import mllm as TM
from multi_spatialmllm_tpu_torch.models.convert import (
    jax_params_to_state_dict,
)
from multi_spatialmllm_tpu_torch.ops.attention import FLASH_FWD_OP

from test_torch_training import make_batch, to_torch

POLICIES = ["nothing_saveable", "everything_saveable",
            "dots_with_no_batch_dims_saveable", "dots_and_flash_saveable"]
# loss and gradients: the port under a policy against the port without
# remat (the same ops: equal) and against the JAX model under the policy
# (f32; the port's forward sits within 1e-4 of JAX's logits,
# tests/test_torch_training.py), relative to the largest gradient of a
# tensor
GRAD_TOL = 1e-5
DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _with_remat(cfg, remat, policy):
    return dataclasses.replace(
        cfg, vit=dataclasses.replace(cfg.vit, remat=remat,
                                     remat_policy=policy),
        llm=dataclasses.replace(cfg.llm, remat=remat, remat_policy=policy))


def _configs(moe):
    if moe:
        j = JM.tiny_moe_config()
        j = dataclasses.replace(j, llm=dataclasses.replace(
            j.llm, moe_impl="ragged", moe_kernel="pallas"))
        t = TM.tiny_moe_config()
        t = dataclasses.replace(t, llm=dataclasses.replace(
            t.llm, moe_impl="ragged", moe_kernel="pallas"))
    else:
        j, t = JM.tiny_config(), TM.tiny_config()
    j = dataclasses.replace(
        j, vit=dataclasses.replace(j.vit, dtype="float32"),
        llm=dataclasses.replace(j.llm, dtype="float32"))
    return j, TM.with_dtype(t, "float32")


@pytest.fixture(scope="module", params=[False, True], ids=["dense", "moe"])
def setup(request):
    jcfg, tcfg = _configs(request.param)
    batch = make_batch(jcfg, True, 7)
    params = jax.jit(JM.MultiFrameMLLM(jcfg).init)(
        jax.random.key(1), jnp.asarray(batch["input_ids"]),
        jnp.asarray(batch["tiles"]))
    state = jax_params_to_state_dict(params, jcfg)
    return jcfg, tcfg, params, state, batch


def _port_run(tcfg, state, batch, remat, policy):
    model = TM.MultiFrameMLLM(_with_remat(tcfg, remat, policy),
                              param_dtype=torch.float32)
    model.load_state_dict(state)
    loss = TM.loss_fn(model, to_torch(batch))
    loss.backward()
    return loss.item(), {n: p.grad.numpy() for n, p in
                         model.named_parameters()}


def _jax_run(jcfg, params, batch, policy):
    model = JM.MultiFrameMLLM(_with_remat(jcfg, True, policy))
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.value_and_grad(
        lambda p: JM.loss_fn(model, p, b))(params)
    return float(loss), {k: v.numpy() for k, v in
                         jax_params_to_state_dict(grads, jcfg).items()}


def _assert_close(got, want, what):
    loss_g, grads_g = got
    loss_w, grads_w = want
    assert abs(loss_g - loss_w) <= GRAD_TOL * abs(loss_w), what
    assert set(grads_g) == set(grads_w)
    for name, g in grads_g.items():
        w = grads_w[name]
        err = float(np.abs(g - w).max())
        assert err <= GRAD_TOL * max(float(np.abs(w).max()), 1e-6), \
            (what, name, err)


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_keeps_loss_and_gradients(setup, policy):
    jcfg, tcfg, params, state, batch = setup
    plain = _port_run(tcfg, state, batch, False, None)
    got = _port_run(tcfg, state, batch, True, policy)
    _assert_close(got, plain, "port without remat")
    _assert_close(got, _jax_run(jcfg, params, batch, policy), "JAX")


class _Count(TorchDispatchMode):
    """Counts the dispatches of matrix products and of the flash forward."""

    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in DOTS:
            self.counts["dots"] += 1
        elif func == FLASH_FWD_OP:
            self.counts["flash"] += 1
        return func(*args, **(kwargs or {}))


def _dispatches(tcfg, state, batch, remat, policy):
    model = TM.MultiFrameMLLM(_with_remat(tcfg, remat, policy),
                              param_dtype=torch.float32)
    model.load_state_dict(state)
    with _Count() as count:
        TM.loss_fn(model, to_torch(batch)).backward()
    return count.counts


@pytest.mark.parametrize("policy", [None, *POLICIES])
def test_what_each_policy_recomputes(setup, policy):
    jcfg, tcfg, params, state, batch = setup
    plain = _dispatches(tcfg, state, batch, False, None)
    got = _dispatches(tcfg, state, batch, True, policy)
    assert plain["dots"] > 0 and plain["flash"] == (
        tcfg.vit.num_layers + tcfg.llm.num_layers)
    # the forward runs again: every product and flash forward of a layer
    keeps_dots = policy in ("everything_saveable",
                            "dots_with_no_batch_dims_saveable",
                            "dots_and_flash_saveable")
    keeps_flash = policy in ("everything_saveable", "dots_and_flash_saveable")
    assert (got["dots"] == plain["dots"]) == keeps_dots
    assert got["dots"] >= plain["dots"]
    assert got["flash"] == (1 if keeps_flash else 2) * plain["flash"]


def test_unknown_policy_raises():
    cfg = TM.tiny_config()
    bad = dataclasses.replace(cfg, llm=dataclasses.replace(
        cfg.llm, remat=True, remat_policy="dots_saveable"))
    with pytest.raises(ValueError, match="dots_and_flash_saveable"):
        TM.MultiFrameMLLM(bad)
    bad = dataclasses.replace(cfg, vit=dataclasses.replace(
        cfg.vit, remat=True, remat_policy="offload_dot"))
    with pytest.raises(ValueError, match="nothing_saveable"):
        TM.MultiFrameMLLM(bad)
    TL.check_remat_policy(cfg.llm)     # None is whole-layer remat


@pytest.mark.parametrize("impl", ["einsum", "ragged"])
def test_bench_configs_carry_the_jax_policies(impl):
    for tcfg, jcfg in ((TM.bench_1chip_config(), JM.bench_1chip_config()),
                       (TM.bench_1chip_moe_config(impl=impl),
                        JM.bench_1chip_moe_config(impl=impl))):
        for tower in ("vit", "llm"):
            t, j = getattr(tcfg, tower), getattr(jcfg, tower)
            assert (t.remat, t.remat_policy) == (j.remat, j.remat_policy)
    assert TM.bench_1chip_config().llm.remat_policy == \
        "dots_and_flash_saveable"
    assert TM.bench_1chip_moe_config(impl=impl).llm.remat_policy == (
        "dots_and_flash_saveable" if impl == "ragged" else None)
    assert TM.flagship_config().llm.remat_policy is None
