"""The port's routed MoE (multi_spatialmllm_tpu_torch.models.moe) against
the JAX package's models/moe.py on the same numpy parameters and inputs,
in float32 on the CPU.

- `_topk_select`, `top_k_routing`, `moe_capacity` and the load-balance
  statistic. Dispatch is bit-equal; combine is bit-equal given the same
  gates, and within one ulp from the same logits (XLA's and PyTorch's
  float32 `exp` differ in the last bit, and the gates are softmax
  values);
- `MoEMLP` forward and gradients (parameters and input, through
  `sum(y**2) + aux`) for the einsum impl, the einsum impl with GShard
  groups, and the ragged impl with `moe_kernel` "xla" and "pallas" (the
  JAX side runs megablox in interpret mode, as tests/test_moe.py does), at
  1e-5 and 2e-4, the JAX test's own tolerances;
- the `moe_group` error, the inference no-drop capacity, and the ragged
  impl's chunk invariance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_spatialmllm_tpu.models import mllm as JM
from multi_spatialmllm_tpu.models import moe as JMoE
from multi_spatialmllm_tpu_torch.models import mllm as TM
from multi_spatialmllm_tpu_torch.models import moe as TMoE

FWD_TOL, GRAD_TOL = 1e-5, 2e-4
PARAMS = ("router", "wi_gate", "wi_up", "wo")


def llm_cfgs(**kw):
    """(JAX, port) tiny MoE LLM configs in float32 with the overrides."""
    j = dataclasses.replace(JM.tiny_moe_config().llm, dtype="float32", **kw)
    t = dataclasses.replace(TM.tiny_moe_config().llm, dtype="float32", **kw)
    return j, t


def jax_params(cfg, seed=0):
    """Numpy MoE parameters in the JAX layouts (lecun-normal scales)."""
    rng = np.random.default_rng(seed)
    d, e, f = cfg.hidden_size, cfg.moe_experts, cfg.ffn_size
    shapes = {"router": (d, e), "wi_gate": (e, d, f), "wi_up": (e, d, f),
              "wo": (e, f, d)}
    return {k: (rng.standard_normal(s) / np.sqrt(s[-2])).astype(np.float32)
            for k, s in shapes.items()}


def port_mlp(tcfg, params):
    mlp = TMoE.MoEMLP(tcfg)
    mlp.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    return mlp


def jax_loss_and_grads(jcfg, params, x, valid=None, inference=False):
    """`sum(y**2) + aux` and its gradients w.r.t. the params and x."""
    def loss(p, xin):
        y, mut = JMoE.MoEMLP(jcfg).apply(
            {"params": p}, xin, valid=valid, inference=inference,
            mutable=["intermediates"])
        aux = mut["intermediates"]["moe_aux_loss"][0]
        return jnp.sum(y ** 2) + aux, y

    p = {k: jnp.asarray(v) for k, v in params.items()}
    (val, y), grads = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        p, jnp.asarray(x))
    return float(val), np.asarray(y), grads


def port_loss_and_grads(tcfg, params, x, valid=None, inference=False):
    mlp = port_mlp(tcfg, params)
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = mlp(xt, valid=None if valid is None else torch.from_numpy(
        np.asarray(valid)), inference=inference)
    loss = (y ** 2).sum() + aux
    loss.backward()
    grads = {k: getattr(mlp, k).grad.numpy() for k in PARAMS}
    return float(loss), y.detach().numpy(), grads, xt.grad.numpy()


IMPLS = {
    "einsum": dict(moe_impl="einsum"),
    "einsum_grouped": dict(moe_impl="einsum", moe_group=8),
    "ragged_xla": dict(moe_impl="ragged", moe_kernel="xla"),
    "ragged_pallas": dict(moe_impl="ragged", moe_kernel="pallas"),
}


@pytest.mark.parametrize("impl", list(IMPLS))
def test_moe_mlp_forward_and_grads_match_jax(impl):
    jcfg, tcfg = llm_cfgs(**IMPLS[impl])
    params = jax_params(jcfg, seed=1)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 16, jcfg.hidden_size)).astype(np.float32)
    valid = np.ones((2, 16), bool)
    valid[1, 12:] = False                     # packed-row pads
    want, y_j, (g_p, g_x) = jax_loss_and_grads(jcfg, params, x, valid)
    got, y_t, g_t, gx_t = port_loss_and_grads(tcfg, params, x, valid)
    np.testing.assert_allclose(y_t, y_j, atol=FWD_TOL, rtol=FWD_TOL)
    assert got == pytest.approx(want, rel=1e-5)
    for k in PARAMS:
        np.testing.assert_allclose(g_t[k], np.asarray(g_p[k]), atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=k)
    np.testing.assert_allclose(gx_t, np.asarray(g_x), atol=GRAD_TOL,
                               rtol=GRAD_TOL)


@pytest.mark.parametrize("with_mask", [False, True], ids=["all", "masked"])
def test_topk_select_matches_jax(with_mask):
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((24, 4)).astype(np.float32) * 2
    logits[5] = [1.0, 3.0, 3.0, 0.5]          # a tie for the first choice
    vmask = None
    if with_mask:
        vmask = (rng.random(24) > 0.3).astype(np.float32)
    idx_j, g_j, aux_j = JMoE._topk_select(
        jnp.asarray(logits), 2, None if vmask is None else jnp.asarray(vmask))
    idx_t, g_t, aux_t = TMoE._topk_select(
        torch.from_numpy(logits), 2,
        None if vmask is None else torch.from_numpy(vmask))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    assert idx_t[5, 0] == 1                   # the first maximum
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), atol=1e-6)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-6)


@pytest.mark.parametrize("with_mask", [False, True], ids=["all", "masked"])
def test_expert_counts_match_jax_bincount(with_mask):
    """The ragged path's group sizes, counted on the device, equal the JAX
    ragged path's `jnp.bincount(ei, length=e)` on the same routing, pads
    and an expert that no token picks included."""
    rng = np.random.default_rng(11)
    e, k = 6, 2
    logits = rng.standard_normal((40, e)).astype(np.float32) * 2
    logits[:, 4] = -30.0                      # expert 4 never chosen
    vmask = None
    if with_mask:
        vmask = (rng.random(40) > 0.3).astype(np.float32)
    idx_j, _, _ = JMoE._topk_select(
        jnp.asarray(logits), k, None if vmask is None else jnp.asarray(vmask))
    want = np.asarray(jnp.bincount(idx_j.reshape(-1), length=e))
    idx_t, _, _ = TMoE._topk_select(
        torch.from_numpy(logits), k,
        None if vmask is None else torch.from_numpy(vmask))
    got = TMoE.expert_counts(idx_t.reshape(-1).long(), e)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[4] == 0 and want.sum() == 40 * k


def test_topk_gate_gradient_shares_ties_like_jax():
    """`amax` splits the gradient among tied maxima as `jnp.max` does."""
    logits = np.asarray([[2.0, 2.0, 0.0, -1.0], [0.5, 1.5, 1.5, 1.5]],
                        np.float32)
    want = jax.grad(lambda z: jnp.sum(
        JMoE._topk_select(z, 2, None)[1] * jnp.asarray([1.0, 3.0])))(
        jnp.asarray(logits))
    z = torch.from_numpy(logits).requires_grad_()
    (TMoE._topk_select(z, 2, None)[1] * torch.tensor([1.0, 3.0])).sum() \
        .backward()
    np.testing.assert_allclose(z.grad.numpy(), np.asarray(want), atol=1e-6)


def _routing_inputs():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((2, 12, 4)).astype(np.float32)
    logits[0, :, 0] += 3.0                    # crowd expert 0: drops at 3
    return logits, rng.random((2, 12)) > 0.25


@pytest.mark.parametrize("capacity", [3, 16])
def test_top_k_routing_matches_jax(capacity):
    logits, valid = _routing_inputs()
    d_j, c_j, aux_j = JMoE.top_k_routing(jnp.asarray(logits), 2, capacity,
                                         valid=jnp.asarray(valid))
    d_t, c_t, aux_t = TMoE.top_k_routing(torch.from_numpy(logits), 2,
                                         capacity,
                                         valid=torch.from_numpy(valid))
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=2.4e-7,
                               atol=0)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-6)


@pytest.mark.parametrize("capacity", [3, 16])
def test_top_k_routing_bit_equal_given_the_same_gates(capacity, monkeypatch):
    """Both packages' dispatch/combine construction on the same selection
    (the JAX `_topk_select`'s idx, gates and aux handed to both)."""
    logits, valid = _routing_inputs()
    vflat = jnp.asarray(valid.reshape(-1).astype(np.float32))
    idx, gates, aux = (np.asarray(a) for a in JMoE._topk_select(
        jnp.asarray(logits.reshape(-1, 4)), 2, vflat))
    monkeypatch.setattr(TMoE, "_topk_select", lambda *a: (
        torch.from_numpy(idx), torch.from_numpy(gates),
        torch.tensor(float(aux))))
    d_j, c_j, _ = JMoE.top_k_routing(jnp.asarray(logits), 2, capacity,
                                     valid=jnp.asarray(valid))
    d_t, c_t, _ = TMoE.top_k_routing(torch.from_numpy(logits), 2, capacity,
                                     valid=torch.from_numpy(valid))
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))


def test_moe_capacity_matches_jax():
    for kw in ({}, dict(moe_capacity=1.25), dict(moe_top_k=1)):
        jcfg, tcfg = llm_cfgs(**kw)
        for t in (1, 7, 32, 512, 513, 1024):
            for inference in (False, True):
                assert TMoE.moe_capacity(tcfg, t, inference) == \
                    JMoE.moe_capacity(jcfg, t, inference), (kw, t, inference)
    assert TMoE.NO_DROP_MAX_T == JMoE.NO_DROP_MAX_T


def test_moe_group_must_divide_the_training_length():
    jcfg, tcfg = llm_cfgs(moe_group=5)
    params = jax_params(jcfg)
    x = np.zeros((1, 16, jcfg.hidden_size), np.float32)
    with pytest.raises(ValueError, match="must divide"):
        port_mlp(tcfg, params)(torch.from_numpy(x))
    with pytest.raises(ValueError, match="must divide"):
        JMoE.MoEMLP(jcfg).apply({"params": {k: jnp.asarray(v) for k, v in
                                            params.items()}}, jnp.asarray(x))
    # inference ignores the grouping
    y, _ = port_mlp(tcfg, params)(torch.from_numpy(x), inference=True)
    assert y.shape == x.shape


def test_inference_routes_with_no_drop_capacity():
    """Every token crowding expert 0: training drops past the capacity,
    inference (no-drop capacity for short chunks) routes them all; the
    port matches JAX in both."""
    jcfg, tcfg = llm_cfgs(moe_capacity=0.5)
    params = jax_params(jcfg, seed=5)
    params["router"][:, 0] += 1.0
    rng = np.random.default_rng(6)
    x = np.abs(rng.standard_normal((1, 16, jcfg.hidden_size))).astype(
        np.float32)
    ys = {}
    for inference in (False, True):
        _, y_j, _ = jax_loss_and_grads(jcfg, params, x, inference=inference)
        _, y_t, _, _ = port_loss_and_grads(tcfg, params, x,
                                           inference=inference)
        np.testing.assert_allclose(y_t, y_j, atol=FWD_TOL, rtol=FWD_TOL)
        ys[inference] = y_t
    dropped = lambda y: int((np.abs(y).sum(-1) == 0).sum())  # noqa: E731
    assert dropped(ys[False]) > 0 and dropped(ys[True]) == 0


@pytest.mark.parametrize("kernel", ["xla", "pallas"])
def test_ragged_outputs_are_chunk_invariant(kernel):
    """Dropless per-token routing: a row routed whole equals the same row
    routed in chunks of 5 tokens, and equals JAX's."""
    jcfg, tcfg = llm_cfgs(moe_impl="ragged", moe_kernel=kernel)
    params = jax_params(jcfg, seed=7)
    x = np.random.default_rng(8).standard_normal(
        (2, 15, jcfg.hidden_size)).astype(np.float32)
    mlp = port_mlp(tcfg, params)
    with torch.no_grad():
        whole, _ = mlp(torch.from_numpy(x), inference=True)
        parts = torch.cat([mlp(torch.from_numpy(x[:, i:i + 5]),
                               inference=True)[0] for i in range(0, 15, 5)],
                          dim=1)
    np.testing.assert_allclose(parts.numpy(), whole.numpy(), atol=1e-6)
    _, y_j, _ = jax_loss_and_grads(jcfg, params, x, inference=True)
    np.testing.assert_allclose(whole.numpy(), y_j, atol=FWD_TOL,
                               rtol=FWD_TOL)
