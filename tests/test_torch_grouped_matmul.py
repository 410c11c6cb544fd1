"""The port's grouped matmul (K8: multi_spatialmllm_tpu_torch.ops.
grouped_matmul) against the JAX package's megablox path, run in interpret
mode on the CPU through `_grouped_dot(kernel="pallas")` as
tests/test_moe.py runs it.

The same numpy inputs go to both: `gmm_plain` against the forward, the
transposed form and `tgmm_plain` against `jax.vjp` of the forward
(dlhs = gmm(dy, rhs, transpose_rhs=True), drhs = tgmm(lhs, dy)), and the
port's `GroupedMatmul` backward against the same VJP. Group sizes cover an
empty group, a boundary inside a tile, rows past the groups' total,
`sum == M`, 64 groups of which four hold rows, a group that starts and
ends inside one 128-row tile, a one-row group, and M = 1, 16, 64 and 65
(both sides of the few-rows path's threshold). Megablox in interpret mode
leaves the rows past the groups' total unwritten (NaN), so those rows are
held to `lax.ragged_dot`'s zeros (`kernel="xla"`) instead. Tolerances are the JAX test's own: 1e-5 forward,
2e-4 gradients (f32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_spatialmllm_tpu.models import moe as JMoE
from multi_spatialmllm_tpu_torch.ops import grouped_matmul as TG

# (rows M, contraction K, output N, group sizes)
CASES = {
    "empty_group_boundary_midtile": (40, 16, 24, [10, 0, 21, 6]),
    "sum_equals_m": (48, 32, 16, [16, 17, 15]),
    "one_group_of_all_rows": (24, 8, 40, [24]),
    "e64_mostly_empty": (40, 16, 24, [0] * 3 + [10] + [0] * 13 + [1]
                         + [0] * 22 + [20] + [0] * 22 + [5]),
    "group_inside_one_tile": (200, 16, 24, [100, 20, 80]),
    "one_row_group": (20, 16, 24, [7, 1, 12]),
    "m1": (1, 16, 24, [0, 1]),
    "m16_decode_rows": (16, 32, 40, [5, 0, 7, 4]),
    "m64": (64, 16, 24, [30, 34]),
    "m65_rows_past_total": (65, 16, 24, [30, 33]),
}
FWD_TOL, GRAD_TOL = 1e-5, 2e-4


def _inputs(case, seed=0):
    m, k, n, sizes = CASES[case]
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return f(m, k), f(len(sizes), k, n), f(m, n), np.asarray(sizes, np.int32)


def _jax_fwd_vjp(lhs, rhs, dy, sizes):
    """Megablox's forward and VJP, the rows past the groups' total taken
    from `lax.ragged_dot` (zeros)."""
    gs = jnp.asarray(sizes)
    outs = {}
    for kernel in ("pallas", "xla"):
        out, vjp = jax.vjp(
            lambda a, b: JMoE._grouped_dot(a, b, gs, kernel=kernel),
            jnp.asarray(lhs), jnp.asarray(rhs))
        outs[kernel] = [np.array(x) for x in (out, *vjp(jnp.asarray(dy)))]
    total = int(sizes.sum())
    out, dlhs, drhs = outs["pallas"]
    for x, ref in ((out, outs["xla"][0]), (dlhs, outs["xla"][1])):
        x[total:] = ref[total:]
        assert not x[total:].any()
    return out, dlhs, drhs


@pytest.mark.parametrize("case", list(CASES))
def test_plain_forms_match_jax_forward_and_vjp(case):
    lhs, rhs, dy, sizes = _inputs(case)
    out_j, dlhs_j, drhs_j = _jax_fwd_vjp(lhs, rhs, dy, sizes)
    t = torch.from_numpy
    gs = t(sizes)
    np.testing.assert_allclose(TG.gmm_plain(t(lhs), t(rhs), gs).numpy(),
                               out_j, atol=FWD_TOL)
    np.testing.assert_allclose(
        TG.gmm_plain(t(dy), t(rhs), gs, transpose_rhs=True).numpy(),
        dlhs_j, atol=GRAD_TOL)
    np.testing.assert_allclose(TG.tgmm_plain(t(lhs), t(dy), gs).numpy(),
                               drhs_j, atol=GRAD_TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_grouped_matmul_backward_matches_jax_vjp(case):
    lhs, rhs, dy, sizes = _inputs(case, seed=1)
    out_j, dlhs_j, drhs_j = _jax_fwd_vjp(lhs, rhs, dy, sizes)
    a = torch.from_numpy(lhs).requires_grad_()
    b = torch.from_numpy(rhs).requires_grad_()
    out = TG.grouped_matmul(a, b, torch.from_numpy(sizes))
    out.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(out.detach().numpy(), out_j, atol=FWD_TOL)
    np.testing.assert_allclose(a.grad.numpy(), dlhs_j, atol=GRAD_TOL)
    np.testing.assert_allclose(b.grad.numpy(), drhs_j, atol=GRAD_TOL)


def test_rows_past_the_groups_and_empty_groups_are_zero():
    lhs, rhs, dy, sizes = _inputs("empty_group_boundary_midtile", seed=2)
    t = torch.from_numpy
    total = int(sizes.sum())
    out = TG.gmm_plain(t(lhs), t(rhs), t(sizes))
    assert total < lhs.shape[0] and not out[total:].any()
    dw = TG.tgmm_plain(t(lhs), t(dy), t(sizes))
    assert dw.shape == rhs.shape and not dw[1].any()    # group 1 is empty


def test_bf16_plain_accumulates_in_f32_and_rounds_once():
    lhs, rhs, _, sizes = _inputs("sum_equals_m", seed=3)
    a = torch.from_numpy(lhs).bfloat16()
    b = torch.from_numpy(rhs).bfloat16()
    got = TG.gmm_plain(a, b, torch.from_numpy(sizes))
    want = TG.gmm_plain(a.float(), b.float(), torch.from_numpy(sizes))
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.bfloat16())


def test_cuda_wrappers_refuse_before_launch():
    """What the kernels do not take raises before any build or launch."""
    lhs = torch.zeros(16, 12, dtype=torch.bfloat16)     # K not a multiple
    rhs = torch.zeros(2, 12, 16, dtype=torch.bfloat16)  # of 8 in bf16
    gs = torch.tensor([8, 8], dtype=torch.int32)
    with pytest.raises(ValueError, match="multiples of 8"):
        TG.gmm_cuda(lhs, rhs, gs)
    with pytest.raises(ValueError, match="dtype"):
        TG.tgmm_cuda(lhs.half(), torch.zeros(16, 16).half(), gs)
    with pytest.raises(ValueError, match="groups"):
        TG.gmm_cuda(torch.zeros(4, 8), torch.zeros(600, 8, 8),
                    torch.zeros(600, dtype=torch.int32))
    assert all(k.launches == 0 for k in (TG.GMM, TG.GMM_T, TG.TGMM))


def test_unsupported_device_raises_not_falls_back():
    x = torch.empty(4, 8, device="meta")
    gs = torch.empty(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        TG.gmm(x, torch.empty(2, 8, 8, device="meta"), gs)
    with pytest.raises(ValueError, match="unsupported device"):
        TG.tgmm(x, x, gs)


@pytest.mark.parametrize("m,k,n,e,splits", [
    (16, 2048, 8192, 4, 1),    # MoE decode, gate/up: 256 items at most
    (16, 8192, 2048, 4, 1),    # MoE decode, down: 64 items at most
    (1, 8192, 2048, 4, 4),     # one row: one group, 16 column blocks
    (2, 8192, 2048, 4, 2),
    (1, 2048, 8192, 4, 1),
    (64, 2048, 8192, 4, 1),    # the threshold
    (65, 2048, 8192, 4, 0),    # past it: the general path
    (0, 2048, 8192, 4, 0),     # nothing to do
    (1, 256, 128, 4, 1),       # too shallow to split
    (512, 2048, 8192, 4, 0),   # prefill rows
])
def test_rows_path_splits(m, k, n, e, splits):
    assert TG.rows_path_splits(m, k, n, e, sms=132) == splits


def test_rows_path_splits_fill_the_card_and_keep_deep_parts():
    """Over a grid of shapes: a power of two; enough items for a
    1/SMS_PER_ITEM of the SMs unless a part would fall under
    MIN_SPLIT_STEPS stages; no split makes a part shallower than that."""
    for m in (1, 5, 16, 33, 64):
        for k in (64, 256, 1000, 2048, 8192):
            for n in (8, 512, 2048, 8192):
                for e in (1, 4, 64):
                    s = TG.rows_path_splits(m, k, n, e, sms=132)
                    assert s >= 1 and s & (s - 1) == 0
                    steps = -(-k // TG.K_STEP)
                    items = min(e, m) * -(-n // TG.ROWS_BLOCK)
                    if s > 1:
                        assert steps // s >= TG.MIN_SPLIT_STEPS
                    assert (items * s * TG.SMS_PER_ITEM >= 132
                            or 2 * s * TG.MIN_SPLIT_STEPS > steps)


@pytest.mark.parametrize("m,n,splits,numel", [
    (16, 2048, 8, 16 * 2048 * 8), (16, 8192, 2, 16 * 8192 * 2),
    (16, 8192, 1, 0), (64, 8, 0, 0)])
def test_workspace_numel(m, n, splits, numel):
    assert TG.workspace_numel(m, n, splits) == numel

