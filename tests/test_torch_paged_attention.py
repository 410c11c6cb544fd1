"""Port paged decode attention (multi_spatialmllm_tpu_torch.ops.
paged_attention) against the JAX package's Pallas kernel in interpret
mode, at the shapes of tests/test_paged_kv.py: pools (and, for int8
pools, scale pools) after the fused write must be exactly equal, outputs
within atol 2e-5 (f32; online vs single-pass softmax order, and for int8
the scales applied after the products in the kernel, before them in the
plain version's dequantised window). Inputs are numpy draws from a fixed
seed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_spatialmllm_tpu.ops import paged_attention as JP
from multi_spatialmllm_tpu_torch.ops import paged_attention as TP

B, PS, POOL, HD = 3, 16, 12, 64
# distinct pages per slot, unallocated tails at the sink; positions
# mid-page, on a page boundary (first row of a fresh page), in page 0
PAGE_TABLE = np.asarray([[1, 4, 7, 0],
                         [2, 5, 0, 0],
                         [3, 0, 0, 0]], np.int32)
INDEX = np.asarray([PS * 2 + 5, PS * 2, 3], np.int32)


def _inputs(seed, h, kvh, b=B, pool=POOL, ps=PS, hd=HD):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (f(b, h, 1, hd), f(pool, kvh, ps, hd), f(pool, kvh, ps, hd),
            f(b, kvh, hd), f(b, kvh, hd))


def _jax_fused(q, kp, vp, pt, idx, kn, vn):
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        out, kp2, vp2 = JP.paged_decode_attention(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(pt), jnp.asarray(idx), k_new=jnp.asarray(kn),
            v_new=jnp.asarray(vn))
    return np.asarray(out), np.asarray(kp2), np.asarray(vp2)


def _torch_op(q, kp, vp, pt, idx, kn, vn):
    t = lambda a: torch.from_numpy(a.copy())  # noqa: E731
    kp_t, vp_t = t(kp), t(vp)
    out = TP.paged_decode_attention(t(q), kp_t, vp_t, t(pt), t(idx),
                                    t(kn), t(vn))
    return out, kp_t, vp_t


@pytest.mark.parametrize("kvh,h", [(2, 4), (3, 3), (1, 4)])
def test_fused_write_matches_jax_kernel(kvh, h):
    q, kp, vp, kn, vn = _inputs(0, h, kvh)
    want, kp_j, vp_j = _jax_fused(q, kp, vp, PAGE_TABLE, INDEX, kn, vn)
    out, kp_t, vp_t = _torch_op(q, kp, vp, PAGE_TABLE, INDEX, kn, vn)
    np.testing.assert_array_equal(kp_t.numpy(), kp_j)
    np.testing.assert_array_equal(vp_t.numpy(), vp_j)
    np.testing.assert_allclose(out.numpy(), want, atol=2e-5)


def test_window_path_matches_jax_kernel_without_write():
    from jax.experimental.pallas import tpu as pltpu

    q, kp, vp, _, _ = _inputs(1, 4, 2)
    idx = np.asarray([PS * 2 + 5, PS * 2 - 1, 3], np.int32)
    with pltpu.force_tpu_interpret_mode():
        want = JP.paged_decode_attention(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(PAGE_TABLE), jnp.asarray(idx))
    got = TP.window_attention(torch.from_numpy(q), torch.from_numpy(kp),
                              torch.from_numpy(vp),
                              torch.from_numpy(PAGE_TABLE),
                              torch.from_numpy(idx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_garbage_beyond_index_is_ignored():
    """Pages ahead of the decode horizon, the sink page and the rows of
    the current page past the index hold garbage the mask must hide."""
    b, h, kvh, ps, pool, hd = 1, 2, 1, 8, 6, 32
    q, kp, vp, kn, vn = _inputs(2, h, kvh, b=b, pool=pool, ps=ps, hd=hd)
    pt = np.asarray([[1, 2, 3]], np.int32)
    idx = np.asarray([ps + 2], np.int32)
    out, _, _ = _torch_op(q, kp, vp, pt, idx, kn, vn)
    kpois, vpois = kp.copy(), vp.copy()
    for pois, val in ((kpois, 1e4), (vpois, 1e4)):
        pois[3] = val
        pois[0] = -val
        pois[2, :, 3:] = val
    out2, _, _ = _torch_op(q, kpois, vpois, pt, idx, kn, vn)
    np.testing.assert_allclose(out.numpy(), out2.numpy(), atol=1e-6)
    want, _, _ = _jax_fused(q, kpois, vpois, pt, idx, kn, vn)
    np.testing.assert_allclose(out2.numpy(), want, atol=2e-5)


def test_quantize_kv_rows_matches_jax():
    rows = np.random.default_rng(3).standard_normal(
        (5, 2, 16, 64)).astype(np.float32)
    rows[0, 0, 0] = 0.0                       # an all-zero row
    q_j, s_j = JP.quantize_kv_rows(jnp.asarray(rows))
    q_t, s_t = TP.quantize_kv_rows(torch.from_numpy(rows))
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))


def _int8_inputs(seed, h, kvh):
    q, kp, vp, kn, vn = _inputs(seed, h, kvh)
    kq, ks = JP.quantize_kv_rows(jnp.asarray(kp))
    vq, vs = JP.quantize_kv_rows(jnp.asarray(vp))
    return q, np.asarray(kq), np.asarray(vq), np.asarray(ks), \
        np.asarray(vs), kn, vn


@pytest.mark.parametrize("kvh,h", [(2, 4), (1, 4)])
def test_int8_fused_write_matches_jax_kernel(kvh, h):
    """The int8 plain version (rows quantised with `quantize_kv_rows`,
    scattered with their scales, windows dequantised) against the JAX
    kernel's quant branch with its fused write, in interpret mode, and
    against JAX's XLA write (`quantize_kv_rows` and a scatter, the path
    the JAX batcher takes off the TPU). Pools and scales are bit-equal to
    the XLA write; the int8 pools bit-equal to the kernel's, its scales
    within one ulp: interpreted on XLA's CPU backend, the kernel's
    max/127 comes out as max * (1/127) for some rows, where
    `quantize_kv_rows`, the port and the CUDA kernel divide."""
    from jax.experimental.pallas import tpu as pltpu

    q, kp, vp, ks, vs, kn, vn = _int8_inputs(4, h, kvh)
    page = PAGE_TABLE[np.arange(B), INDEX // PS]
    off = INDEX % PS
    xla = []
    for pool, sc, new in ((kp, ks, kn), (vp, vs, vn)):
        rows, scales = JP.quantize_kv_rows(jnp.asarray(new))
        xla.append(np.asarray(jnp.asarray(pool).at[page, :, off].set(rows)))
        xla.append(np.asarray(jnp.asarray(sc).at[page, :, off].set(scales)))
    with pltpu.force_tpu_interpret_mode():
        want, kp_j, vp_j, ks_j, vs_j = JP.paged_decode_attention(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(PAGE_TABLE), jnp.asarray(INDEX),
            k_new=jnp.asarray(kn), v_new=jnp.asarray(vn),
            k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    pools = [t(kp), t(vp), t(ks), t(vs)]
    out = TP.paged_decode_attention(t(q), *pools[:2], t(PAGE_TABLE),
                                    t(INDEX), t(kn), t(vn), *pools[2:])
    for got, ref in zip(pools, (xla[0], xla[2], xla[1], xla[3])):
        np.testing.assert_array_equal(got.numpy(), ref)
    for got, ref in zip(pools[:2], (kp_j, vp_j)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    for got, ref in zip(pools[2:], (ks_j, vs_j)):
        np.testing.assert_array_max_ulp(got.numpy(), np.asarray(ref), 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=2e-5)


def test_int8_window_matches_jax_kernel_without_write():
    from jax.experimental.pallas import tpu as pltpu

    q, kp, vp, ks, vs, _, _ = _int8_inputs(5, 4, 2)
    with pltpu.force_tpu_interpret_mode():
        want = JP.paged_decode_attention(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(PAGE_TABLE), jnp.asarray(INDEX),
            k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    t = torch.from_numpy
    got = TP.window_attention(t(q), t(kp), t(vp), t(PAGE_TABLE), t(INDEX),
                              t(ks), t(vs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
