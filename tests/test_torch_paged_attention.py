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


def _split_runs(index, chunk, n_split):
    """The kernel's runs for one slot: `(first chunk, chunks)` of each
    live split, in split order. The chunks 0..index // chunk are dealt out
    in order over min(n_split, their count) splits, the first ones taking
    one chunk more where they do not divide evenly."""
    live = index // chunk + 1
    n_live = min(n_split, live)
    q, extra = divmod(live, n_live)
    return [(s * q + min(s, extra), q + (s < extra)) for s in range(n_live)]


@pytest.mark.parametrize("b,kvh,ps,pps,hd,itemsize,quant", [
    (8, 8, 64, 11, 128, 2, False),      # flagship serve, phase 4
    (8, 8, 64, 33, 128, 2, False),      # flagship serve's table width
    (8, 8, 64, 64, 128, 2, False),      # 4,096 positions
    (8, 8, 128, 6, 128, 1, True),       # bench MoE serve, int8
    (8, 8, 128, 32, 128, 1, True),      # 4,096 positions, int8
    (8, 8, 64, 11, 128, 4, False),      # float32 pools
    (3, 3, 8, 4, 32, 4, False),
    (4, 2, 16, 4, 64, 1, True),
    (1, 1, 48, 3, 64, 2, False),        # a page size that is no power of 2
])
def test_split_plan_covers_every_live_position_once(b, kvh, ps, pps, hd,
                                                    itemsize, quant):
    """The kernel's split plan comes from the shapes alone (it takes no
    index, so its launch is the same at every step); at every index the
    runs it deals out cover positions 0..index once, in order, within the
    plan's splits, each chunk inside one page and within the kernel's
    chunk limits, the grid within MAX_CTAS."""
    chunk, n_split = TP.split_plan(b, kvh, ps, pps, hd, itemsize, quant)
    assert ps % chunk == 0 and not (quant and chunk % 4)
    assert chunk <= TP.CHUNK_POSITIONS
    assert chunk * hd * itemsize <= TP.CHUNK_BYTES
    assert b * kvh * n_split <= max(TP.MAX_CTAS, b * kvh)
    for index in range(pps * ps):
        runs = _split_runs(index, chunk, n_split)
        assert 1 <= len(runs) <= n_split
        first = [c for c, n in runs]
        assert first == sorted(first) and first[0] == 0
        chunks = [c for c0, n in runs for c in range(c0, c0 + n)]
        assert chunks == list(range(index // chunk + 1))
        assert max(n for _, n in runs) - min(n for _, n in runs) <= 1


def _split_combine(q, kp, vp, pt, idx, ks=None, vs=None, plan=None):
    """The kernel's arithmetic in float32 torch, after the write: each
    (slot, kv head)'s live chunks dealt out over the plan's splits
    (`_split_runs`); inside a split an online softmax chunk by chunk, rows
    past the index masked with NEG_INF, the k scale on the scores, the v
    scale on the probabilities; the splits' partials combined in split
    order, in one pass rescaled to the running max."""
    b, h, _, hd = q.shape
    _, kvh, ps, _ = kp.shape
    rep = h // kvh
    chunk, n_split = plan or TP.split_plan(
        b, kvh, ps, pt.shape[1], hd, kp.element_size(), ks is not None)
    out = torch.empty(b, h, 1, hd)
    for s in range(b):
        for g in range(kvh):
            qg = q[s, g * rep:(g + 1) * rep, 0].float()
            m_all = torch.full((rep,), TP.NEG_INF)
            a, l_all = torch.zeros(rep, hd), torch.zeros(rep)
            for c0, n in _split_runs(int(idx[s]), chunk, n_split):
                m = torch.full((rep,), TP.NEG_INF)
                l, acc = torch.zeros(rep), torch.zeros(rep, hd)
                for c in range(c0, c0 + n):
                    pos0 = c * chunk
                    page, off = pt[s, pos0 // ps], pos0 % ps
                    k = kp[page, g, off:off + chunk].float()
                    v = vp[page, g, off:off + chunk].float()
                    sc = (qg @ k.T) * hd ** -0.5
                    if ks is not None:
                        sc = sc * ks[page, g, off:off + chunk]
                    live = torch.arange(pos0, pos0 + chunk) <= idx[s]
                    sc = sc.masked_fill(~live, TP.NEG_INF)
                    m_cur = torch.maximum(m, sc.max(-1).values)
                    p = torch.exp(sc - m_cur[:, None])
                    alpha = torch.exp(m - m_cur)
                    l = l * alpha + p.sum(-1)
                    if vs is not None:
                        p = p * vs[page, g, off:off + chunk]
                    acc = acc * alpha[:, None] + p @ v.masked_fill(
                        ~live[:, None], 0)
                    m = m_cur
                m_new = torch.maximum(m_all, m)      # combine, split order
                f, f_i = torch.exp(m_all - m_new), torch.exp(m - m_new)
                a = a * f[:, None] + acc * f_i[:, None]
                l_all = l_all * f + l * f_i
                m_all = m_new
            out[s, g * rep:(g + 1) * rep, 0] = a / l_all.clamp(
                min=1e-30)[:, None]
    return out


# the wrapper's plan at these shapes (a split per 16-position chunk) and
# two splits of 8-position chunks, so that a split holds several chunks
SPLIT_PLANS = [None, (8, 2)]


@pytest.mark.parametrize("plan", SPLIT_PLANS, ids=["plan", "two_splits"])
@pytest.mark.parametrize("kvh,h", [(2, 4), (1, 4)])
def test_split_combine_matches_window_and_jax_kernel(plan, kvh, h):
    q, kp, vp, kn, vn = _inputs(6, h, kvh)
    want, kp_j, vp_j = _jax_fused(q, kp, vp, PAGE_TABLE, INDEX, kn, vn)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    kp_t, vp_t = t(kp), t(vp)
    TP.write_kv_rows(kp_t, vp_t, t(PAGE_TABLE), t(INDEX), t(kn), t(vn))
    got = _split_combine(t(q), kp_t, vp_t, PAGE_TABLE, INDEX, plan=plan)
    window = TP.window_attention(t(q), kp_t, vp_t, t(PAGE_TABLE), t(INDEX))
    np.testing.assert_allclose(got.numpy(), window.numpy(), atol=2e-5)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


@pytest.mark.parametrize("plan", SPLIT_PLANS, ids=["plan", "two_splits"])
def test_int8_split_combine_matches_window_and_jax_kernel(plan):
    from jax.experimental.pallas import tpu as pltpu

    q, kp, vp, ks, vs, kn, vn = _int8_inputs(7, 4, 2)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    pools = [t(kp), t(vp), t(ks), t(vs)]
    TP.write_kv_rows(*pools[:2], t(PAGE_TABLE), t(INDEX), t(kn), t(vn),
                     *pools[2:])
    got = _split_combine(t(q), *pools[:2], PAGE_TABLE, INDEX, *pools[2:],
                         plan=plan)
    window = TP.window_attention(t(q), *pools[:2], t(PAGE_TABLE), t(INDEX),
                                 *pools[2:])
    with pltpu.force_tpu_interpret_mode():    # the window, written already
        want = JP.paged_decode_attention(
            jnp.asarray(q), *(jnp.asarray(p.numpy()) for p in pools[:2]),
            jnp.asarray(PAGE_TABLE), jnp.asarray(INDEX),
            k_scale=jnp.asarray(pools[2].numpy()),
            v_scale=jnp.asarray(pools[3].numpy()))
    np.testing.assert_allclose(got.numpy(), window.numpy(), atol=2e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
