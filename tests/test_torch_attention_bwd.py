"""The port's flash-attention backward (multi_spatialmllm_tpu_torch.ops.
attention) against the JAX package: `flash_attention_bwd_plain` against the
Pallas backward kernels run in interpret mode (`_flash_bwd`, resident, and
`_flash_bwd_xl`, streaming over several blocks), given the JAX forward's
own o and lse; and the trainable autograd op against `jax.vjp` of
`reference_attention`. Inputs are numpy draws from fixed seeds, float32.

Tolerance: atol 2e-4, the JAX package's own backward-kernel tests'
(tests/test_models.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_spatialmllm_tpu.ops import attention as JA
from multi_spatialmllm_tpu_torch.ops import attention as TA

ATOL = 2e-4


def _inputs(seed, b, h, kvh, s, hd):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, h, s, hd), (b, kvh, s, hd), (b, kvh, s, hd),
                          (b, h, s, hd))]


def _segments(kind, b, s):
    if kind == "vit_pad":        # real tokens (id 0), then pads (id 1)
        seg = np.zeros((b, s), np.int32)
        seg[:, s - 40:] = 1
        return seg
    if kind == "packed":         # 1-based segments, trailing pad as id 0
        seg = np.zeros((b, s), np.int32)
        seg[:, :70], seg[:, 70:150], seg[:, 150:s - 30] = 1, 2, 3
        return seg
    if kind == "per_row":        # each row its own boundaries, inside tiles
        seg = np.zeros((b, s), np.int32)
        for r, starts in enumerate(((30, 100, 200), (50, 170))[:b]):
            for x in starts:
                seg[r, x:] += 1
        return seg
    if kind == "pad_tile":       # the last 128 keys (whole tiles) are pad
        seg = np.zeros((b, s), np.int32)
        seg[:, s - 128:] = 1
        return seg
    return None


CASES = {
    # b, h, kvh, s, hd, causal, segments
    "causal_mha": (2, 2, 2, 256, 64, True, None),
    "noncausal_gqa_kvh1": (1, 4, 1, 256, 32, False, None),
    "causal_gqa_kvh2": (2, 4, 2, 256, 64, True, None),
    "packed_segments_causal": (2, 4, 2, 256, 32, True, "packed"),
    "vit_pad_noncausal": (2, 2, 2, 256, 64, False, "vit_pad"),
    # the edges of the card kernels' 64- and 128-row tiles
    "s64_causal_gqa_hd64": (1, 4, 2, 64, 64, True, None),
    "s192_noncausal_kvh1_hd32": (2, 2, 1, 192, 32, False, None),
    "s320_causal_hd128": (1, 2, 2, 320, 128, True, None),
    "rep4_causal_hd128": (1, 8, 2, 256, 128, True, None),
    "segments_in_64_row_tiles_per_row": (2, 4, 2, 256, 64, True, "per_row"),
    "pad_key_tile_noncausal": (1, 4, 2, 384, 64, False, "pad_tile"),
}


def _port_bwd(q, k, v, o, lse, g, causal, seg):
    b, h, s, _ = q.shape
    t = [torch.from_numpy(np.array(a)) for a in (q, k, v, o)]
    lse_t = torch.from_numpy(np.array(lse)).reshape(b, h, s)
    return TA.flash_attention_bwd_plain(
        *t, lse_t, torch.from_numpy(g), causal,
        None if seg is None else torch.from_numpy(seg))


def _check(got, want):
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == w.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_bwd_matches_jax_flash_bwd_interpret(case):
    from jax.experimental.pallas import tpu as pltpu

    b, h, kvh, s, hd, causal, kind = CASES[case]
    q, k, v, g = _inputs(0, b, h, kvh, s, hd)
    seg = _segments(kind, b, s)
    jseg = None if seg is None else jnp.asarray(seg)
    sm = hd ** -0.5
    blk = 128 if s % 128 == 0 else 64   # the JAX kernels tile S exactly
    with pltpu.force_tpu_interpret_mode():
        o, lse = JA._flash_fwd(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal, sm, blk, blk,
                               segment_ids=jseg)
        want = JA._flash_bwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             o, lse, jnp.asarray(g), causal, sm, blk, blk,
                             segment_ids=jseg)
    _check(_port_bwd(q, k, v, o, lse, g, causal, seg), want)


@pytest.mark.parametrize("causal", [True, False],
                         ids=["causal", "noncausal"])
def test_plain_bwd_matches_jax_flash_bwd_xl_interpret(causal):
    """The streaming kernels at S 512 with 128-wide blocks (several blocks
    on both grid axes), GQA kvh 1."""
    from jax.experimental.pallas import tpu as pltpu

    q, k, v, g = _inputs(1, 1, 2, 1, 512, 64)
    sm = 64 ** -0.5
    with pltpu.force_tpu_interpret_mode():
        o, lse = JA._flash_fwd_xl(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal, sm, 128, 128)
        want = JA._flash_bwd_xl(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), o, lse, jnp.asarray(g),
                                causal, sm, 128, 128)
    _check(_port_bwd(q, k, v, o, lse, g, causal, None), want)


@pytest.mark.parametrize("kind", [None, "packed", "vit_pad"],
                         ids=["plain", "packed", "vit_pad"])
def test_trainable_op_grads_match_jax_vjp(kind):
    """The autograd op on CPU tensors (plain forward and backward) against
    `jax.vjp(reference_attention)`; the kernels' launch counts stay put."""
    causal = kind != "vit_pad"
    q, k, v, g = _inputs(2, 2, 4, 2, 192, 32)
    seg = _segments(kind, 2, 192)
    jseg = None if seg is None else jnp.asarray(seg)
    ref, vjp = jax.vjp(
        lambda q_, k_, v_: JA.reference_attention(
            q_, k_, v_, causal=causal, segment_ids=jseg),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    kernels = (TA.FLASH_FWD, TA.FLASH_BWD_DQ, TA.FLASH_BWD_DKV)
    before = [kern.launches for kern in kernels]
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    if seg is None:
        out = TA.trainable_flash_attention(*leaves, causal)
    else:
        out = TA.trainable_flash_attention_packed(
            *leaves, torch.from_numpy(seg), causal)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=1e-5)
    _check([t.grad for t in leaves], want)
    assert [kern.launches for kern in kernels] == before


def test_bwd_on_an_unsupported_device_raises():
    q = torch.empty(1, 2, 128, 32, device="meta")
    lse = torch.empty(1, 2, 128, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        TA.flash_attention_bwd(q, q, q, q, lse, q, True)
