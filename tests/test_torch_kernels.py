"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card. Every test here is marked `cuda` and skips on a
host without a CUDA device. This file imports no jax, so it also runs on
a machine without it (tests/conftest.py imports jax; skip it there):

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest -q

Tolerances: float32 outputs 1e-4 (flash forward, grouped matmul), 2e-4
(flash backward, the JAX backward test's own) and 2e-5 (paged decode, the
JAX package's own); bf16 outputs 2e-2 on unit-normal inputs (backward and
grouped matmul: 2e-2 and 1e-2 of the largest magnitude, and the
backward's relative RMS and worst 64-row-tile errors within 2x those of
the plain version on the same bf16 values), against the plain version run
in float32 on the same (bf16) values; pools (and int8 scale pools) after
the fused write bit-equal."""

import pytest
import torch

from multi_spatialmllm_tpu_torch.ops import attention as TA
from multi_spatialmllm_tpu_torch.ops import grouped_matmul as TG
from multi_spatialmllm_tpu_torch.ops import paged_attention as TP

pytestmark = pytest.mark.cuda

ATOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _normal(gen, dev, dtype, *shape):
    return torch.randn(*shape, generator=gen, device=dev).to(dtype)


FLASH_CASES = {
    # b, h, kvh, s, d, causal, segment starts (positions where the id steps
    # up); the bf16 forward's tiles are 128 rows of q and 128 keys
    "causal_gqa_s256_d64": (1, 4, 2, 256, 64, True, ()),
    "causal_ragged_s200_d32": (2, 4, 1, 200, 32, True, ()),
    "causal_mha_s130_d128": (1, 2, 2, 130, 128, True, ()),
    "vit_pad_segment_s256_d64": (2, 4, 4, 256, 64, False, (200,)),
    "noncausal_s96_d32": (1, 2, 1, 96, 32, False, ()),
    "s127_rep2_d64": (1, 4, 2, 127, 64, True, ()),
    "s129_rep1_d32": (1, 2, 2, 129, 32, True, ()),
    "s200_segments_in_tile_d128": (2, 4, 2, 200, 128, True, (70, 160)),
    "s1153_segment_in_tile_rep4_d64": (1, 8, 2, 1153, 64, True, (600,)),
    # the backward's tiles: dq 128 q rows x 64 keys, dk/dv 64 keys x 64
    # (hd 128) or 128 q rows; S a multiple of 64 but not of 128
    "s64_rep2_d64": (1, 4, 2, 64, 64, True, ()),
    "s192_noncausal_rep2_d32": (2, 4, 2, 192, 32, False, ()),
    "s320_causal_d128": (1, 2, 2, 320, 128, True, ()),
    "rep4_d128": (1, 8, 2, 256, 128, True, ()),
    # a boundary inside a 64-row q tile, each batch row its own
    "per_row_segments_in_tile_d64": (2, 4, 2, 256, 64, True,
                                     ((30, 100, 200), (50, 170))),
    # the last 128 keys (whole key tiles) are one pad segment
    "pad_key_tile_d128": (1, 4, 2, 384, 128, False, (256,)),
}
# forward only: at S 1 the one row sees only itself, so the backward's dq
# and dk are zero in exact arithmetic and a tolerance relative to the
# reference's largest value would measure rounding noise
FLASH_FWD_CASES = {**FLASH_CASES, "s1_rep4_d128": (1, 4, 1, 1, 128, True, ())}


def _segments(b, s, starts, dev):
    """`[B, S]` int32 ids stepping up by one at each of `starts` (or, where
    `starts` holds one tuple a batch row, at that row's own)."""
    if not starts:
        return None
    rows = starts if isinstance(starts[0], tuple) else (starts,) * b
    seg = torch.zeros(b, s, dtype=torch.int32, device=dev)
    for r, row_starts in enumerate(rows):
        for x in row_starts:
            seg[r, x:] += 1
    return seg


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(FLASH_FWD_CASES))
def test_flash_fwd_matches_plain(dev, case, dtype):
    b, h, kvh, s, d, causal, starts = FLASH_FWD_CASES[case]
    gen = torch.Generator(device=dev).manual_seed(0)
    q = _normal(gen, dev, dtype, b, h, s, d)
    k = _normal(gen, dev, dtype, b, kvh, s, d)
    v = _normal(gen, dev, dtype, b, kvh, s, d)
    seg = _segments(b, s, starts, dev)
    o, lse = TA.flash_attention_fwd(q, k, v, causal, seg)
    o_ref, lse_ref = TA.flash_attention_fwd_plain(
        q.float(), k.float(), v.float(), causal, seg)
    o_pl, _ = TA.flash_attention_fwd_plain(q, k, v, causal, seg)
    torch.cuda.synchronize()
    assert o.dtype == dtype and o.shape == q.shape
    assert (o.float() - o_ref).abs().max().item() <= ATOL[dtype]
    assert (lse - lse_ref).abs().max().item() <= 1e-3
    if dtype == torch.bfloat16:   # per 64-row tile, against bf16 rounding
        mine, yard = _normalised_errors(o, o_ref), _normalised_errors(
            o_pl, o_ref)
        assert all(a <= 2 * b for a, b in zip(mine, yard)), (mine, yard)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_bwd_matches_plain(dev, case, dtype):
    b, h, kvh, s, d, causal, starts = FLASH_CASES[case]
    gen = torch.Generator(device=dev).manual_seed(3)
    q, do = (_normal(gen, dev, dtype, b, h, s, d) for _ in range(2))
    k, v = (_normal(gen, dev, dtype, b, kvh, s, d) for _ in range(2))
    seg = _segments(b, s, starts, dev)
    o, lse = TA.flash_attention_fwd(q, k, v, causal, seg)
    got = TA.flash_attention_bwd(q, k, v, o, lse, do, causal, seg)
    # the reference takes its o and lse from the plain forward, not K1
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    o_ref, lse_ref = TA.flash_attention_fwd_plain(qf, kf, vf, causal, seg)
    want = TA.flash_attention_bwd_plain(qf, kf, vf, o_ref, lse_ref, dof,
                                        causal, seg)
    o_pl, lse_pl = TA.flash_attention_fwd_plain(q, k, v, causal, seg)
    plain = TA.flash_attention_bwd_plain(q, k, v, o_pl, lse_pl, do, causal,
                                         seg)
    torch.cuda.synchronize()
    assert (lse - lse_ref).abs().max().item() <= 1e-3
    for name, g, w, p in zip(("dq", "dk", "dv"), got, want, plain):
        assert g.dtype == dtype and g.shape == w.shape, name
        err = (g.float() - w).abs().max().item()
        tol = 2e-4 if dtype == torch.float32 else \
            2e-2 * w.abs().max().item()
        assert err <= tol, (name, err, tol)
        if dtype == torch.bfloat16:
            mine, yard = _normalised_errors(g, w), _normalised_errors(p, w)
            assert all(a <= 2 * b for a, b in zip(mine, yard)), \
                (name, mine, yard)


@pytest.mark.parametrize("case", ["s320_causal_d128",
                                  "per_row_segments_in_tile_d64",
                                  "s192_noncausal_rep2_d32"])
def test_flash_bwd_is_bit_identical_across_runs(dev, case):
    """No atomics: two runs of the backward on the same inputs give the
    same bits (the group sum of dk/dv is taken in one CTA, in order)."""
    b, h, kvh, s, d, causal, starts = FLASH_CASES[case]
    gen = torch.Generator(device=dev).manual_seed(8)
    q, do = (_normal(gen, dev, torch.bfloat16, b, h, s, d) for _ in range(2))
    k, v = (_normal(gen, dev, torch.bfloat16, b, kvh, s, d)
            for _ in range(2))
    seg = _segments(b, s, starts, dev)
    o, lse = TA.flash_attention_fwd(q, k, v, causal, seg)
    first = TA.flash_attention_bwd(q, k, v, o, lse, do, causal, seg)
    second = TA.flash_attention_bwd(q, k, v, o, lse, do, causal, seg)
    torch.cuda.synchronize()
    for name, a, c in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, c), name


def _normalised_errors(got, ref):
    """(relative RMS error, worst relative error of a 64-row tile along S,
    a tile's norm floored at 1% of the RMS tile norm): small tiles are
    read at their own scale, which max|err| against max|ref| does not."""
    def tile_norms(x):
        b, h, s, d = x.shape
        x = torch.nn.functional.pad(x, (0, 0, 0, -s % 64))
        return x.reshape(b * h, -1, 64 * d).norm(dim=-1)

    err = got.float() - ref
    e, r = tile_norms(err), tile_norms(ref)
    rms = r.norm() / r.numel() ** 0.5
    worst = (e / (r + 1e-2 * rms)).max()
    return (err.norm() / ref.norm()).item(), worst.item()


def test_trainable_flash_attention_grads_on_the_card(dev):
    """The autograd op on CUDA tensors: K1 forward, K2/K3 backward, against
    autograd through the plain reference (f32)."""
    gen = torch.Generator(device=dev).manual_seed(4)
    q = torch.randn(2, 4, 192, 64, generator=gen, device=dev)
    k, v = (torch.randn(2, 2, 192, 64, generator=gen, device=dev)
            for _ in range(2))
    seg = torch.tensor([1] * 100 + [2] * 60 + [0] * 32, device=dev)[None]
    seg = seg.expand(2, -1).contiguous()
    do = torch.randn(2, 4, 192, 64, generator=gen, device=dev)
    before = (TA.FLASH_FWD.launches, TA.FLASH_BWD_DQ.launches,
              TA.FLASH_BWD_DKV.launches)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    TA.trainable_flash_attention_packed(*leaves, seg, True).backward(do)
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    TA.reference_attention(*ref, causal=True, segment_ids=seg).backward(do)
    torch.cuda.synchronize()
    for a, r in zip(leaves, ref):
        assert (a.grad - r.grad).abs().max().item() <= 2e-4
    assert (TA.FLASH_FWD.launches, TA.FLASH_BWD_DQ.launches,
            TA.FLASH_BWD_DKV.launches) == tuple(n + 1 for n in before)


def test_flash_fwd_counts_launches(dev):
    q = torch.randn(1, 2, 64, 32, device=dev)
    before = TA.FLASH_FWD.launches
    TA.flash_attention_fwd(q, q, q, True)
    assert TA.FLASH_FWD.launches == before + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("h,kvh,ps,hd", [(4, 2, 16, 64), (32, 8, 64, 128),
                                         (8, 1, 64, 32), (3, 3, 8, 32)])
def test_paged_decode_matches_plain(dev, dtype, h, kvh, ps, hd):
    gen = torch.Generator(device=dev).manual_seed(1)
    b, pps, n_pages = 4, 4, 20
    pt = (torch.randperm(n_pages - 1, generator=gen, device=dev)[:b * pps]
          + 1).reshape(b, pps).to(torch.int32)
    pt[3, 1:] = 0                     # a short slot: tail at the sink
    # first page, last row of a page, first row of a fresh page, mid-page
    idx = torch.tensor([0, ps - 1, 2 * ps, ps // 2], dtype=torch.int32,
                       device=dev)
    q = _normal(gen, dev, dtype, b, h, 1, hd)
    kp = _normal(gen, dev, dtype, n_pages, kvh, ps, hd)
    vp = _normal(gen, dev, dtype, n_pages, kvh, ps, hd)
    kn = _normal(gen, dev, dtype, b, kvh, hd)
    vn = _normal(gen, dev, dtype, b, kvh, hd)
    kp_k, vp_k = kp.clone(), vp.clone()
    out = TP.paged_decode_attention(q, kp_k, vp_k, pt, idx, kn, vn)
    kp_p, vp_p = kp.clone(), vp.clone()
    TP.write_kv_rows(kp_p, vp_p, pt, idx, kn, vn)
    ref = TP.window_attention(q.float(), kp_p.float(), vp_p.float(), pt, idx)
    torch.cuda.synchronize()
    assert torch.equal(kp_k, kp_p) and torch.equal(vp_k, vp_p)
    atol = 2e-5 if dtype == torch.float32 else ATOL[dtype]
    assert (out.float() - ref).abs().max().item() <= atol


def test_paged_decode_ignores_garbage_past_index(dev):
    gen = torch.Generator(device=dev).manual_seed(2)
    q = torch.randn(1, 2, 1, 32, generator=gen, device=dev)
    kp = torch.randn(6, 1, 8, 32, generator=gen, device=dev)
    vp = torch.randn(6, 1, 8, 32, generator=gen, device=dev)
    kn = torch.randn(1, 1, 32, generator=gen, device=dev)
    vn = torch.randn(1, 1, 32, generator=gen, device=dev)
    pt = torch.tensor([[1, 2, 3]], dtype=torch.int32, device=dev)
    idx = torch.tensor([10], dtype=torch.int32, device=dev)
    out = TP.paged_decode_attention(q, kp.clone(), vp.clone(), pt, idx, kn,
                                    vn)
    for pool in (kp, vp):
        pool[3] = 1e4
        pool[0] = -1e4
        pool[2, :, 3:] = 1e4
    out2 = TP.paged_decode_attention(q, kp, vp, pt, idx, kn, vn)
    torch.cuda.synchronize()
    assert (out - out2).abs().max().item() <= 1e-6


def _paged_int8_inputs(gen, dev, dtype, b, h, kvh, ps, pps, hd, n_pages):
    """Quantised pools (through the plain quantiser), a page table, and
    positions at the first page, a page's last row, a fresh page and
    mid-page."""
    from multi_spatialmllm_tpu_torch.ops.paged_attention import (
        quantize_kv_rows,
    )

    pt = (torch.randperm(n_pages - 1, generator=gen, device=dev)[:b * pps]
          + 1).reshape(b, pps).to(torch.int32)
    idx = torch.tensor([0, ps - 1, 2 * ps, ps // 2][:b], dtype=torch.int32,
                       device=dev)
    kp, ks = quantize_kv_rows(_normal(gen, dev, dtype, n_pages, kvh, ps, hd))
    vp, vs = quantize_kv_rows(_normal(gen, dev, dtype, n_pages, kvh, ps, hd))
    q = _normal(gen, dev, dtype, b, h, 1, hd)
    kn = _normal(gen, dev, dtype, b, kvh, hd)
    vn = _normal(gen, dev, dtype, b, kvh, hd)
    return q, kp, vp, ks, vs, pt, idx, kn, vn


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("h,kvh,ps,hd", [(4, 2, 16, 64), (16, 8, 128, 128),
                                         (8, 1, 64, 32)])
def test_paged_decode_int8_matches_plain(dev, dtype, h, kvh, ps, hd):
    gen = torch.Generator(device=dev).manual_seed(5)
    q, kp, vp, ks, vs, pt, idx, kn, vn = _paged_int8_inputs(
        gen, dev, dtype, 4, h, kvh, ps, 4, hd, 20)
    pools_k = [t.clone() for t in (kp, vp, ks, vs)]
    before = TP.PAGED_DECODE_INT8.launches
    out = TP.paged_decode_attention(q, *pools_k[:2], pt, idx, kn, vn,
                                    *pools_k[2:])
    pools_p = [t.clone() for t in (kp, vp, ks, vs)]
    TP.write_kv_rows(*pools_p[:2], pt, idx, kn, vn, *pools_p[2:])
    ref = TP.window_attention(q.float(), *pools_p[:2], pt, idx,
                              *pools_p[2:])
    torch.cuda.synchronize()
    assert TP.PAGED_DECODE_INT8.launches == before + 1
    for a, b in zip(pools_k, pools_p):
        assert torch.equal(a, b)
    atol = 2e-5 if dtype == torch.float32 else ATOL[dtype]
    assert (out.float() - ref).abs().max().item() <= atol


def _paged_split_case(dev, dtype, quant, b, h, kvh, ps, pps, hd, index,
                      sink=False, seed=7):
    """The kernel at the split plan's edges against the plain version:
    pools (and int8 scale pools) bit-equal after the fused write, the
    output within tolerance, a second call on the same inputs
    bit-identical. With `sink` every table entry is the sink page and all
    slots feed one new row, as idle slots do."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    n_pages = b * pps + 1
    pt = (torch.randperm(n_pages - 1, generator=gen, device=dev)[:b * pps]
          + 1).reshape(b, pps).to(torch.int32)
    if sink:
        pt.zero_()
    idx = torch.tensor(index, dtype=torch.int32, device=dev)
    pools = [_normal(gen, dev, dtype, n_pages, kvh, ps, hd)
             for _ in range(2)]
    if quant:
        (kp, ks), (vp, vs) = map(TP.quantize_kv_rows, pools)
        pools = [kp, vp, ks, vs]
    q = _normal(gen, dev, dtype, b, h, 1, hd)
    kn = _normal(gen, dev, dtype, b, kvh, hd)
    vn = _normal(gen, dev, dtype, b, kvh, hd)
    if sink:
        kn, vn = (t[:1].expand_as(t).contiguous() for t in (kn, vn))
    got = [t.clone() for t in pools]
    out = TP.paged_decode_attention(q, *got[:2], pt, idx, kn, vn, *got[2:])
    again = TP.paged_decode_attention(q, *got[:2], pt, idx, kn, vn,
                                      *got[2:])
    want = [t.clone() for t in pools]
    TP.write_kv_rows(*want[:2], pt, idx, kn, vn, *want[2:])
    kv = want[:2] if quant else [t.float() for t in want]
    ref = TP.window_attention(q.float(), *kv, pt, idx, *want[2:])
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    assert torch.equal(out, again)
    atol = 2e-5 if dtype == torch.float32 else ATOL[dtype]
    assert (out.float() - ref).abs().max().item() <= atol


@pytest.mark.parametrize("quant", [False, True], ids=["native", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", [
    # b, h, kvh, ps, pps, hd, index: 64-position chunks, a split each;
    # index at a chunk's last, first and second position and in the last
    (4, 8, 2, 64, 4, 128, [63, 64, 65, 255]),
    # 8 x 8 (slot, kv head)s get 8 splits: up to 5 chunks a split
    (8, 16, 8, 64, 40, 64, [127, 128, 129, 2559, 0, 5, 700, 1000]),
    # one slot deep, the others at index 0
    (4, 4, 2, 64, 16, 32, [1023, 0, 0, 0]),
], ids=["chunk_edges", "several_chunks_a_split", "skewed"])
def test_paged_decode_split_edges(dev, case, dtype, quant):
    _paged_split_case(dev, dtype, quant, *case)


@pytest.mark.parametrize("quant", [False, True], ids=["native", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_paged_decode_every_slot_idle(dev, dtype, quant):
    _paged_split_case(dev, dtype, quant, 4, 8, 2, 16, 4, 64, [0] * 4,
                      sink=True)


@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("rep", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_paged_decode_rep_and_head_dim(dev, dtype, rep, hd):
    _paged_split_case(dev, dtype, False, 3, 2 * rep, 2, 16, 6, hd,
                      [15, 16, 95])


@pytest.mark.parametrize("ps", [16, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_paged_decode_int8_page_sizes(dev, dtype, ps):
    _paged_split_case(dev, dtype, True, 4, 8, 4, ps, 3, 128,
                      [0, ps - 1, ps, 3 * ps - 1])


def test_paged_decode_refuses_rep_over_8(dev):
    q = torch.zeros(1, 16, 1, 32, device=dev)
    pool = torch.zeros(2, 1, 16, 32, device=dev)
    row = torch.zeros(1, 1, 32, device=dev)
    pt = torch.ones(1, 1, dtype=torch.int32, device=dev)
    idx = torch.zeros(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="at most 8"):
        TP.paged_decode_attention(q, pool, pool, pt, idx, row, row)


# (rows M, contraction K, output N, group sizes): an empty group, a group
# boundary inside a 128-row tile, rows past the groups' total, sum == M;
# bf16 gmm at M <= 64 takes the few-rows kernel (a K split where K is deep
# enough), every other call the general one
GMM_CASES = {
    "empty_group_midtile": (300, 64, 96, [70, 0, 150, 60]),
    "tail_rows_zero": (256, 128, 136, [10, 100, 40]),
    "sum_equals_m": (384, 40, 256, [128, 129, 127]),
    "one_group": (130, 64, 64, [130]),
    # a decode step's rows (8 slots, top 2): four groups in one partial tile
    "decode_rows": (16, 256, 512, [5, 0, 7, 4]),
    "e64_mostly_empty": (300, 128, 192, [0] * 5 + [90] + [0] * 30 + [1]
                         + [0] * 20 + [150] + [0] * 6 + [40]),
    "group_inside_one_tile": (400, 64, 128, [100, 20, 280]),
    "one_row_group": (200, 64, 128, [60, 1, 139]),
    "m1": (1, 512, 256, [0, 1, 0]),
    "m16_split_k": (16, 2048, 1024, [5, 0, 7, 4]),
    "m64": (64, 1024, 512, [20, 0, 44]),
    "m65": (65, 1024, 512, [20, 0, 44]),
    "m33_rows_past_total": (33, 2048, 256, [10, 12]),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(GMM_CASES))
def test_grouped_matmul_matches_plain(dev, case, dtype):
    m, k, n, sizes = GMM_CASES[case]
    gen = torch.Generator(device=dev).manual_seed(6)
    e = len(sizes)
    gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
    lhs = _normal(gen, dev, dtype, m, k)
    # weights at a fan-in scale, as the model's: products stay O(1) at
    # every depth, so the absolute f32 tolerance reads rounding alone
    rhs = (torch.randn(e, k, n, generator=gen, device=dev)
           * k ** -0.5).to(dtype)
    dy = _normal(gen, dev, dtype, m, n)
    got = (TG.gmm(lhs, rhs, gs), TG.gmm(dy, rhs, gs, transpose_rhs=True),
           TG.tgmm(lhs, dy, gs))
    want = (TG.gmm_plain(lhs.float(), rhs.float(), gs),
            TG.gmm_plain(dy.float(), rhs.float(), gs, transpose_rhs=True),
            TG.tgmm_plain(lhs.float(), dy.float(), gs))
    torch.cuda.synchronize()
    for name, g, w in zip(("gmm", "gmm_t", "tgmm"), got, want):
        assert g.dtype == dtype and g.shape == w.shape, name
        tol = 1e-4 if dtype == torch.float32 else \
            1e-2 * w.abs().max().item()
        assert (g.float() - w).abs().max().item() <= tol, name
    total = sum(sizes)
    assert not got[0][total:].any() and not got[1][total:].any()
    for g_idx, size in enumerate(sizes):
        if size == 0:
            assert not got[2][g_idx].any()


def test_grouped_matmul_grads_on_the_card(dev):
    """The autograd op on CUDA tensors: gmm forward, gmm_t and tgmm
    backward, against autograd through the plain version (f32)."""
    gen = torch.Generator(device=dev).manual_seed(7)
    gs = torch.tensor([50, 0, 90, 60], dtype=torch.int32, device=dev)
    lhs = torch.randn(200, 64, generator=gen, device=dev)
    rhs = torch.randn(4, 64, 80, generator=gen, device=dev)
    dy = torch.randn(200, 80, generator=gen, device=dev)
    counts = [k.launches for k in (TG.GMM, TG.GMM_T, TG.TGMM)]
    a = [t.clone().requires_grad_() for t in (lhs, rhs)]
    TG.grouped_matmul(*a, gs).backward(dy)
    r = [t.clone().requires_grad_() for t in (lhs, rhs)]
    TG.gmm_plain(*r, gs.cpu()).backward(dy)
    torch.cuda.synchronize()
    for x, y in zip(a, r):
        assert (x.grad - y.grad).abs().max().item() <= 2e-4
    assert [k.launches for k in (TG.GMM, TG.GMM_T, TG.TGMM)] == \
        [c + 1 for c in counts]


def test_grouped_matmul_split_k_is_bitwise_repeatable(dev):
    """The few-rows path with a K split sums its f32 partials in a fixed
    order: two calls give the same bits, and they agree with the general
    path and the unsplit few-rows path (the same entry point) to bf16
    rounding; so does the wrapper's own split (one row, one live group)."""
    gen = torch.Generator(device=dev).manual_seed(8)
    m, k, n, sizes = 16, 8192, 2048, [5, 0, 7, 4]
    gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
    lhs = _normal(gen, dev, torch.bfloat16, m, k)
    rhs = (torch.randn(4, k, n, generator=gen, device=dev)
           * k ** -0.5).to(torch.bfloat16)
    ws = torch.empty(8 * m * n, dtype=torch.float32, device=dev)

    def entry(splits):
        out = torch.empty(m, n, dtype=torch.bfloat16, device=dev)
        TG.GMM(TG.ptr(lhs), TG.ptr(rhs), TG.ptr(gs), TG.ptr(out),
               TG.ptr(ws), m, k, n, 4, 1, splits)
        return out

    first, second = entry(8), entry(8)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    want = TG.gmm_plain(lhs.float(), rhs.float(), gs)
    tol = 1e-2 * want.abs().max().item()
    for got in (first, entry(0), entry(1)):
        assert (got.float() - want).abs().max().item() <= tol
    one = torch.tensor([0, 1, 0, 0], dtype=torch.int32, device=dev)
    assert TG.rows_path_splits(1, k, n, 4, TG.sm_count(dev)) > 1
    a, b = TG.gmm(lhs[:1], rhs, one), TG.gmm(lhs[:1], rhs, one)
    want = TG.gmm_plain(lhs[:1].float(), rhs.float(), one)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert (a.float() - want).abs().max().item() <= \
        1e-2 * want.abs().max().item()


def test_ragged_moe_runs_with_no_host_sync(dev):
    """One ragged MoE layer forward and backward on K8 under
    `set_sync_debug_mode("error")`: the routing count and the three
    grouped products never wait on the device."""
    import dataclasses

    from multi_spatialmllm_tpu_torch.models import mllm as TM
    from multi_spatialmllm_tpu_torch.models import moe as TMoE

    cfg = dataclasses.replace(TM.tiny_moe_config().llm, dtype="bfloat16",
                              moe_impl="ragged", moe_kernel="pallas")
    gen = torch.Generator(device=dev).manual_seed(9)
    mlp = TMoE.MoEMLP(cfg, device=dev)
    for p in mlp.parameters():
        p.data.copy_(torch.randn(p.shape, generator=gen, device=dev) * 0.1)
    # 96 token copies (the general kernels) and a decode step's 16 (the
    # few-rows gmm)
    xs = [torch.randn(b, t, cfg.hidden_size, generator=gen,
                      device=dev).to(torch.bfloat16).requires_grad_()
          for b, t in ((2, 24), (8, 1))]
    valid = torch.ones(2, 24, dtype=torch.bool, device=dev)
    valid[1, 20:] = False

    def step():
        for x, v in zip(xs, (valid, None)):
            y, aux = mlp(x, valid=v)
            (y.float().square().sum() + aux).backward()

    step()                      # builds the kernels outside the check
    torch.cuda.synchronize()
    counts = [k.launches for k in (TG.GMM, TG.GMM_T, TG.TGMM)]
    torch.cuda.set_sync_debug_mode("error")
    try:
        step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert [k.launches for k in (TG.GMM, TG.GMM_T, TG.TGMM)] == \
        [c + n for c, n in zip(counts, (6, 6, 6))]
    assert all(torch.isfinite(p.grad).all() for p in mlp.parameters())
