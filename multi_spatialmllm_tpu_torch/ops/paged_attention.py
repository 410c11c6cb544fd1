"""Paged decode attention: the plain gather-window version and the op.

`paged_decode_attention` is backed by the hand-written CUDA kernels of
`csrc/paged_decode.cu` (they replace the Pallas TPU kernel
`_paged_decode_kernel` of multi_spatialmllm_tpu/ops/paged_attention.py with
the fused write: entry `paged_decode` for native pools, `paged_decode_int8`
for int8 pools with per-row float32 scales) when its tensors lie on a CUDA
device, and by `paged_decode_attention_plain` when they lie on the CPU.
Both land the step's kv rows (quantised, for int8 pools) in the pools IN
PLACE (the JAX package aliases the pools through the kernel instead).
"""

from __future__ import annotations

import ctypes

import torch

from ._build import CudaKernel, check_cuda_operand, ptr
from .attention import NEG_INF

# Guard for all-zero kv rows: scale floors here so dequantization of a
# zero row stays exactly zero instead of dividing by zero.
KV_QUANT_EPS = 1e-8

PAGED_DECODE = CudaKernel("paged_decode", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # q, k/v pages
    ctypes.c_void_p, ctypes.c_void_p,                    # page_table, index
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # k/v new, out
    ctypes.c_int, ctypes.c_int, ctypes.c_int,            # B, H, KVH
    ctypes.c_int, ctypes.c_int, ctypes.c_int,            # ps, PPS, HD
    ctypes.c_float, ctypes.c_int,                        # scale, bf16
])
PAGED_DECODE_INT8 = CudaKernel("paged_decode_int8", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # q, k/v pages
    ctypes.c_void_p, ctypes.c_void_p,                    # k/v scales
    ctypes.c_void_p, ctypes.c_void_p,                    # page_table, index
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # k/v new, out
    ctypes.c_int, ctypes.c_int, ctypes.c_int,            # B, H, KVH
    ctypes.c_int, ctypes.c_int, ctypes.c_int,            # ps, PPS, HD
    ctypes.c_float, ctypes.c_int,                        # scale, bf16
], source="paged_decode")
KERNEL_HEAD_DIMS = (32, 64, 128)


def quantize_kv_rows(rows: torch.Tensor):
    """Symmetric per-row int8 quantization of kv rows: `[..., hd]` ->
    `(int8 [..., hd], f32 scales [...])` with rows ~= int8 * scale. The
    int8 pools' writes (prefill insert, the plain decode write and, with
    the same formula, the kernel's fused write) all go through it."""
    r = rows.float()
    # a 0-d tensor on r's device, not a Python number: PyTorch multiplies a
    # CUDA tensor by the reciprocal of a scalar divisor, a bit off max/127
    # (filled on the device: no copy from the host)
    qmax = torch.full((), 127.0, device=r.device)
    scale = torch.clamp(r.abs().amax(dim=-1) / qmax, min=KV_QUANT_EPS)
    q = torch.clamp(torch.round(r / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def window_attention(q, k_pages, v_pages, page_table, index, k_scale=None,
                     v_scale=None):
    """One-token attention of each slot over its gathered page window,
    admitting logical positions <= index (the JAX package's gather path).
    q `[B, H, 1, hd]`, pools `[P, KVH, ps, hd]`, page_table `[B, PPS]`,
    index `[B]` -> `[B, H, 1, hd]`. With int8 pools and their scales
    `[P, KVH, ps]` the windows are dequantised first (`int8.float() *
    scale`, cast to q's dtype)."""
    b, h, _, hd = q.shape
    kvh = k_pages.shape[1]
    rep = h // kvh
    pt = page_table.long()
    kw, vw = k_pages[pt], v_pages[pt]            # [B, PPS, KVH, ps, hd]
    if k_scale is not None:
        kw = (kw.float() * k_scale[pt][..., None]).to(q.dtype)
        vw = (vw.float() * v_scale[pt][..., None]).to(q.dtype)
    win = kw.shape[1] * kw.shape[3]
    k = kw.transpose(1, 2).reshape(b, kvh, win, hd)
    v = vw.transpose(1, 2).reshape(b, kvh, win, hd)
    qg = q.reshape(b, kvh, rep, 1, hd)
    s = torch.einsum("bgrqd,bgkd->bgrqk", qg, k).float() * (hd ** -0.5)
    pos = torch.arange(win, device=q.device)
    valid = pos[None, :] <= index.long()[:, None]          # [B, win]
    s = s.masked_fill(~valid[:, None, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bgrqk,bgkd->bgrqd", p, v).reshape(b, h, 1, hd)


def write_kv_rows(k_pages, v_pages, page_table, index, k_new, v_new,
                  k_scale=None, v_scale=None):
    """Scatter each slot's `[KVH, hd]` row to (page_table[b, index//ps],
    index % ps), in place; for int8 pools (scales given) the rows are
    quantised with `quantize_kv_rows` and their scales land beside them."""
    ps = k_pages.shape[2]
    idx = index.long()
    rows = torch.arange(idx.shape[0], device=idx.device)
    page = page_table.long()[rows, idx // ps]
    if k_scale is not None:
        k_new, ks = quantize_kv_rows(k_new)
        v_new, vs = quantize_kv_rows(v_new)
        k_scale[page, :, idx % ps] = ks
        v_scale[page, :, idx % ps] = vs
    k_pages[page, :, idx % ps] = k_new
    v_pages[page, :, idx % ps] = v_new


def paged_decode_attention_plain(q, k_pages, v_pages, page_table, index,
                                 k_new, v_new, k_scale=None, v_scale=None):
    """Plain version of the op: in-place write, then the window path."""
    write_kv_rows(k_pages, v_pages, page_table, index, k_new, v_new, k_scale,
                  v_scale)
    return window_attention(q, k_pages, v_pages, page_table, index, k_scale,
                            v_scale)


def paged_decode_attention_cuda(q, k_pages, v_pages, page_table, index,
                                k_new, v_new, k_scale=None, v_scale=None):
    """Launch the paged decode kernel (pools, and the scale pools of int8
    pools, updated in place)."""
    b, h, t, hd = q.shape
    n_pages, kvh, ps, _ = k_pages.shape
    pps = page_table.shape[1]
    if t != 1:
        raise ValueError("paged_decode: one decode position per slot")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"paged_decode: unsupported dtype {q.dtype}")
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"paged_decode: head dim {hd} not in {KERNEL_HEAD_DIMS}")
    if kvh == 0 or h % kvh:
        raise ValueError(f"paged_decode: {h} heads over {kvh} kv heads")
    dev = q.device
    quant = k_scale is not None
    check_cuda_operand("q", q, dev, q.dtype, (b, h, 1, hd))
    for name, pool in (("k_pages", k_pages), ("v_pages", v_pages)):
        check_cuda_operand(name, pool, dev, torch.int8 if quant else q.dtype,
                           (n_pages, kvh, ps, hd))
    if quant:
        for name, sc in (("k_scale", k_scale), ("v_scale", v_scale)):
            check_cuda_operand(name, sc, dev, torch.float32,
                               (n_pages, kvh, ps))
    check_cuda_operand("page_table", page_table, dev, torch.int32, (b, pps))
    check_cuda_operand("index", index, dev, torch.int32, (b,))
    for name, row in (("k_new", k_new), ("v_new", v_new)):
        check_cuda_operand(name, row, dev, q.dtype, (b, kvh, hd))
    out = torch.empty_like(q)
    tail = (b, h, kvh, ps, pps, hd, float(hd ** -0.5),
            int(q.dtype == torch.bfloat16))
    if quant:
        PAGED_DECODE_INT8(ptr(q), ptr(k_pages), ptr(v_pages), ptr(k_scale),
                          ptr(v_scale), ptr(page_table), ptr(index),
                          ptr(k_new), ptr(v_new), ptr(out), *tail)
    else:
        PAGED_DECODE(ptr(q), ptr(k_pages), ptr(v_pages), ptr(page_table),
                     ptr(index), ptr(k_new), ptr(v_new), ptr(out), *tail)
    return out


def paged_decode_attention(q, k_pages, v_pages, page_table, index, k_new,
                           v_new, k_scale=None, v_scale=None):
    """Decode-step attention over paged KV pools with the fused write.

    q `[B, H, 1, hd]`; pools `[P, KVH, ps, hd]` (updated in place), in q's
    dtype, or int8 with `k_scale`/`v_scale` `[P, KVH, ps]` float32 (also
    updated in place); page_table `[B, PPS]` int32 listing each slot's pages
    in logical order, unallocated entries at the sink page 0; index `[B]`
    int32, the position of the current row; k_new/v_new `[B, KVH, hd]` in
    q's dtype. Returns `[B, H, 1, hd]`. On CUDA tensors this runs the kernel
    (or raises); on CPU tensors the plain version."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("paged_decode_attention: pass both scale pools")
    if q.is_cuda:
        return paged_decode_attention_cuda(
            q.contiguous(), k_pages, v_pages, page_table, index,
            k_new.contiguous(), v_new.contiguous(), k_scale, v_scale)
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pages, v_pages, page_table,
                                            index, k_new, v_new, k_scale,
                                            v_scale)
    raise ValueError(f"paged_decode_attention: unsupported device {q.device}")
