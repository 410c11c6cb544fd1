"""Paged decode attention: the plain gather-window version and the op.

`paged_decode_attention` is backed by the hand-written CUDA kernels of
`csrc/paged_decode.cu` (they replace the Pallas TPU kernel
`_paged_decode_kernel` of multi_spatialmllm_tpu/ops/paged_attention.py with
the fused write: entry `paged_decode` for native pools, `paged_decode_int8`
for int8 pools with per-row float32 scales) when its tensors lie on a CUDA
device, and by `paged_decode_attention_plain` when they lie on the CPU.
Both land the step's kv rows (quantised, for int8 pools) in the pools IN
PLACE (the JAX package aliases the pools through the kernel instead).

The kernel splits each slot's live positions over a fixed number of CTAs
(`split_plan`, from the shapes alone) and combines their partial softmax
sums in split order.
Its tickets live in a buffer kept per device (`_tickets`), so calls on
one device must be ordered on one stream, as the serve loop's are.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import CudaKernel, check_cuda_operand, check_tma_aligned, ptr
from .attention import NEG_INF

# Guard for all-zero kv rows: scale floors here so dequantization of a
# zero row stays exactly zero instead of dividing by zero.
KV_QUANT_EPS = 1e-8

_TAIL_ARGS = [
    ctypes.c_void_p, ctypes.c_void_p,                    # workspace, tickets
    ctypes.c_int, ctypes.c_int, ctypes.c_int,            # B, H, KVH
    ctypes.c_int, ctypes.c_int, ctypes.c_int,            # ps, PPS, HD
    ctypes.c_int, ctypes.c_int,                          # chunk, n_split
    ctypes.c_float, ctypes.c_int,                        # scale, bf16
]
PAGED_DECODE = CudaKernel("paged_decode", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # q, k/v pages
    ctypes.c_void_p, ctypes.c_void_p,                    # page_table, index
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # k/v new, out
    *_TAIL_ARGS,
])
PAGED_DECODE_INT8 = CudaKernel("paged_decode_int8", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # q, k/v pages
    ctypes.c_void_p, ctypes.c_void_p,                    # k/v scales
    ctypes.c_void_p, ctypes.c_void_p,                    # page_table, index
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # k/v new, out
    *_TAIL_ARGS,
], source="paged_decode")
KERNEL_HEAD_DIMS = (32, 64, 128)
KERNEL_MAX_REP = 8          # q heads a kv head
# the kernel's split plan: a chunk (one bulk copy of K rows, one of V
# rows) holds at most 128 positions and 16 KB of K; a (slot, kv head) gets
# up to MAX_CTAS / (slots x kv heads) splits (8 at 8 slots and 8 kv
# heads), among which each call deals out its live chunks
CHUNK_POSITIONS = 128
CHUNK_BYTES = 16384
MAX_CTAS = 512


@functools.lru_cache(maxsize=64)
def split_plan(b: int, kvh: int, ps: int, pps: int, hd: int,
               pool_itemsize: int, quant: bool) -> tuple[int, int]:
    """`(chunk, n_split)`: each (slot, kv head) runs on `n_split` CTAs,
    among which the kernel deals out in order the live chunks of `chunk`
    positions 0..index // chunk (q or q + 1 consecutive chunks a split,
    over min(n_split, their count) splits). A chunk divides the page, so it lies in one page; an
    int8 chunk is a multiple of 4 positions, so its f32 scales copy in
    16-byte units. From the shapes alone, never from the indices: the
    launch is static and captures in a CUDA graph."""
    cap = min(ps, CHUNK_POSITIONS, CHUNK_BYTES // (hd * pool_itemsize))
    step = 4 if quant else 1
    fits = [c for c in range(step, cap + 1, step) if ps % c == 0]
    if not fits:
        raise ValueError(f"paged_decode: page size {ps} has no chunk of "
                         f"{step}-position steps up to {cap}")
    chunk = fits[-1]
    return chunk, max(1, min(pps * ps // chunk, MAX_CTAS // (b * kvh)))


def rep_slots(rep: int) -> int:
    """The kernel's q rows a kv head: rep rounded up to 1, 2, 4 or 8."""
    return next(n for n in (1, 2, 4, 8) if rep <= n)


_TICKETS: dict = {}


def _tickets(device: torch.device, n: int) -> torch.Tensor:
    """The kernel's tickets on `device`: at least `n` int32 zeros, kept
    across calls (the last CTA of each (slot, kv head) resets its own).
    Allocated outside any CUDA graph capture, so a captured call finds
    them made by an earlier eager one."""
    have = _TICKETS.get(device)
    if have is None or have.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "paged_decode: call it once outside the CUDA graph capture "
                "first (its ticket buffer is allocated then)")
        have = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _TICKETS[device] = have
    return have


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


def grouped_attention(q, k, v, valid):
    """Masked softmax attention with GQA kept grouped (the JAX package's
    decode-branch einsums, `llm.py:331-357`): q `[B, H, t, hd]`, k/v
    `[B, KVH, L, hd]`, valid `[B, t, L]` bool -> `[B, H, t, hd]`. Scores
    in float32, masked keys at NEG_INF, probabilities cast to q's dtype."""
    b, h, t, hd = q.shape
    kvh = k.shape[1]
    qg = q.reshape(b, kvh, h // kvh, t, hd)
    s = torch.einsum("bgrqd,bgkd->bgrqk", qg, k).float() * (hd ** -0.5)
    s = s.masked_fill(~valid[:, None, None], NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bgrqk,bgkd->bgrqd", p, v).reshape(b, h, t, hd)


def gather_window(pages, page_table, scale=None, dtype=None):
    """Each slot's pages in logical order: pool `[P, KVH, ps, hd]` and
    page_table `[B, PPS]` -> `[B, KVH, PPS * ps, hd]`; an int8 pool with
    its scales `[P, KVH, ps]` is dequantised (`int8.float() * scale`, cast
    to `dtype`)."""
    pt = page_table.long()
    w = pages[pt]                                # [B, PPS, KVH, ps, hd]
    if scale is not None:
        w = (w.float() * scale[pt][..., None]).to(dtype)
    b, pps, kvh, ps, hd = w.shape
    return w.transpose(1, 2).reshape(b, kvh, pps * ps, hd)


def window_attention(q, k_pages, v_pages, page_table, index, k_scale=None,
                     v_scale=None):
    """Attention of each slot's t query rows over its gathered page
    window, row i admitting logical positions <= index + i (the JAX
    package's gather path). q `[B, H, t, hd]`, pools `[P, KVH, ps, hd]`,
    page_table `[B, PPS]`, index `[B]` -> `[B, H, t, hd]`. With int8 pools
    and their scales `[P, KVH, ps]` the windows are dequantised first."""
    t = q.shape[2]
    k = gather_window(k_pages, page_table, k_scale, q.dtype)
    v = gather_window(v_pages, page_table, v_scale, q.dtype)
    pos = torch.arange(k.shape[2], device=q.device)
    cur = index.long()[:, None] + torch.arange(t, device=q.device)
    return grouped_attention(q, k, v, pos[None, None, :] <= cur[:, :, None])


def write_kv_chain(k_pages, v_pages, page_table, index, k, v, k_scale=None,
                   v_scale=None):
    """Scatter each slot's t kv rows k/v `[B, KVH, t, hd]` to the logical
    positions index .. index + t - 1, at (page_table[b, pos // ps],
    pos % ps), in place; for int8 pools (scales given) the rows are
    quantised with `quantize_kv_rows` and their scales land beside them."""
    ps = k_pages.shape[2]
    t = k.shape[2]
    logical = index.long()[:, None] + torch.arange(t, device=k.device)
    pages = torch.gather(page_table.long(), 1, logical // ps)     # [B, t]
    off = logical % ps
    k_rows, v_rows = k.transpose(1, 2), v.transpose(1, 2)   # [B, t, KVH, hd]
    if k_scale is not None:
        k_rows, k_scale[pages, :, off] = quantize_kv_rows(k_rows)
        v_rows, v_scale[pages, :, off] = quantize_kv_rows(v_rows)
    k_pages[pages, :, off] = k_rows.to(k_pages.dtype)
    v_pages[pages, :, off] = v_rows.to(v_pages.dtype)


def write_kv_rows(k_pages, v_pages, page_table, index, k_new, v_new,
                  k_scale=None, v_scale=None):
    """`write_kv_chain` of one row a slot: k_new/v_new `[B, KVH, hd]`."""
    write_kv_chain(k_pages, v_pages, page_table, index, k_new[:, :, None],
                   v_new[:, :, None], k_scale, v_scale)


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
    if kvh == 0 or h % kvh or h // kvh > KERNEL_MAX_REP:
        raise ValueError(f"paged_decode: {h} heads over {kvh} kv heads "
                         f"(at most {KERNEL_MAX_REP} a kv head)")
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
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("k_scale", k_scale), ("v_scale", v_scale)):
        if t is not None:
            check_tma_aligned(name, t)
    chunk, n_split = split_plan(b, kvh, ps, pps, hd, k_pages.element_size(),
                                quant)
    out = torch.empty_like(q)
    ws = torch.empty(b * kvh * n_split * rep_slots(h // kvh) * (hd + 2),
                     dtype=torch.float32, device=dev)
    tail = (ptr(ws), ptr(_tickets(dev, b * kvh)), b, h, kvh, ps, pps, hd,
            chunk, n_split, float(hd ** -0.5),
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
