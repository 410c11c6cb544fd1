"""Attention: the plain reference, the flash-attention forward and
backward ops, and the trainable op built on them.

`flash_attention_fwd` is backed by the hand-written CUDA kernel
`csrc/flash_fwd.cu` (it replaces the Pallas TPU kernels `_flash_fwd_kernel`
and `_flash_fwd_xl_kernel` of multi_spatialmllm_tpu/ops/attention.py);
`flash_attention_bwd` by the two kernels of `csrc/flash_bwd.cu` (dq, and
fused dk/dv; they replace `_flash_bwd_dq_kernel`/`_flash_bwd_dq_xl_kernel`
and `_flash_bwd_dkv_kernel`/`_flash_bwd_dkv_xl_kernel`). Each op launches
its kernels when its tensors lie on a CUDA device and runs its plain
version when they lie on the CPU. That device is the only switch.

`trainable_flash_attention` and `trainable_flash_attention_packed` go
through `FLASH_FWD_OP`, an op of its own (`torch.library`) whose outputs are
`(o, lse)` and whose autograd formula is the backward pair, as the JAX
package's custom-VJP functions of the same names are. Being an op of its
own, the forward is visible to torch's selective checkpointing (the
counterpart of JAX's `defvjp(..., optimize_remat=True)`): a remat policy
can save its outputs, so a rematerialised layer's backward never launches
the forward kernel again (models/llm.remat_layer).
"""

from __future__ import annotations

import ctypes

import torch

from ._build import CudaKernel, check_cuda_operand, check_tma_aligned, ptr

NEG_INF = -1e30

FLASH_FWD = CudaKernel("flash_fwd", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # q, k, v
    ctypes.c_void_p,                                     # seg (or NULL)
    ctypes.c_void_p, ctypes.c_void_p,                    # o, lse
    ctypes.c_int, ctypes.c_int, ctypes.c_int,            # B, H, KVH
    ctypes.c_int, ctypes.c_int,                          # S, D
    ctypes.c_int, ctypes.c_float, ctypes.c_int,          # causal, scale, bf16
])
_BWD_ARGS = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # q, k, v
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # dO, lse, delta
    ctypes.c_void_p,                                     # seg (or NULL)
]
_BWD_SHAPE = [
    ctypes.c_int, ctypes.c_int, ctypes.c_int,            # B, H, KVH
    ctypes.c_int, ctypes.c_int,                          # S, D
    ctypes.c_int, ctypes.c_float, ctypes.c_int,          # causal, scale, bf16
]
FLASH_BWD_DQ = CudaKernel(
    "flash_bwd_dq", [*_BWD_ARGS, ctypes.c_void_p, *_BWD_SHAPE],   # dq
    source="flash_bwd")
FLASH_BWD_DKV = CudaKernel(
    "flash_bwd_dkv",
    [*_BWD_ARGS, ctypes.c_void_p, ctypes.c_void_p, *_BWD_SHAPE],  # dk, dv
    source="flash_bwd")
KERNEL_HEAD_DIMS = (32, 64, 128)


def _repeat_kv(q, k, v):
    if k.shape[1] != q.shape[1]:
        rep = q.shape[1] // k.shape[1]
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    return k, v


def _masked_scores(q, k, causal, sm_scale, key_valid, segment_ids):
    """f32 scaled scores `[B, H, Sq, Sk]` with NEG_INF at masked keys."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * sm_scale
    if causal:
        n = q.shape[2]
        mask = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, NEG_INF)
    if key_valid is not None:
        s = s.masked_fill(~key_valid[:, None, None, :], NEG_INF)
    if segment_ids is not None:
        same = segment_ids[:, None, :, None] == segment_ids[:, None, None, :]
        s = s.masked_fill(~same, NEG_INF)
    return s


def reference_attention(q, k, v, causal=True, sm_scale=None, key_valid=None,
                        segment_ids=None):
    """Plain attention with the JAX package's `reference_attention`
    semantics: q `[B, H, S, hd]`, k/v `[B, KVH, S, hd]` (repeated here),
    optional `key_valid` `[B, S]` bool and `segment_ids` `[B, S]`
    (queries see only keys of the same segment)."""
    k, v = _repeat_kv(q, k, v)
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    s = _masked_scores(q, k, causal, sm_scale, key_valid, segment_ids)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(q.dtype), v)


def normalize_segments(segment_ids: torch.Tensor) -> torch.Tensor:
    """`[B, S]` ids -> int32 run indices 1, 2, 3, ... (cumsum of change
    points), as the JAX package's `_seg_rows` does: any contiguous-run
    layout becomes nondecreasing, which the kernel's tile skipping needs,
    and the equality mask is unchanged."""
    seg = segment_ids.to(torch.int32)
    changed = torch.ones_like(seg, dtype=torch.bool)
    changed[:, 1:] = seg[:, 1:] != seg[:, :-1]
    return torch.cumsum(changed.to(torch.int32), dim=1, dtype=torch.int32)


def flash_attention_fwd_plain(q, k, v, causal, segment_ids=None):
    """Plain version of the flash forward: `(o, lse)` with `lse` the f32
    logsumexp of the scaled, masked scores, `[B, H, S]`."""
    k, v = _repeat_kv(q, k, v)
    s = _masked_scores(q, k, causal, q.shape[-1] ** -0.5, None, segment_ids)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(q.dtype), v), lse


def _check_kernel_operands(name, q, k, v, segment_ids):
    """Raise unless q `[B, H, S, D]` and k/v `[B, KVH, S, D]` are what the
    kernels take; returns the normalised int32 segment ids (or None)."""
    b, h, s, d = q.shape
    kvh = k.shape[1]
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: unsupported dtype {q.dtype}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not in {KERNEL_HEAD_DIMS}")
    if kvh == 0 or h % kvh:
        raise ValueError(f"{name}: {h} heads over {kvh} kv heads")
    check_cuda_operand("q", q, q.device, q.dtype, (b, h, s, d))
    check_cuda_operand("k", k, q.device, q.dtype, (b, kvh, s, d))
    check_cuda_operand("v", v, q.device, q.dtype, (b, kvh, s, d))
    if segment_ids is None:
        return None
    seg = normalize_segments(segment_ids).contiguous()
    check_cuda_operand("segment_ids", seg, q.device, torch.int32, (b, s))
    return seg


def flash_attention_fwd_cuda(q, k, v, causal, segment_ids=None):
    """Launch the flash forward kernel: contiguous q `[B, H, S, D]`,
    k/v `[B, KVH, S, D]`, float32 or bfloat16, D in 32/64/128, each
    starting on a 16-byte boundary (raises otherwise; never falls back)."""
    b, h, s, d = q.shape
    kvh = k.shape[1]
    seg = _check_kernel_operands("flash_fwd", q, k, v, segment_ids)
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_tma_aligned(name, t)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    FLASH_FWD(ptr(q), ptr(k), ptr(v), ptr(seg), ptr(o), ptr(lse),
              b, h, kvh, s, d, int(causal), d ** -0.5,
              int(q.dtype == torch.bfloat16))
    return o, lse


def flash_attention_fwd(q, k, v, causal, segment_ids=None):
    """Flash-attention forward `(o, lse)`.

    q `[B, H, S, hd]`; k/v `[B, KVH, S, hd]` with KVH dividing H (GQA
    native: kv is never repeated on the kernel path); `segment_ids`
    `[B, S]` restricts attention to equal ids. On CUDA tensors this runs
    the kernel (or raises); on CPU tensors the plain version."""
    if q.is_cuda:
        return flash_attention_fwd_cuda(q.contiguous(), k.contiguous(),
                                        v.contiguous(), causal, segment_ids)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal, segment_ids)
    raise ValueError(f"flash_attention_fwd: unsupported device {q.device}")


def _delta(o, do):
    """rowsum(dO * O) in f32, `[B, H, S]` (an XLA pass outside the kernels
    in the JAX package too)."""
    return (do.float() * o.float()).sum(-1)


def flash_attention_bwd_plain(q, k, v, o, lse, do, causal, segment_ids=None):
    """Plain version of the flash backward: `(dq, dk, dv)` by the kernels'
    formulas in f32, p re-made from the saved `lse`; p and ds are rounded
    to the operand dtype before their products, as the kernels round them.
    dk/dv carry KVH heads: the group's q heads are summed."""
    dtype = q.dtype
    b, h, s, d = q.shape
    kvh = k.shape[1]
    scale = d ** -0.5
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    kr, vr = _repeat_kv(qf, kf, vf)
    sc = _masked_scores(qf, kr, causal, scale, None, segment_ids)
    p = torch.exp(sc - lse[..., None].float())
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vr)
    ds = p * (dp - _delta(o, do)[..., None]) * scale
    p, ds = p.to(dtype).float(), ds.to(dtype).float()
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kr)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dk = dk.reshape(b, kvh, h // kvh, s, d).sum(2)
    dv = dv.reshape(b, kvh, h // kvh, s, d).sum(2)
    return dq.to(dtype), dk.to(dtype), dv.to(dtype)


def flash_attention_bwd_cuda(q, k, v, o, lse, do, causal, segment_ids=None):
    """Launch the two backward kernels: dq, then fused dk/dv. Contiguous
    operands as for `flash_attention_fwd_cuda` (q, k, v and `do` on
    16-byte boundaries: raises otherwise, never falls back), `o`/`do`
    shaped like q, `lse` the forward's f32 `[B, H, S]`."""
    b, h, s, d = q.shape
    kvh = k.shape[1]
    seg = _check_kernel_operands("flash_bwd", q, k, v, segment_ids)
    check_cuda_operand("do", do, q.device, q.dtype, (b, h, s, d))
    check_cuda_operand("lse", lse, q.device, torch.float32, (b, h, s))
    for name, t in (("q", q), ("k", k), ("v", v), ("do", do)):
        check_tma_aligned(name, t)
    delta = _delta(o, do)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    shape = (b, h, kvh, s, d, int(causal), d ** -0.5,
             int(q.dtype == torch.bfloat16))
    FLASH_BWD_DQ(ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse), ptr(delta),
                 ptr(seg), ptr(dq), *shape)
    FLASH_BWD_DKV(ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse), ptr(delta),
                  ptr(seg), ptr(dk), ptr(dv), *shape)
    return dq, dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, causal, segment_ids=None):
    """Flash-attention backward `(dq, dk, dv)` from the forward's `o` and
    `lse` and the output gradient `do`; dk/dv at KVH heads. On CUDA
    tensors this runs the kernels (or raises); on CPU tensors the plain
    version."""
    if q.is_cuda:
        return flash_attention_bwd_cuda(
            q.contiguous(), k.contiguous(), v.contiguous(), o,
            lse.contiguous(), do.contiguous(), causal, segment_ids)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal,
                                         segment_ids)
    raise ValueError(f"flash_attention_bwd: unsupported device {q.device}")


# the op is defined through `torch.library.Library` rather than the
# `custom_op` decorator: that decorator wraps the kernel in
# `torch._disable_dynamo`, whose first call imports torch._dynamo (9.5-10 s
# in a fresh process on the card's host, scripts/torch_first_call_probe.py)
_LIB = torch.library.Library("msmllm_torch", "DEF")
_LIB.define("flash_attention_fwd(Tensor q, Tensor k, Tensor v, "
            "Tensor? segment_ids, bool causal) -> (Tensor, Tensor)")


def _flash_fwd_impl(q, k, v, segment_ids, causal):
    return flash_attention_fwd(q, k, v, causal, segment_ids)


_LIB.impl("flash_attention_fwd", _flash_fwd_impl,
          "CompositeExplicitAutograd")


@torch.library.register_fake("msmllm_torch::flash_attention_fwd")
def _(q, k, v, segment_ids, causal):
    b, h, s, _ = q.shape
    return torch.empty_like(q), q.new_empty((b, h, s), dtype=torch.float32)


def _flash_setup_context(ctx, inputs, output):
    q, k, v, segment_ids, causal = inputs
    o, lse = output
    ctx.save_for_backward(q, k, v, o, lse)
    ctx.segment_ids, ctx.causal = segment_ids, causal


def _flash_backward(ctx, do, dlse):
    """The backward pair from the saved `(o, lse)` (no forward recompute);
    `lse` feeds no loss, so its gradient is not read."""
    q, k, v, o, lse = ctx.saved_tensors
    dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, ctx.causal,
                                     ctx.segment_ids)
    return dq, dk, dv, None, None


torch.library.register_autograd("msmllm_torch::flash_attention_fwd",
                                _flash_backward,
                                setup_context=_flash_setup_context)
FLASH_FWD_OP = torch.ops.msmllm_torch.flash_attention_fwd.default


def trainable_flash_attention(q, k, v, causal=True):
    """Differentiable flash attention: q `[B, H, S, hd]`, k/v
    `[B, KVH, S, hd]` (GQA native; dk/dv come back at KVH heads)."""
    return FLASH_FWD_OP(q, k, v, None, causal)[0]


def trainable_flash_attention_packed(q, k, v, segment_ids, causal):
    """`trainable_flash_attention` with a block-diagonal segment mask:
    queries see only keys of the same id in `segment_ids` `[B, S]`
    (packed training rows; the ViT's pad segment with `causal=False`)."""
    return FLASH_FWD_OP(q, k, v, segment_ids, causal)[0]
