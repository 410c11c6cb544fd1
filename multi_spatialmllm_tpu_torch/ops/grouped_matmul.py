"""Grouped matrix products of the ragged MoE (K8): plain versions and ops.

`gmm`, `gmm(..., transpose_rhs=True)` and `tgmm` are backed by the
hand-written CUDA kernels of `csrc/grouped_matmul.cu` (entries `gmm`,
`gmm_t`, `tgmm`; they replace the megablox Pallas kernels that
`_pallas_gmm` calls in multi_spatialmllm_tpu/models/moe.py) when their
tensors lie on a CUDA device, and by `gmm_plain` / `tgmm_plain` when they
lie on the CPU. `grouped_matmul` is the differentiable op, the port of
`_pallas_gmm`'s custom VJP: dlhs by the transposed-rhs gmm, drhs by tgmm.

Rows are grouped by `group_sizes` `[E]` int32: row r belongs to group g
when `sum(group_sizes[:g]) <= r < sum(group_sizes[:g+1])`. Rows at or past
`sum(group_sizes)` come out zero. Products accumulate in float32 and round
once to lhs's dtype.

The bf16 `gmm` takes one of two kernels by M, a shape known on the host:
the general path (every form, any M) or, at `M <= ROWS_PATH_MAX` (decode
steps), the few-rows path, which swaps the operands so that the weights
stream through the tensor cores' 64-row side and cuts the contraction
into `rows_path_splits` parts (f32 partials in a workspace, summed in a
fixed order by a second kernel of the same call).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import CudaKernel, check_cuda_operand, check_tma_aligned, ptr

_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5  # a, b, sizes, out,
#                                                     M, K, N, E, bf16
_GMM_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6  # a, b, sizes, out,
#                                             ws, M, K, N, E, bf16, splits
GMM = CudaKernel("gmm", _GMM_ARGS, source="grouped_matmul")
GMM_T = CudaKernel("gmm_t", _ARGS, source="grouped_matmul")
TGMM = CudaKernel("tgmm", _ARGS, source="grouped_matmul")
MAX_GROUPS = 512                # the kernels' shared-memory offset table
# the few-rows kernel's limits and tiles (ROWS_MAX, RN and BK in the .cu)
ROWS_PATH_MAX = 64   # bf16 gmm at M <= this takes the few-rows kernel
ROWS_BLOCK = 128     # weight columns a few-rows item
K_STEP = 64          # contraction a pipeline stage
MIN_SPLIT_STEPS = 4  # stages a K split keeps at least
SMS_PER_ITEM = 4     # a K split only while items < SMs / SMS_PER_ITEM


def rows_path_splits(m: int, k: int, n: int, e: int, sms: int) -> int:
    """0 where the bf16 `gmm` of lhs `[m, k]` on `e` weight slabs `[k, n]`
    takes the general path; else the number of parts its contraction is
    cut into on the few-rows path. A split costs a pass over f32 partials
    and a second launch, and an item streams its weights fast enough that
    48 items on 132 SMs read the MoE decode step's weights at ~80% of the
    bytes bound (chip_smoke.py phase 10): so the parts double only while
    the items (live groups, at most min(e, m), times ROWS_BLOCK-column
    blocks, times parts) number fewer than a 1/SMS_PER_ITEM of the SMs,
    and each part keeps MIN_SPLIT_STEPS stages of K_STEP."""
    if not 0 < m <= ROWS_PATH_MAX:
        return 0
    items = min(e, m) * -(-n // ROWS_BLOCK)
    steps = -(-k // K_STEP)
    splits = 1
    while (items * splits * SMS_PER_ITEM < sms
           and 2 * splits * MIN_SPLIT_STEPS <= steps):
        splits *= 2
    return splits


def workspace_numel(m: int, n: int, splits: int) -> int:
    """float32 elements of the few-rows path's partials `[splits, m, n]`
    (none without a split)."""
    return splits * m * n if splits > 1 else 0


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The SMs of a CUDA device (a host property; no sync)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def group_bounds(group_sizes: torch.Tensor, m: int) -> list[tuple[int, int]]:
    """`[(start, end)]` of each group's rows, clamped to `m` (host values:
    the plain versions only)."""
    bounds, start = [], 0
    for size in group_sizes.tolist():
        end = start + max(int(size), 0)
        bounds.append((min(start, m), min(end, m)))
        start = end
    return bounds


def gmm_plain(lhs, rhs, group_sizes, transpose_rhs: bool = False):
    """`out[r] = lhs[r] @ rhs[g(r)]` (`rhs[g(r)].T` with `transpose_rhs`):
    lhs `[M, K]`, rhs `[E, K, N]` (`[E, N, K]` transposed) -> `[M, N]` in
    lhs's dtype, accumulated in float32."""
    n = rhs.shape[1] if transpose_rhs else rhs.shape[2]
    out = torch.zeros(lhs.shape[0], n, dtype=torch.float32,
                      device=lhs.device)
    for g, (s, e) in enumerate(group_bounds(group_sizes, lhs.shape[0])):
        if e > s:
            w = rhs[g].float()
            out[s:e] = lhs[s:e].float() @ (w.T if transpose_rhs else w)
    return out.to(lhs.dtype)


def tgmm_plain(lhs, dy, group_sizes):
    """`out[g] = lhs[rows of g].T @ dy[rows of g]`: lhs `[M, K]`, dy
    `[M, N]` -> `[E, K, N]` (zero for an empty group) in lhs's dtype,
    accumulated in float32."""
    e_groups = group_sizes.shape[0]
    out = torch.zeros(e_groups, lhs.shape[1], dy.shape[1],
                      dtype=torch.float32, device=lhs.device)
    for g, (s, e) in enumerate(group_bounds(group_sizes, lhs.shape[0])):
        if e > s:
            out[g] = lhs[s:e].float().T @ dy[s:e].float()
    return out.to(lhs.dtype)


def _check_dims(name: str, a: torch.Tensor, *dims: int) -> None:
    if a.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: unsupported dtype {a.dtype}")
    if a.dtype == torch.bfloat16 and any(d % 8 for d in dims):
        raise ValueError(f"{name}: bf16 widths {dims} must be multiples of "
                         f"8 (16-byte rows)")


def _check_sizes(name: str, group_sizes, dev) -> None:
    e = group_sizes.shape[0]
    if not 0 < e <= MAX_GROUPS:
        raise ValueError(f"{name}: {e} groups, at most {MAX_GROUPS}")
    check_cuda_operand("group_sizes", group_sizes, dev, torch.int32, (e,))


def gmm_cuda(lhs, rhs, group_sizes, transpose_rhs: bool = False):
    """Launch `gmm` (or `gmm_t` with `transpose_rhs`, reading rhs
    `[E, N, K]` transposed in the kernel) on CUDA tensors."""
    m, k = lhs.shape
    e = rhs.shape[0]
    n = rhs.shape[1] if transpose_rhs else rhs.shape[2]
    dev = lhs.device
    _check_dims("gmm", lhs, k, n)
    _check_sizes("gmm", group_sizes, dev)
    check_cuda_operand("lhs", lhs, dev, lhs.dtype, (m, k))
    check_cuda_operand("rhs", rhs, dev, lhs.dtype,
                       (e, n, k) if transpose_rhs else (e, k, n))
    bf16 = int(lhs.dtype == torch.bfloat16)
    if bf16:
        check_tma_aligned("lhs", lhs)
        check_tma_aligned("rhs", rhs)
    out = torch.empty(m, n, dtype=lhs.dtype, device=dev)
    if transpose_rhs:   # the kernel's names: dy [M, N'], rhs [E, K', N']
        GMM_T(ptr(lhs), ptr(rhs), ptr(group_sizes), ptr(out), m, n, k, e,
              bf16)
        return out
    splits = rows_path_splits(m, k, n, e, sm_count(dev)) if bf16 else 0
    ws = None
    if workspace_numel(m, n, splits):
        ws = torch.empty(workspace_numel(m, n, splits), dtype=torch.float32,
                         device=dev)
    GMM(ptr(lhs), ptr(rhs), ptr(group_sizes), ptr(out), ptr(ws), m, k, n, e,
        bf16, splits)
    return out


def tgmm_cuda(lhs, dy, group_sizes):
    """Launch `tgmm` on CUDA tensors (lhs and dy of one dtype)."""
    m, k = lhs.shape
    n = dy.shape[1]
    e = group_sizes.shape[0]
    dev = lhs.device
    _check_dims("tgmm", lhs, k, n)
    _check_sizes("tgmm", group_sizes, dev)
    check_cuda_operand("lhs", lhs, dev, lhs.dtype, (m, k))
    check_cuda_operand("dy", dy, dev, lhs.dtype, (m, n))
    if lhs.dtype == torch.bfloat16:
        check_tma_aligned("lhs", lhs)
        check_tma_aligned("dy", dy)
    out = torch.empty(e, k, n, dtype=lhs.dtype, device=dev)
    TGMM(ptr(lhs), ptr(dy), ptr(group_sizes), ptr(out), m, k, n, e,
         int(lhs.dtype == torch.bfloat16))
    return out


def gmm(lhs, rhs, group_sizes, transpose_rhs: bool = False):
    """The grouped product on CUDA tensors (the kernel, or raise) or on CPU
    tensors (the plain version)."""
    if lhs.is_cuda:
        return gmm_cuda(lhs.contiguous(), rhs.contiguous(), group_sizes,
                        transpose_rhs)
    if lhs.device.type == "cpu":
        return gmm_plain(lhs, rhs, group_sizes, transpose_rhs)
    raise ValueError(f"gmm: unsupported device {lhs.device}")


def tgmm(lhs, dy, group_sizes):
    """The per-group transposed product, dispatched as `gmm` is."""
    if lhs.is_cuda:
        return tgmm_cuda(lhs.contiguous(), dy.contiguous(), group_sizes)
    if lhs.device.type == "cpu":
        return tgmm_plain(lhs, dy, group_sizes)
    raise ValueError(f"tgmm: unsupported device {lhs.device}")


class GroupedMatmul(torch.autograd.Function):
    """`gmm(lhs, rhs, group_sizes)` with the custom VJP of `_pallas_gmm`:
    dlhs = gmm(dy, rhs, transpose_rhs=True), drhs = tgmm(lhs, dy) in rhs's
    dtype."""

    @staticmethod
    def forward(ctx, lhs, rhs, group_sizes):
        ctx.save_for_backward(lhs, rhs, group_sizes)
        return gmm(lhs, rhs, group_sizes)

    @staticmethod
    def backward(ctx, dy):
        lhs, rhs, group_sizes = ctx.saved_tensors
        dy = dy.to(lhs.dtype)
        dlhs = drhs = None
        if ctx.needs_input_grad[0]:
            dlhs = gmm(dy, rhs, group_sizes, transpose_rhs=True)
        if ctx.needs_input_grad[1]:
            drhs = tgmm(lhs, dy, group_sizes).to(rhs.dtype)
        return dlhs, drhs, None


def grouped_matmul(lhs, rhs, group_sizes):
    """Differentiable grouped product (see `GroupedMatmul`)."""
    return GroupedMatmul.apply(lhs, rhs, group_sizes)
