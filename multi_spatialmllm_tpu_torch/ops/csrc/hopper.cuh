// Hopper (sm_90a) building blocks as inline PTX: mbarriers, TMA tile loads,
// wgmma descriptors and instructions, and warpgroup register reallocation.
// Shared by the kernels of this directory; host code encodes the tensor maps
// (`encode_tensor_map`) through the function pointer the CUDA runtime
// hands out, so a library that includes this header needs no -lcuda.
//
// Conventions: shared-memory operands are 32-bit shared-window addresses
// (`smem_u32`); every tile that a wgmma descriptor reads with a swizzle
// starts on a 1024-byte boundary, so the descriptor's base offset is 0.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// two floats as a bf16 pair in one register, lo in the low half (round to
// nearest even)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also announces `bytes` of TMA transactions
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Blocks until the barrier's current phase parity differs from `parity`,
// i.e. until the phase numbered `parity` (mod 2) has completed. A wait that
// never ends (a producer and a consumer that disagree) traps after 2^28
// polls, so it surfaces as a launch failure instead of a hung device.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 28)) __trap();
  }
}

// Named barriers (ids 1-15; 0 is __syncthreads): `threads` counts both
// the threads that wait and those that only arrive, in whole warps.
__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------

// One box of a 3-D tensor map into shared memory; completion (the box's
// full byte count, zero-filled where it falls outside the tensor) is
// reported to `bar`. Coordinates are innermost first.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// One contiguous run of `bytes` (a multiple of 16; both addresses 16-byte
// aligned) from global into shared memory, no tensor map; completion is
// reported to `bar` like a TMA box's.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Swizzle of a tile whose rows are `bytes` long (128, 64 or 32): the TMA
// mode that writes it and the wgmma descriptor's layout type that reads it.
__host__ __device__ constexpr int desc_layout(int bytes) {
  return bytes == 128 ? 1 : bytes == 64 ? 2 : 3;
}

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (bytes, multiples of 16), layout type (desc_layout).
//   K-major swizzled operand (rows of `sw` bytes along K): LBO unused (1),
//     SBO = 8 rows * sw; a step of 16 elements along K adds 32 bytes to the
//     start address.
//   MN-major swizzled operand (each row of `sw` bytes holds sw/2
//     consecutive MN elements of one K index): LBO = the stride between
//     blocks of sw/2 MN elements, SBO = the stride between groups of 8 K
//     rows.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, int layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)layout << 62);
}

// orders register writes before the asynchronous products that read them
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous products (place after wgmma_wait, before the
// first product of a group).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

#define HOPPER_ACC8(d, i)                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),               \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define HOPPER_ACC16(d) HOPPER_ACC8(d, 0), HOPPER_ACC8(d, 8)
#define HOPPER_ACC32(d) HOPPER_ACC16(d), HOPPER_ACC8(d, 16), HOPPER_ACC8(d, 24)
#define HOPPER_ACC64(d)                                                     \
  HOPPER_ACC32(d), HOPPER_ACC8(d, 32), HOPPER_ACC8(d, 40),                  \
      HOPPER_ACC8(d, 48), HOPPER_ACC8(d, 56)

#define HOPPER_REGS16                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define HOPPER_REGS32                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define HOPPER_REGS64                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"

// Accumulator layout of m64nNk16 (f32, N/2 registers a thread): warp w of
// the warpgroup holds rows 16w..16w+15; with g = lane / 4 and t = lane % 4,
// register i holds row 16w + g + 8 * ((i / 2) % 2), column
// 8 * (i / 4) + 2 * t + i % 2. The A operand from registers (bf16, four
// 32-bit registers for one 16-deep step) is mma.sync's m16n8k16 A
// fragment: rows g and g + 8, columns 2t, 2t + 1 and 2t + 8, 2t + 9, the
// lower column in the low half.

// D[64 x 128] (+)= A[64 x 16] * B[16 x 128], bf16 in, f32 accumulate; A and
// B K-major in shared memory. scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64],
                                                    uint64_t da, uint64_t db,
                                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOPPER_REGS64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : HOPPER_ACC64(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

// The same at N = 64.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t da,
                                                   uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : HOPPER_ACC32(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x N] (+)= A[64 x 16] * B[16 x N] for a tile width N of 64 or 128.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  static_assert(N == 64 || N == 128, "wgmma_ss: N is 64 or 128");
  if constexpr (N == 128)
    wgmma_m64n128k16_ss(d, da, db, scale_d);
  else
    wgmma_m64n64k16_ss(d, da, db, scale_d);
}

#define HOPPER_ACC128(d)                                                    \
  HOPPER_ACC64(d), HOPPER_ACC8(d, 64), HOPPER_ACC8(d, 72),                  \
      HOPPER_ACC8(d, 80), HOPPER_ACC8(d, 88), HOPPER_ACC8(d, 96),           \
      HOPPER_ACC8(d, 104), HOPPER_ACC8(d, 112), HOPPER_ACC8(d, 120)
#define HOPPER_REGS8 "{%0, %1, %2, %3, %4, %5, %6, %7}"
#define HOPPER_REGS128                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "  \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "  \
  "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "  \
  "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "      \
  "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "      \
  "%122, %123, %124, %125, %126, %127}"

// D[64 x N] (+)= A[64 x 16] * B[16 x N], bf16 in, f32 accumulate, both
// operands in shared memory, each K-major (0) or MN-major (1, read
// transposed: TA for A, TB for B), for N = 16, 32, 64, 128 or 256.
// Operands: the N/2 accumulators, then da, db, scale_d, TA, TB.
#define HOPPER_WGMMA_SS_T(NN, REGS, ACC, IA, IB, IS, ITA, ITB)             \
  template <int TA, int TB>                                                 \
  __device__ __forceinline__ void wgmma_m64n##NN##k16_ss_t(                 \
      float (&d)[NN / 2], uint64_t da, uint64_t db, int scale_d) {          \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" IS ", 0;\n"           \
                 "wgmma.mma_async.sync.aligned.m64n" #NN                    \
                 "k16.f32.bf16.bf16 " REGS ", %" IA ", %" IB                \
                 ", p, 1, 1, %" ITA ", %" ITB ";\n}\n"                      \
                 : ACC(d)                                                   \
                 : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));       \
  }
#define HOPPER_ACC8_0(d) HOPPER_ACC8(d, 0)
HOPPER_WGMMA_SS_T(16, HOPPER_REGS8, HOPPER_ACC8_0, "8", "9", "10", "11", "12")
HOPPER_WGMMA_SS_T(32, HOPPER_REGS16, HOPPER_ACC16, "16", "17", "18", "19",
                  "20")
HOPPER_WGMMA_SS_T(64, HOPPER_REGS32, HOPPER_ACC32, "32", "33", "34", "35",
                  "36")
HOPPER_WGMMA_SS_T(128, HOPPER_REGS64, HOPPER_ACC64, "64", "65", "66", "67",
                  "68")
HOPPER_WGMMA_SS_T(256, HOPPER_REGS128, HOPPER_ACC128, "128", "129", "130",
                  "131", "132")
#undef HOPPER_WGMMA_SS_T

template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma_ss_t(float (&d)[N / 2], uint64_t da,
                                           uint64_t db, int scale_d) {
  static_assert(N == 16 || N == 32 || N == 64 || N == 128 || N == 256,
                "wgmma_ss_t: N is 16, 32, 64, 128 or 256");
  if constexpr (N == 16)
    wgmma_m64n16k16_ss_t<TA, TB>(d, da, db, scale_d);
  else if constexpr (N == 32)
    wgmma_m64n32k16_ss_t<TA, TB>(d, da, db, scale_d);
  else if constexpr (N == 64)
    wgmma_m64n64k16_ss_t<TA, TB>(d, da, db, scale_d);
  else if constexpr (N == 128)
    wgmma_m64n128k16_ss_t<TA, TB>(d, da, db, scale_d);
  else
    wgmma_m64n256k16_ss_t<TA, TB>(d, da, db, scale_d);
}

// Orders this thread's generic-proxy writes to shared memory before later
// reads of it by the async proxy (wgmma operands, TMA).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Start-address step (in the descriptor's 16-byte units) of the 16-deep
// slice kk along K of a K-major swizzled tile stored as boxes of
// [rows, sw / 2] (rows `sw` bytes long): the next 32 bytes of a row, or
// the next box.
__host__ __device__ constexpr uint32_t kmajor_step(int kk, int rows, int sw) {
  return (uint32_t)(((kk * 32 / sw) * rows * sw + (kk * 32) % sw) / 16);
}

// D[64 x N] += A[64 x 16] * B[16 x N], A from registers, B MN-major in
// shared memory (transposed read), bf16 in, f32 accumulate.
template <int N>
__device__ __forceinline__ void wgmma_rs_tnsp(float (&d)[N / 2],
                                              const uint32_t (&a)[4],
                                              uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs_tnsp<128>(float (&d)[64],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOPPER_REGS64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : HOPPER_ACC64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_tnsp<64>(float (&d)[32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : HOPPER_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_tnsp<32>(float (&d)[16],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " HOPPER_REGS16
      ", {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : HOPPER_ACC16(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

using EncodeTiledFn = decltype(&cuTensorMapEncodeTiled);

// cuTensorMapEncodeTiled, looked up once through the CUDA runtime
// (nullptr where it is not offered)
inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (err != cudaSuccess || status != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// A bf16 tensor [depth, rows, cols] (row-major, contiguous) as a 3-D map
// whose box is [1, box_rows, box_cols]; box_cols * 2 bytes is the row
// length of the swizzle (128, 64 or 32). Boxes past `rows` read zeros,
// never the next slab's rows. Returns a cudaError_t code.
inline int encode_tensor_map(CUtensorMap* map, const void* base, int depth,
                             int rows, int cols, int box_rows,
                             int box_cols) {
  EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(base) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const int row_bytes = box_cols * 2;
  const CUtensorMapSwizzle swizzle =
      row_bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
      : row_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                        : CU_TENSOR_MAP_SWIZZLE_32B;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)depth};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2,
                                 (cuuint64_t)rows * cols * 2};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
      dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace hopper
