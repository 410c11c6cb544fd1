// Grouped matrix products of the routed MoE for Hopper (sm_90a): `gmm`,
// its transposed-rhs form `gmm_t`, and `tgmm`.
//
// Replaces the megablox Pallas TPU kernels that `_pallas_gmm` and its
// custom VJP call in multi_spatialmllm_tpu/models/moe.py (`gmm` for the
// forward, `gmm(transpose_rhs=True)` for dlhs, `tgmm` for drhs; the library
// is jax/experimental/pallas/ops/tpu/megablox/gmm.py).
//
// Semantics (held against gmm_plain / tgmm_plain in ops/grouped_matmul.py):
//   group_sizes [E] int32 split the rows 0..M-1 into E consecutive groups;
//   row r belongs to the group g whose offsets [start_g, end_g) hold it.
//   gmm:   out[M, N] = lhs[M, K] @ rhs[g(r)][K, N]   (rhs [E, K, N])
//   gmm_t: out[M, K] = dy[M, N] @ rhs[g(r)]^T        (rhs [E, K, N])
//   tgmm:  out[E, K, N], out[g] = sum over rows r of g of lhs[r]^T dy[r]
//   Rows at or past sum(group_sizes) come out zero (megablox's
//   `_zero_uninitialized_memory`), as does an empty group's tgmm slab.
//   Products accumulate in f32; outputs round once to the operand dtype.
//   The group offsets are an exclusive cumsum of the E sizes, computed by
//   each CTA on the device (no host read, no sync).
//
// What bounds it: at the MoE shapes (NK 8192-16384 rows, D and F 2048-8192)
// each call is ~0.1-0.3 TFLOP against ~0.1 GB of operands, far above the
// card's ridge point: it is bound by tensor-core operations. So the bf16
// path runs mma.sync m16n8k16 (bf16 in, f32 accumulate) on 128x128 output
// tiles, 8 warps of 64x32 each, with 32-deep operand tiles double-buffered
// in shared memory by cp.async (rows padded 16 bytes, so the ldmatrix
// fragment loads are free of bank conflicts). The three forms are one
// kernel template: the transposed operands are read with ldmatrix.trans
// instead of being copied. gmm/gmm_t: a CTA owns one (m-tile, n-tile) and
// runs one pass over K for each group that overlaps its rows (usually one,
// two at a boundary), loading the rows outside the group as zeros, so a
// boundary inside a tile costs one extra pass, not a wrong row. tgmm: a CTA
// owns one (group, k-tile, n-tile) and loops over the group's rows; groups
// of very different sizes leave CTAs unevenly loaded (accepted here).
// wgmma, TMA and a persistent schedule are later work. The float32 path (the
// f32 test configs) is a plain FMA kernel, one output per thread.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;  // output tile rows
constexpr int BN = 128;  // output tile columns
constexpr int BK = 32;   // contraction depth per stage
constexpr int NUM_THREADS = 256;  // 8 warps: 2 (rows) x 4 (columns)
constexpr int MAX_GROUPS = 512;
constexpr int LD_NARROW = BK + 8;  // stride of a [128][32] tile (elements)
constexpr int LD_WIDE = BN + 8;    // stride of a [32][128] tile
constexpr int TILE_ELEMS = BM * LD_NARROW;  // >= BK * LD_WIDE

enum Mode { GMM = 0, GMM_T = 1, TGMM = 2 };

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  const int n = pred ? 16 : 0;  // 0 source bytes: the 16 bytes are zeroed
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16), g = lane / 4,
// t = lane % 4: A 16x16 a0 (g, 2t..), a1 (g+8, 2t..), a2 (g, 2t+8..),
// a3 (g+8, 2t+8..); B 16x8 b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g);
// C 16x8 f32 c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A [128 rows][32 columns] tile of a row-major matrix with `ld` columns:
// rows r0.. (zero outside [lo, hi)), columns c0.. (zero at or past ncols)
__device__ __forceinline__ void load_narrow(bf16* dst, const bf16* src,
                                            int ld, int r0, int lo, int hi,
                                            int c0, int ncols) {
  for (int i = threadIdx.x; i < BM * (BK / 8); i += NUM_THREADS) {
    const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
    const int gr = r0 + r, gc = c0 + c;
    const bool ok = gr >= lo && gr < hi && gc < ncols;
    cp_async16(dst + r * LD_NARROW + c,
               ok ? src + (size_t)gr * ld + gc : src, ok);
  }
}

// A [32 rows][128 columns] tile, masked the same way
__device__ __forceinline__ void load_wide(bf16* dst, const bf16* src, int ld,
                                          int r0, int lo, int hi, int c0,
                                          int ncols) {
  for (int i = threadIdx.x; i < BK * (BN / 8); i += NUM_THREADS) {
    const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
    const int gr = r0 + r, gc = c0 + c;
    const bool ok = gr >= lo && gr < hi && gc < ncols;
    cp_async16(dst + r * LD_WIDE + c,
               ok ? src + (size_t)gr * ld + gc : src, ok);
  }
}

// Group offsets into shared memory: off[g] = sum of sizes before g, for
// g = 0..E (thread 0; E is small), each clamped to M.
__device__ __forceinline__ void group_offsets(int* off, const int* sizes,
                                              int E, int M) {
  if (threadIdx.x == 0) {
    int acc = 0;
    for (int g = 0; g < E; ++g) {
      off[g] = min(acc, M);
      acc += max(sizes[g], 0);
    }
    off[E] = min(acc, M);
  }
  __syncthreads();
}

// One pass over the contraction for the CTA's 128x128 output tile.
//   GMM:   A = lhs [M, K] rows i0.. masked to [lo, hi); B = rhs_g [K, N]
//   GMM_T: A = dy [M, N] rows i0.. masked to [lo, hi); B = rhs_g [K, N],
//          its rows j0.. (the output columns) read transposed
//   TGMM:  A = lhs [M, K] read transposed, B = dy [M, N]; the contraction
//          runs over the rows [lo, hi) of the group
// (KC: the contraction length; a/b: the two operands; lda/ldb: their
// row lengths.)
template <int MODE>
__device__ __forceinline__ void tile_pass(float (&acc)[4][4][4], bf16* smem,
                                          const bf16* a, int lda,
                                          const bf16* b, int ldb, int i0,
                                          int j0, int lo, int hi, int KC,
                                          int a_cols, int b_cols) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int c_begin = MODE == TGMM ? lo : 0;
  const int c_end = MODE == TGMM ? hi : KC;
  const int nck = c_end > c_begin ? (c_end - c_begin + BK - 1) / BK : 0;

  auto load = [&](int stage, int kc) {
    bf16* sA = smem + stage * 2 * TILE_ELEMS;
    bf16* sB = sA + TILE_ELEMS;
    const int c0 = c_begin + kc * BK;
    if (MODE == TGMM) {
      load_wide(sA, a, lda, c0, lo, hi, i0, a_cols);
      load_wide(sB, b, ldb, c0, lo, hi, j0, b_cols);
    } else {
      load_narrow(sA, a, lda, i0, lo, hi, c0, KC);
      if (MODE == GMM)
        load_wide(sB, b, ldb, c0, 0, KC, j0, b_cols);
      else
        load_narrow(sB, b, ldb, j0, 0, b_cols, c0, KC);
    }
  };

  if (nck > 0) load(0, 0);
  cp_async_commit();
  for (int kc = 0; kc < nck; ++kc) {
    if (kc + 1 < nck) load((kc + 1) & 1, kc + 1);
    cp_async_commit();
    cp_async_wait<1>();  // this stage's copies have landed
    __syncthreads();
    const bf16* sA = smem + (kc & 1) * 2 * TILE_ELEMS;
    const bf16* sB = sA + TILE_ELEMS;
    const int lr = lane & 7, lj = lane >> 3;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t af[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int r0 = wm * 64 + mi * 16;
        if (MODE == TGMM)  // sA [c][i]: the 8x8 blocks transposed
          ldsm_x4_t(af[mi], sA + (kk * 16 + lr + (lj >> 1) * 8) * LD_WIDE +
                                r0 + (lj & 1) * 8);
        else  // sA [i][c]
          ldsm_x4(af[mi], sA + (r0 + (lane & 15)) * LD_NARROW + kk * 16 +
                              (lane >> 4) * 8);
      }
      uint32_t bfr[4][2];
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        const int n0 = wn * 32 + np * 16;
        uint32_t r4[4];
        if (MODE == GMM_T)  // sB [j][c]
          ldsm_x4(r4, sB + (n0 + lr + (lj >> 1) * 8) * LD_NARROW + kk * 16 +
                          (lj & 1) * 8);
        else  // sB [c][j]: transposed
          ldsm_x4_t(r4, sB + (kk * 16 + lr + (lj & 1) * 8) * LD_WIDE + n0 +
                            (lj >> 1) * 8);
        bfr[2 * np][0] = r4[0];
        bfr[2 * np][1] = r4[1];
        bfr[2 * np + 1][0] = r4[2];
        bfr[2 * np + 1][1] = r4[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16(acc[mi][ni], af[mi], bfr[ni][0], bfr[ni][1]);
    }
    __syncthreads();  // before the next load overwrites this stage
  }
  cp_async_wait<0>();
}

// Write the accumulators of the CTA's tile to out [n_rows, ld] at (i0, j0).
__device__ __forceinline__ void store_tile(const float (&acc)[4][4][4],
                                           bf16* out, int ld, int n_rows,
                                           int n_cols, int i0, int j0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = j0 + wn * 32 + ni * 8 + 2 * t;
      if (col >= n_cols) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = i0 + wm * 64 + mi * 16 + g + 8 * h;
        if (row < n_rows)
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * ld + col) =
              __floats2bfloat162_rn(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
      }
    }
}

// gmm (MODE GMM: a = lhs [M, K], w = rhs [E, K, N], out [M, N]) and gmm_t
// (MODE GMM_T: a = dy [M, N], w = rhs [E, K, N], out [M, K]).
template <int MODE>
__global__ void __launch_bounds__(NUM_THREADS)
    gmm_bf16_kernel(const bf16* __restrict__ a, const bf16* __restrict__ w,
                    const int* __restrict__ sizes, bf16* __restrict__ out,
                    int M, int K, int N, int E) {
  __shared__ __align__(128) bf16 smem[2 * 2 * TILE_ELEMS];
  __shared__ int off[MAX_GROUPS + 1];
  group_offsets(off, sizes, E, M);
  const int i0 = blockIdx.y * BM, j0 = blockIdx.x * BN;
  const int i_end = min(i0 + BM, M);
  const int KC = MODE == GMM ? K : N;        // contraction
  const int n_out = MODE == GMM ? N : K;     // output columns
  float acc[4][4][4] = {};
  for (int g = 0; g < E; ++g) {  // uniform across the CTA
    const int lo = max(off[g], i0), hi = min(off[g + 1], i_end);
    if (lo >= hi) continue;
    tile_pass<MODE>(acc, smem, a, KC, w + (size_t)g * K * N, N, i0, j0, lo,
                    hi, KC, KC, n_out);
  }
  store_tile(acc, out, n_out, M, n_out, i0, j0);
}

// tgmm: lhs [M, K], dy [M, N] -> out [E, K, N]; blockIdx.z is the group.
__global__ void __launch_bounds__(NUM_THREADS)
    tgmm_bf16_kernel(const bf16* __restrict__ lhs, const bf16* __restrict__ dy,
                     const int* __restrict__ sizes, bf16* __restrict__ out,
                     int M, int K, int N, int E) {
  __shared__ __align__(128) bf16 smem[2 * 2 * TILE_ELEMS];
  __shared__ int off[MAX_GROUPS + 1];
  group_offsets(off, sizes, E, M);
  const int g = blockIdx.z, i0 = blockIdx.y * BM, j0 = blockIdx.x * BN;
  float acc[4][4][4] = {};
  tile_pass<TGMM>(acc, smem, lhs, K, dy, N, i0, j0, off[g], off[g + 1], 0, K,
                  N);
  store_tile(acc, out + (size_t)g * K * N, N, K, N, i0, j0);
}

// ---------------------------------------------------------------------------
// float32: one output per thread, FMA in the contraction order
// ---------------------------------------------------------------------------

__device__ __forceinline__ int group_of(const int* off, int E, int r) {
  for (int g = 0; g < E; ++g)
    if (r >= off[g] && r < off[g + 1]) return g;
  return -1;  // at or past the last group
}

template <int MODE>
__global__ void gmm_f32_kernel(const float* __restrict__ a,
                               const float* __restrict__ w,
                               const int* __restrict__ sizes,
                               float* __restrict__ out, int M, int K, int N,
                               int E) {
  __shared__ int off[MAX_GROUPS + 1];
  group_offsets(off, sizes, E, M);
  const int j = blockIdx.x * 32 + threadIdx.x % 32;
  const int r = blockIdx.y * 8 + threadIdx.x / 32;
  const int n_out = MODE == GMM ? N : K;
  if (r >= M || j >= n_out) return;
  const int g = group_of(off, E, r);
  float acc = 0.f;
  if (g >= 0) {
    const float* wg = w + (size_t)g * K * N;
    if (MODE == GMM)
      for (int c = 0; c < K; ++c)
        acc = fmaf(a[(size_t)r * K + c], wg[(size_t)c * N + j], acc);
    else
      for (int c = 0; c < N; ++c)
        acc = fmaf(a[(size_t)r * N + c], wg[(size_t)j * N + c], acc);
  }
  out[(size_t)r * n_out + j] = acc;
}

__global__ void tgmm_f32_kernel(const float* __restrict__ lhs,
                                const float* __restrict__ dy,
                                const int* __restrict__ sizes,
                                float* __restrict__ out, int M, int K, int N,
                                int E) {
  __shared__ int off[MAX_GROUPS + 1];
  group_offsets(off, sizes, E, M);
  const int g = blockIdx.z;
  const int n = blockIdx.x * 32 + threadIdx.x % 32;
  const int k = blockIdx.y * 8 + threadIdx.x / 32;
  if (k >= K || n >= N) return;
  float acc = 0.f;
  for (int r = off[g]; r < off[g + 1]; ++r)
    acc = fmaf(lhs[(size_t)r * K + k], dy[(size_t)r * N + n], acc);
  out[((size_t)g * K + k) * N + n] = acc;
}

bool bad_shape(int M, int K, int N, int E, int is_bf16) {
  return M < 0 || K <= 0 || N <= 0 || E <= 0 || E > MAX_GROUPS ||
         (is_bf16 && (K % 8 != 0 || N % 8 != 0));
}

}  // namespace

// Plain C entry points (bound with ctypes). Each returns a cudaError_t code.
// All tensors contiguous on the current device; group_sizes int32 [E];
// is_bf16 selects bf16 operands (else float32).

// lhs [M, K], rhs [E, K, N] -> out [M, N]
extern "C" int gmm(const void* lhs, const void* rhs, const int* group_sizes,
                   void* out, int M, int K, int N, int E, int is_bf16,
                   void* stream) {
  if (bad_shape(M, K, N, E, is_bf16)) return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    gmm_bf16_kernel<GMM><<<grid, NUM_THREADS, 0, st>>>(
        static_cast<const bf16*>(lhs), static_cast<const bf16*>(rhs),
        group_sizes, static_cast<bf16*>(out), M, K, N, E);
  } else {
    dim3 grid((N + 31) / 32, (M + 7) / 8);
    gmm_f32_kernel<GMM><<<grid, 256, 0, st>>>(
        static_cast<const float*>(lhs), static_cast<const float*>(rhs),
        group_sizes, static_cast<float*>(out), M, K, N, E);
  }
  return (int)cudaGetLastError();
}

// dy [M, N], rhs [E, K, N] -> out [M, K] (rhs read transposed)
extern "C" int gmm_t(const void* dy, const void* rhs, const int* group_sizes,
                     void* out, int M, int K, int N, int E, int is_bf16,
                     void* stream) {
  if (bad_shape(M, K, N, E, is_bf16)) return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    dim3 grid((K + BN - 1) / BN, (M + BM - 1) / BM);
    gmm_bf16_kernel<GMM_T><<<grid, NUM_THREADS, 0, st>>>(
        static_cast<const bf16*>(dy), static_cast<const bf16*>(rhs),
        group_sizes, static_cast<bf16*>(out), M, K, N, E);
  } else {
    dim3 grid((K + 31) / 32, (M + 7) / 8);
    gmm_f32_kernel<GMM_T><<<grid, 256, 0, st>>>(
        static_cast<const float*>(dy), static_cast<const float*>(rhs),
        group_sizes, static_cast<float*>(out), M, K, N, E);
  }
  return (int)cudaGetLastError();
}

// lhs [M, K], dy [M, N] -> out [E, K, N]
extern "C" int tgmm(const void* lhs, const void* dy, const int* group_sizes,
                    void* out, int M, int K, int N, int E, int is_bf16,
                    void* stream) {
  if (bad_shape(M, K, N, E, is_bf16)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    dim3 grid((N + BN - 1) / BN, (K + BM - 1) / BM, E);
    tgmm_bf16_kernel<<<grid, NUM_THREADS, 0, st>>>(
        static_cast<const bf16*>(lhs), static_cast<const bf16*>(dy),
        group_sizes, static_cast<bf16*>(out), M, K, N, E);
  } else {
    dim3 grid((N + 31) / 32, (K + 7) / 8, E);
    tgmm_f32_kernel<<<grid, 256, 0, st>>>(
        static_cast<const float*>(lhs), static_cast<const float*>(dy),
        group_sizes, static_cast<float*>(out), M, K, N, E);
  }
  return (int)cudaGetLastError();
}
