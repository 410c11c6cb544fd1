// FlashAttention-2 backward for Hopper (sm_90a): dq, and fused dk/dv per
// kv head, each re-materialising the probability tiles from q, k and the
// forward's saved logsumexp (p = exp(s - lse)); no [S, S] tensor is formed.
//
// Replaces the Pallas TPU kernels of multi_spatialmllm_tpu/ops/attention.py:
//   flash_bwd_dq  <- `_flash_bwd_dq_kernel` (resident K/V) and
//                    `_flash_bwd_dq_xl_kernel` (K/V streamed, S*hd > 2^20)
//   flash_bwd_dkv <- `_flash_bwd_dkv_kernel` (resident Q/dO) and
//                    `_flash_bwd_dkv_xl_kernel` (Q/dO streamed)
// The resident/streaming split on the TPU is a VMEM budget; here every tile
// streams through shared memory at every sequence length, so one kernel
// stands for each pair.
//
// Semantics (held against flash_attention_bwd_plain in ops/attention.py):
//   q, dO [B, H, S, D]; k, v [B, KVH, S, D] (native GQA: kv head =
//   h / (H/KVH)); lse, delta = rowsum(dO * O) [B, H, S] f32; optional
//   segment ids [B, S] int32 normalised to nondecreasing run indices.
//   s = q.k * scale masked with NEG_INF = -1e30 (causal and segment
//   equality), p = exp(s - lse) (so a masked p is exactly 0, which the
//   kernels write directly), ds = p * (dO.v - delta) * scale;
//   dq = ds.K, dv = sum over the group's q heads of p^T.dO,
//   dk = the same sum of ds^T.Q. p and ds are cast to the operand dtype
//   before their products, as the TPU kernels do (`_dot_pv`, `_dot_tq`).
//
// GQA without atomics: one dk/dv CTA owns a 64-row k tile of one kv head
// and loops over the group's `rep` q heads itself, so the group sum is taken
// in f32 registers and each result is written once, in the same order on
// every run (the TPU design of `_flash_bwd_dkv_kernel`).
//
// What bounds it: the backward is compute bound. Per (q head, q tile,
// k tile) the kernels run five S*S*D products in all (dq kernel: q.k, dO.v,
// ds.K; dk/dv kernel: k.q, v.dO, p^T.dO, ds^T.Q, i.e. the two score
// products twice); at B1 H32 S4096 hd128 causal that is ~3.4e11 flops of
// which the bound counts 5 products once (0.35 ms at 989 TFLOP/s) against
// ~170 MB of operands (0.05 ms at 3.35 TB/s). This first version runs every
// bf16 product on the tensor cores with mma.sync m16n8k16 (bf16 in, f32
// accumulate), tiles of 64 x 64 through shared memory with rows padded by
// 16 bytes; accumulators (dq, or dk and dv) and the score tiles stay in
// registers, and the score accumulators are re-packed in place as the A
// operand of the next product. wgmma, TMA and a pipelined ring are later
// work. The float32 path is plain FMAs over the same tiling.
//
// Tile skipping, as in the TPU kernels: causal tiles past the diagonal are
// never visited; with segment ids, tiles whose id range does not meet the
// other side's are skipped at both ends (packed rows, the ViT's pad).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;          // rows of a q tile and of a k tile
constexpr int NUM_WARPS = 4;      // each warp owns 16 rows of the CTA's tile
constexpr int NUM_THREADS = NUM_WARPS * 32;

// Rows [r0, r0 + 64) of a [n_rows, D] row-major matrix into shared memory
// with row stride LD (elements), zero-filling rows past n_rows.
template <typename T, int D, int LD>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int r0,
                                          int n_rows) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CHUNKS = D / VEC;
  for (int i = threadIdx.x; i < TILE * CHUNKS; i += NUM_THREADS) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n_rows)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// [lo, hi] and [lo2, hi2] are row ranges; ids are nondecreasing, so the two
// share no segment exactly when one range's ids all precede the other's.
__device__ __forceinline__ bool segments_disjoint(const int* segb, int lo,
                                                  int hi, int lo2, int hi2) {
  return segb[hi] < segb[lo2] || segb[lo] > segb[hi2];
}

// ---------------------------------------------------------------------------
// bf16: tensor cores through mma.sync.m16n8k16
// ---------------------------------------------------------------------------

// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16), g = lane / 4,
// t = lane % 4:
//   A 16x16 row-major: a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//                      a3 (g+8, 2t+8..)
//   B 16x8 "col":      b0 (k 2t..2t+1, n g), b1 (k 2t+8..2t+9, n g)
//   C 16x8 f32:        c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1)
// Each 32-bit register holds two bf16, the lower index in the low half.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16_pair(__nv_bfloat16 lo,
                                                   __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

template <int D>
__host__ __device__ constexpr int bf16_ld() {
  return D + 8;  // 16 bytes of padding per row
}

// Rows 16w..16w+15 of a [64, D] shared tile as the A fragment of depth
// chunk kk.
template <int LD>
__device__ __forceinline__ void a_frag(uint32_t (&a)[4],
                                       const __nv_bfloat16* rows, int kk,
                                       int g, int t) {
  a[0] = ld32(rows + g * LD + kk * 16 + 2 * t);
  a[1] = ld32(rows + (g + 8) * LD + kk * 16 + 2 * t);
  a[2] = ld32(rows + g * LD + kk * 16 + 2 * t + 8);
  a[3] = ld32(rows + (g + 8) * LD + kk * 16 + 2 * t + 8);
}

// acc[n] (16 x 64 tile, n-tiles of 8 columns) += A . B^T where A is this
// warp's 16 rows of `a_rows` and B the 64 rows of `b_rows`, both [64, D]
// in shared memory: a product that contracts the head dim.
template <int D, int LD>
__device__ __forceinline__ void gemm_rows_rows(float (&acc)[TILE / 8][4],
                                               const __nv_bfloat16* a_rows,
                                               const __nv_bfloat16* b_rows,
                                               int g, int t) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    a_frag<LD>(a, a_rows, kk, g, t);
#pragma unroll
    for (int n = 0; n < TILE / 8; ++n) {
      const __nv_bfloat16* br = b_rows + (n * 8 + g) * LD + kk * 16 + 2 * t;
      mma_bf16(acc[n], a, ld32(br), ld32(br + 8));
    }
  }
}

// out[n] (16 x D, n-tiles of 8 columns) += X . M where X is the 16 x 64
// f32 tile held in `x` as C fragments (cast to bf16 and re-packed as A
// fragments in place) and M the [64, D] tile `m_rows` in shared memory: a
// product that contracts the 64 rows of the tile.
template <int D, int LD>
__device__ __forceinline__ void gemm_tile_rows(float (&out)[D / 8][4],
                                               const float (&x)[TILE / 8][4],
                                               const __nv_bfloat16* m_rows,
                                               int g, int t) {
#pragma unroll
  for (int c = 0; c < TILE / 16; ++c) {
    uint32_t a[4];
    a[0] = pack_bf16(x[2 * c][0], x[2 * c][1]);
    a[1] = pack_bf16(x[2 * c][2], x[2 * c][3]);
    a[2] = pack_bf16(x[2 * c + 1][0], x[2 * c + 1][1]);
    a[3] = pack_bf16(x[2 * c + 1][2], x[2 * c + 1][3]);
    const __nv_bfloat16* m0 = m_rows + (c * 16 + 2 * t) * LD + g;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const __nv_bfloat16* mp = m0 + n * 8;
      mma_bf16(out[n], a, pack_bf16_pair(mp[0], mp[LD]),
               pack_bf16_pair(mp[8 * LD], mp[9 * LD]));
    }
  }
}

template <int D>
constexpr size_t bf16_smem_bytes() {
  return (size_t)4 * TILE * bf16_ld<D>() * sizeof(__nv_bfloat16) +
         3 * TILE * sizeof(float);
}

// dq: one CTA per (b*h, 64-row q tile); each warp owns 16 q rows and loops
// over the k tiles its rows can see.
template <int D>
__global__ void __launch_bounds__(NUM_THREADS)
    flash_bwd_dq_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             const __nv_bfloat16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             const int* __restrict__ seg,
                             __nv_bfloat16* __restrict__ dq, int H, int KVH,
                             int S, int causal, float scale) {
  constexpr int LD = bf16_ld<D>();
  constexpr int NK = TILE / 8;
  constexpr int ND = D / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sDO = sQ + TILE * LD;
  __nv_bfloat16* sK = sDO + TILE * LD;
  __nv_bfloat16* sV = sK + TILE * LD;
  int* sSeg = reinterpret_cast<int*>(sV + TILE * LD);

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int kv_row = b * KVH + h / (H / KVH);
  const int q0 = blockIdx.x * TILE;
  const int q_last = min(q0 + TILE, S) - 1;
  const __nv_bfloat16* kb = k + (size_t)kv_row * S * D;
  const __nv_bfloat16* vb = v + (size_t)kv_row * S * D;
  const int* segb = seg ? seg + (size_t)b * S : nullptr;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;  // this lane's rows

  load_tile<__nv_bfloat16, D, LD>(sQ, q + (size_t)bh * S * D, q0, S);
  load_tile<__nv_bfloat16, D, LD>(sDO, dout + (size_t)bh * S * D, q0, S);
  const float lse0 = row0 < S ? lse[(size_t)bh * S + row0] : 0.f;
  const float lse1 = row1 < S ? lse[(size_t)bh * S + row1] : 0.f;
  const float dl0 = row0 < S ? delta[(size_t)bh * S + row0] : 0.f;
  const float dl1 = row1 < S ? delta[(size_t)bh * S + row1] : 0.f;
  const int seg_q0 = (segb && row0 < S) ? segb[row0] : 0;
  const int seg_q1 = (segb && row1 < S) ? segb[row1] : 0;
  const __nv_bfloat16* sQw = sQ + warp * 16 * LD;
  const __nv_bfloat16* sDOw = sDO + warp * 16 * LD;

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  int nk = (S + TILE - 1) / TILE;
  if (causal) nk = min(nk, q_last / TILE + 1);  // tiles past the diagonal
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * TILE, k_last = min(k0 + TILE, S) - 1;
    // uniform across the block, so the barriers below stay matched
    if (segb && segments_disjoint(segb, q0, q_last, k0, k_last)) continue;
    __syncthreads();  // the previous tile's readers are done
    load_tile<__nv_bfloat16, D, LD>(sK, kb, k0, S);
    load_tile<__nv_bfloat16, D, LD>(sV, vb, k0, S);
    if (segb && tid < TILE) sSeg[tid] = k0 + tid < S ? segb[k0 + tid] : -1;
    __syncthreads();

    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
    }
    gemm_rows_rows<D, LD>(s, sQw, sK, g, t);    // S = Q K^T
    gemm_rows_rows<D, LD>(dp, sDOw, sV, g, t);  // dP = dO V^T
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * t + (e & 1), kj = k0 + c;
        const int qi = e < 2 ? row0 : row1;
        bool keep = kj < S;
        if (causal) keep = keep && kj <= qi;
        if (segb) keep = keep && sSeg[c] == (e < 2 ? seg_q0 : seg_q1);
        const float p = keep ? expf(s[n][e] * scale - (e < 2 ? lse0 : lse1))
                             : 0.f;  // exp(NEG_INF - lse) == 0
        s[n][e] = p * (dp[n][e] - (e < 2 ? dl0 : dl1)) * scale;  // ds
      }
    }
    gemm_tile_rows<D, LD>(acc, s, sK, g, t);    // dQ += dS K
  }

#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int c = n * 8 + 2 * t;
    if (row0 < S)
      *reinterpret_cast<uint32_t*>(dq + ((size_t)bh * S + row0) * D + c) =
          pack_bf16(acc[n][0], acc[n][1]);
    if (row1 < S)
      *reinterpret_cast<uint32_t*>(dq + ((size_t)bh * S + row1) * D + c) =
          pack_bf16(acc[n][2], acc[n][3]);
  }
}

// dk/dv: one CTA per (b*kvh, 64-row k tile); each warp owns 16 k rows and
// loops over the group's q heads and the q tiles that can see its keys,
// working on transposed tiles (keys as rows) so dk and dv accumulate in its
// registers.
template <int D>
__global__ void __launch_bounds__(NUM_THREADS)
    flash_bwd_dkv_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              const __nv_bfloat16* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              const int* __restrict__ seg,
                              __nv_bfloat16* __restrict__ dk,
                              __nv_bfloat16* __restrict__ dv, int H, int KVH,
                              int S, int causal, float scale) {
  constexpr int LD = bf16_ld<D>();
  constexpr int NQ = TILE / 8;
  constexpr int ND = D / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + TILE * LD;
  __nv_bfloat16* sQ = sV + TILE * LD;
  __nv_bfloat16* sDO = sQ + TILE * LD;
  float* sLse = reinterpret_cast<float*>(sDO + TILE * LD);
  float* sDelta = sLse + TILE;
  int* sSeg = reinterpret_cast<int*>(sDelta + TILE);

  const int bkv = blockIdx.y, b = bkv / KVH, kvh = bkv % KVH;
  const int rep = H / KVH;
  const int k0 = blockIdx.x * TILE;
  const int k_last = min(k0 + TILE, S) - 1;
  const int* segb = seg ? seg + (size_t)b * S : nullptr;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int key0 = k0 + warp * 16 + g, key1 = key0 + 8;  // this lane's keys

  load_tile<__nv_bfloat16, D, LD>(sK, k + (size_t)bkv * S * D, k0, S);
  load_tile<__nv_bfloat16, D, LD>(sV, v + (size_t)bkv * S * D, k0, S);
  const int seg_k0 = (segb && key0 < S) ? segb[key0] : 0;
  const int seg_k1 = (segb && key1 < S) ? segb[key1] : 0;
  const __nv_bfloat16* sKw = sK + warp * 16 * LD;
  const __nv_bfloat16* sVw = sV + warp * 16 * LD;

  float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    dk_acc[n][0] = dk_acc[n][1] = dk_acc[n][2] = dk_acc[n][3] = 0.f;
    dv_acc[n][0] = dv_acc[n][1] = dv_acc[n][2] = dv_acc[n][3] = 0.f;
  }

  const int nq = (S + TILE - 1) / TILE;
  // causal: q tiles wholly before this k tile see none of it
  const int qt_start = causal ? k0 / TILE : 0;
  for (int r = 0; r < rep; ++r) {
    const size_t bh = (size_t)b * H + kvh * rep + r;
    for (int qt = qt_start; qt < nq; ++qt) {
      const int q0 = qt * TILE, q_last = min(q0 + TILE, S) - 1;
      if (segb && segments_disjoint(segb, q0, q_last, k0, k_last)) continue;
      __syncthreads();  // the previous tile's readers are done
      load_tile<__nv_bfloat16, D, LD>(sQ, q + bh * S * D, q0, S);
      load_tile<__nv_bfloat16, D, LD>(sDO, dout + bh * S * D, q0, S);
      if (tid < TILE) {
        const bool in = q0 + tid < S;
        sLse[tid] = in ? lse[bh * S + q0 + tid] : 0.f;
        sDelta[tid] = in ? delta[bh * S + q0 + tid] : 0.f;
        if (segb) sSeg[tid] = in ? segb[q0 + tid] : -1;
      }
      __syncthreads();

      float pt[NQ][4], dst[NQ][4];  // P^T, then dP^T -> dS^T (keys x queries)
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        pt[n][0] = pt[n][1] = pt[n][2] = pt[n][3] = 0.f;
        dst[n][0] = dst[n][1] = dst[n][2] = dst[n][3] = 0.f;
      }
      gemm_rows_rows<D, LD>(pt, sKw, sQ, g, t);    // S^T = K Q^T
      gemm_rows_rows<D, LD>(dst, sVw, sDO, g, t);  // dP^T = V dO^T
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = n * 8 + 2 * t + (e & 1), qi = q0 + c;
          const int kj = e < 2 ? key0 : key1;
          bool keep = qi < S && kj < S;
          if (causal) keep = keep && kj <= qi;
          if (segb) keep = keep && sSeg[c] == (e < 2 ? seg_k0 : seg_k1);
          const float p = keep ? expf(pt[n][e] * scale - sLse[c]) : 0.f;
          pt[n][e] = p;
          dst[n][e] = p * (dst[n][e] - sDelta[c]) * scale;
        }
      }
      gemm_tile_rows<D, LD>(dv_acc, pt, sDO, g, t);  // dV += P^T dO
      gemm_tile_rows<D, LD>(dk_acc, dst, sQ, g, t);  // dK += dS^T Q
    }
  }

#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int c = n * 8 + 2 * t;
    const size_t o0 = ((size_t)bkv * S + key0) * D + c;
    const size_t o1 = ((size_t)bkv * S + key1) * D + c;
    if (key0 < S) {
      *reinterpret_cast<uint32_t*>(dk + o0) =
          pack_bf16(dk_acc[n][0], dk_acc[n][1]);
      *reinterpret_cast<uint32_t*>(dv + o0) =
          pack_bf16(dv_acc[n][0], dv_acc[n][1]);
    }
    if (key1 < S) {
      *reinterpret_cast<uint32_t*>(dk + o1) =
          pack_bf16(dk_acc[n][2], dk_acc[n][3]);
      *reinterpret_cast<uint32_t*>(dv + o1) =
          pack_bf16(dv_acc[n][2], dv_acc[n][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// float32: plain FMAs over the same tiling, all tiles in shared memory
// ---------------------------------------------------------------------------

constexpr int PLD = TILE + 1;  // row stride of the 64 x 64 f32 scratch tile

template <int D>
constexpr size_t f32_dq_smem_bytes() {
  return (size_t)(5 * TILE * D + TILE * PLD + 2 * TILE) * sizeof(float) +
         TILE * sizeof(int);
}

template <int D>
__global__ void __launch_bounds__(NUM_THREADS)
    flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            const int* __restrict__ seg,
                            float* __restrict__ dq, int H, int KVH, int S,
                            int causal, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);  // [TILE][D] each
  float* sDO = sQ + TILE * D;
  float* sK = sDO + TILE * D;
  float* sV = sK + TILE * D;
  float* sAcc = sV + TILE * D;
  float* sDS = sAcc + TILE * D;     // [TILE q][PLD]
  float* sLse = sDS + TILE * PLD;
  float* sDelta = sLse + TILE;
  int* sSegQ = reinterpret_cast<int*>(sDelta + TILE);

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int kv_row = b * KVH + h / (H / KVH);
  const int q0 = blockIdx.x * TILE;
  const int q_last = min(q0 + TILE, S) - 1;
  const float* kb = k + (size_t)kv_row * S * D;
  const float* vb = v + (size_t)kv_row * S * D;
  const int* segb = seg ? seg + (size_t)b * S : nullptr;
  const int tid = threadIdx.x;

  load_tile<float, D, D>(sQ, q + (size_t)bh * S * D, q0, S);
  load_tile<float, D, D>(sDO, dout + (size_t)bh * S * D, q0, S);
  for (int i = tid; i < TILE * D; i += NUM_THREADS) sAcc[i] = 0.f;
  if (tid < TILE) {
    const bool in = q0 + tid < S;
    sLse[tid] = in ? lse[(size_t)bh * S + q0 + tid] : 0.f;
    sDelta[tid] = in ? delta[(size_t)bh * S + q0 + tid] : 0.f;
    sSegQ[tid] = (segb && in) ? segb[q0 + tid] : 0;
  }

  int nk = (S + TILE - 1) / TILE;
  if (causal) nk = min(nk, q_last / TILE + 1);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * TILE, k_last = min(k0 + TILE, S) - 1;
    if (segb && segments_disjoint(segb, q0, q_last, k0, k_last)) continue;
    __syncthreads();
    load_tile<float, D, D>(sK, kb, k0, S);
    load_tile<float, D, D>(sV, vb, k0, S);
    __syncthreads();
    for (int idx = tid; idx < TILE * TILE; idx += NUM_THREADS) {
      const int i = idx / TILE, c = idx % TILE;  // q row, key
      const int qi = q0 + i, kj = k0 + c;
      float sv = 0.f, dpv = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        sv = fmaf(sQ[i * D + d], sK[c * D + d], sv);
        dpv = fmaf(sDO[i * D + d], sV[c * D + d], dpv);
      }
      bool keep = kj < S;
      if (causal) keep = keep && kj <= qi;
      if (segb) keep = keep && segb[kj] == sSegQ[i];
      const float p = keep ? expf(sv * scale - sLse[i]) : 0.f;
      sDS[i * PLD + c] = p * (dpv - sDelta[i]) * scale;
    }
    __syncthreads();
    for (int idx = tid; idx < TILE * D; idx += NUM_THREADS) {  // dQ += dS K
      const int i = idx / D, d = idx % D;
      float a = 0.f;
#pragma unroll 8
      for (int c = 0; c < TILE; ++c) a = fmaf(sDS[i * PLD + c], sK[c * D + d], a);
      sAcc[idx] += a;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < TILE * D; idx += NUM_THREADS) {
    const int i = idx / D;
    if (q0 + i < S) dq[((size_t)bh * S + q0) * D + idx] = sAcc[idx];
  }
}

template <int D>
constexpr size_t f32_dkv_smem_bytes() {
  return (size_t)(6 * TILE * D + TILE * PLD + 2 * TILE) * sizeof(float) +
         TILE * sizeof(int);
}

template <int D>
__global__ void __launch_bounds__(NUM_THREADS)
    flash_bwd_dkv_f32_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             const int* __restrict__ seg,
                             float* __restrict__ dk, float* __restrict__ dv,
                             int H, int KVH, int S, int causal, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* sK = reinterpret_cast<float*>(smem_raw);  // [TILE][D] each
  float* sV = sK + TILE * D;
  float* sQ = sV + TILE * D;
  float* sDO = sQ + TILE * D;
  float* sDK = sDO + TILE * D;
  float* sDV = sDK + TILE * D;
  float* sP = sDV + TILE * D;       // [TILE key][PLD]: P^T, then dS^T
  float* sLse = sP + TILE * PLD;
  float* sDelta = sLse + TILE;
  int* sSegQ = reinterpret_cast<int*>(sDelta + TILE);

  const int bkv = blockIdx.y, b = bkv / KVH, kvh = bkv % KVH;
  const int rep = H / KVH;
  const int k0 = blockIdx.x * TILE;
  const int k_last = min(k0 + TILE, S) - 1;
  const int* segb = seg ? seg + (size_t)b * S : nullptr;
  const int tid = threadIdx.x;

  load_tile<float, D, D>(sK, k + (size_t)bkv * S * D, k0, S);
  load_tile<float, D, D>(sV, v + (size_t)bkv * S * D, k0, S);
  for (int i = tid; i < TILE * D; i += NUM_THREADS) sDK[i] = sDV[i] = 0.f;

  const int nq = (S + TILE - 1) / TILE;
  const int qt_start = causal ? k0 / TILE : 0;
  for (int r = 0; r < rep; ++r) {
    const size_t bh = (size_t)b * H + kvh * rep + r;
    for (int qt = qt_start; qt < nq; ++qt) {
      const int q0 = qt * TILE, q_last = min(q0 + TILE, S) - 1;
      if (segb && segments_disjoint(segb, q0, q_last, k0, k_last)) continue;
      __syncthreads();
      load_tile<float, D, D>(sQ, q + bh * S * D, q0, S);
      load_tile<float, D, D>(sDO, dout + bh * S * D, q0, S);
      if (tid < TILE) {
        const bool in = q0 + tid < S;
        sLse[tid] = in ? lse[bh * S + q0 + tid] : 0.f;
        sDelta[tid] = in ? delta[bh * S + q0 + tid] : 0.f;
        sSegQ[tid] = (segb && in) ? segb[q0 + tid] : 0;
      }
      __syncthreads();
      for (int idx = tid; idx < TILE * TILE; idx += NUM_THREADS) {  // P^T
        const int c = idx / TILE, i = idx % TILE;  // key, q row
        const int kj = k0 + c, qi = q0 + i;
        float sv = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) sv = fmaf(sK[c * D + d], sQ[i * D + d], sv);
        bool keep = kj < S && qi < S;
        if (causal) keep = keep && kj <= qi;
        if (segb) keep = keep && segb[kj] == sSegQ[i];
        sP[c * PLD + i] = keep ? expf(sv * scale - sLse[i]) : 0.f;
      }
      __syncthreads();
      for (int idx = tid; idx < TILE * D; idx += NUM_THREADS) {  // dV += P^T dO
        const int c = idx / D, d = idx % D;
        float a = 0.f;
#pragma unroll 8
        for (int i = 0; i < TILE; ++i) a = fmaf(sP[c * PLD + i], sDO[i * D + d], a);
        sDV[idx] += a;
      }
      __syncthreads();
      for (int idx = tid; idx < TILE * TILE; idx += NUM_THREADS) {  // dS^T
        const int c = idx / TILE, i = idx % TILE;
        float dpv = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) dpv = fmaf(sV[c * D + d], sDO[i * D + d], dpv);
        sP[c * PLD + i] = sP[c * PLD + i] * (dpv - sDelta[i]) * scale;
      }
      __syncthreads();
      for (int idx = tid; idx < TILE * D; idx += NUM_THREADS) {  // dK += dS^T Q
        const int c = idx / D, d = idx % D;
        float a = 0.f;
#pragma unroll 8
        for (int i = 0; i < TILE; ++i) a = fmaf(sP[c * PLD + i], sQ[i * D + d], a);
        sDK[idx] += a;
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < TILE * D; idx += NUM_THREADS) {
    const int c = idx / D;
    if (k0 + c < S) {
      const size_t o = ((size_t)bkv * S + k0) * D + idx;
      dk[o] = sDK[idx];
      dv[o] = sDV[idx];
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename Kern>
cudaError_t prepare(Kern kern, size_t smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, const int* seg, void* dq,
              int B, int H, int KVH, int S, int causal, float scale,
              int is_bf16, cudaStream_t st) {
  dim3 grid((S + TILE - 1) / TILE, B * H);
  if (is_bf16) {
    using T = __nv_bfloat16;
    const size_t smem = bf16_smem_bytes<D>();
    cudaError_t err = prepare(flash_bwd_dq_bf16_kernel<D>, smem);
    if (err != cudaSuccess) return (int)err;
    flash_bwd_dq_bf16_kernel<D><<<grid, NUM_THREADS, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
        seg, static_cast<T*>(dq), H, KVH, S, causal, scale);
  } else {
    const size_t smem = f32_dq_smem_bytes<D>();
    cudaError_t err = prepare(flash_bwd_dq_f32_kernel<D>, smem);
    if (err != cudaSuccess) return (int)err;
    flash_bwd_dq_f32_kernel<D><<<grid, NUM_THREADS, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, seg, static_cast<float*>(dq), H, KVH, S, causal, scale);
  }
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, const int* seg, void* dk,
               void* dv, int B, int H, int KVH, int S, int causal,
               float scale, int is_bf16, cudaStream_t st) {
  dim3 grid((S + TILE - 1) / TILE, B * KVH);
  if (is_bf16) {
    using T = __nv_bfloat16;
    const size_t smem = bf16_smem_bytes<D>();
    cudaError_t err = prepare(flash_bwd_dkv_bf16_kernel<D>, smem);
    if (err != cudaSuccess) return (int)err;
    flash_bwd_dkv_bf16_kernel<D><<<grid, NUM_THREADS, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
        seg, static_cast<T*>(dk), static_cast<T*>(dv), H, KVH, S, causal,
        scale);
  } else {
    const size_t smem = f32_dkv_smem_bytes<D>();
    cudaError_t err = prepare(flash_bwd_dkv_f32_kernel<D>, smem);
    if (err != cudaSuccess) return (int)err;
    flash_bwd_dkv_f32_kernel<D><<<grid, NUM_THREADS, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, seg, static_cast<float*>(dk), static_cast<float*>(dv), H, KVH,
        S, causal, scale);
  }
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int H, int KVH, int S) {
  return B <= 0 || S <= 0 || KVH <= 0 || H % KVH != 0;
}

}  // namespace

// Plain C entry points (bound with ctypes). Each returns a cudaError_t code.
// All tensors contiguous on the current device; seg may be null.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, const int* seg, void* dq,
                            int B, int H, int KVH, int S, int D, int causal,
                            float scale, int is_bf16, void* stream) {
  if (bad_shape(B, H, KVH, S)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch_dq<32>(q, k, v, dout, lse, delta, seg, dq, B, H, KVH, S,
                           causal, scale, is_bf16, st);
    case 64:
      return launch_dq<64>(q, k, v, dout, lse, delta, seg, dq, B, H, KVH, S,
                           causal, scale, is_bf16, st);
    case 128:
      return launch_dq<128>(q, k, v, dout, lse, delta, seg, dq, B, H, KVH, S,
                            causal, scale, is_bf16, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, const int* seg, void* dk,
                             void* dv, int B, int H, int KVH, int S, int D,
                             int causal, float scale, int is_bf16,
                             void* stream) {
  if (bad_shape(B, H, KVH, S)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch_dkv<32>(q, k, v, dout, lse, delta, seg, dk, dv, B, H, KVH,
                            S, causal, scale, is_bf16, st);
    case 64:
      return launch_dkv<64>(q, k, v, dout, lse, delta, seg, dk, dv, B, H, KVH,
                            S, causal, scale, is_bf16, st);
    case 128:
      return launch_dkv<128>(q, k, v, dout, lse, delta, seg, dk, dv, B, H,
                             KVH, S, causal, scale, is_bf16, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
