// FlashAttention forward for Hopper (sm_90a): online softmax over K/V
// tiles, emitting the output and the per-row logsumexp.
//
// Replaces the Pallas TPU kernels of multi_spatialmllm_tpu/ops/attention.py
// `_flash_fwd_kernel` (:92, K1, reached through `_flash_fwd`) and
// `_flash_fwd_xl_kernel` (:483, K4, K/V streamed): this kernel streams K/V
// tiles at every S, so it plays both roles.
//
// Semantics (held against the plain version in ops/attention.py):
//   q [B, H, S, D], k/v [B, KVH, S, D] (native GQA: kv head = h / (H/KVH),
//   kv never widened), optional segment ids [B, S] int32 already
//   normalised to nondecreasing run indices (equality mask), causal or not.
//   Scores are f32 (bf16 products accumulated in f32), masked with
//   NEG_INF = -1e30 (not -inf, so a fully masked tile keeps finite
//   arithmetic), running max / normalizer / accumulator in f32, and the
//   probabilities cast to v's dtype before P.V, as the TPU kernel does;
//   lse in the natural log. (A row none of whose keys is visible, which
//   neither the causal nor the segment mask produces, gets o = 0 here where
//   the plain version averages v.)
//
// What bounds it: operations, at every shape the port times (the prefill,
// train and ViT shapes do ~S*D*4 flops per q row against ~D*6 bytes). So
// the bf16 kernel is built to keep Hopper's tensor cores fed:
//   - one CTA of three warpgroups per (b*h, 128-row q tile): a producer
//     warp (its warpgroup gives its registers away with setmaxnreg) issues
//     TMA loads; two consumer warpgroups own 64 q rows each, the M of one
//     wgmma;
//   - Q is loaded once; K and V tiles of 128 keys go through a ring of
//     STAGES slots in swizzled shared memory (128-byte swizzle, 64-byte at
//     D 32) with a full and an empty mbarrier per slot, so the next tiles
//     load while the current one is multiplied. The producer walks the
//     tile list alone and publishes each slot's tile index and its keys'
//     segment ids in shared memory (then an end marker), so the consumers
//     read no device memory in their loop and cannot disagree with it;
//   - S = Q K^T is wgmma m64n128k16 with both operands in shared memory (K
//     rows are already the K-major B operand); O += P V is wgmma with P
//     from registers (the S accumulators re-packed in place as the A
//     fragment) and V read transposed (MN-major) where it lies;
//   - the two consumers take turns on the tensor cores (named barriers),
//     so one's softmax overlaps the other's products;
//   - softmax in base 2 (one MUFU.EX2 an entry, scale * log2(e) folded
//     into an FMA; lse converted to the natural log once);
//   - masks only on the tiles that need them (the causal diagonal, the
//     ragged last tile, tiles whose segment ids are not one value);
//   - the heaviest causal q tiles launch first.
// The tensor maps are per head ([B*H, S, D] and [B*KVH, S, D]), so a box
// past S reads TMA's zero fill, never the next head's rows. The float32
// path (the f32 test configs) is a plain FMA kernel of 64-row tiles.
//
// Tile skipping: the causal bound stops the K loop after the diagonal
// tile; with segment ids, K tiles whose id range does not meet the q
// tile's are skipped (the ViT's trailing pad segment).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int TILE_Q = 64;
constexpr int TILE_K = 64;
constexpr int NUM_WARPS = 4;  // each warp owns 16 q rows
constexpr int NUM_THREADS = NUM_WARPS * 32;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
// reductions over the 4 lanes of a quad (the lanes sharing a row)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Rows [r0, r0 + 64) of a [n_rows, D] row-major matrix into shared memory
// with row stride LD (elements), zero-filling rows past n_rows.
template <typename T, int D, int LD>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int r0,
                                          int n_rows) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CHUNKS = D / VEC;
  for (int i = threadIdx.x; i < 64 * CHUNKS; i += NUM_THREADS) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n_rows)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// ---------------------------------------------------------------------------
// bf16: warp-specialised wgmma kernel fed by TMA through a K/V ring
// ---------------------------------------------------------------------------

constexpr int WS_BM = 128;      // q rows a CTA: two consumer warpgroups of 64
constexpr int WS_BN = 128;      // keys a K/V tile
static_assert(WS_BM == WS_BN, "Q and K tiles share their chunk offsets");
constexpr int WS_THREADS = 384;  // producer warpgroup, then two consumers
// the producer warpgroup gives its registers to the consumers: 24 * 128 +
// 240 * 256 is the 168 * 384 the launch gives the block
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D>
struct WsCfg {
  static constexpr int SW = D >= 64 ? 128 : 2 * D;  // bytes a swizzled row
  static constexpr int CW = SW / 2;                 // columns a chunk
  static constexpr int CHUNKS = D / CW;  // a tile is CHUNKS [rows, CW] boxes
  static constexpr int LAYOUT = hopper::desc_layout(SW);
  static constexpr int STAGES = D == 128 ? 2 : 4;
  static constexpr uint32_t Q_BYTES = WS_BM * D * 2;
  static constexpr uint32_t KV_BYTES = WS_BN * D * 2;  // one K or V tile
  // alignment slack, 1 KB of barriers and slot tile indices, the slots'
  // key segment ids (512 bytes each), then Q and STAGES x (K, V), each on
  // a 1024-byte boundary
  static constexpr uint32_t SEG_BYTES = STAGES * WS_BN * 4;
  static constexpr size_t SMEM =
      2048 + SEG_BYTES + Q_BYTES + (size_t)2 * STAGES * KV_BYTES;
};

// 2^x in one MUFU.EX2 (flushes results below 2^-126 to 0; exp2f adds
// instructions to keep them)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The K/V tiles one q tile visits. Only the producer walks it: it
// publishes each live tile's index in the slot it fills, then an end
// marker, and the consumers follow the slots, so the two sides cannot
// disagree about the list.
struct KvPlan {
  const int* seg;  // this row's normalised ids, or null
  int S, n, seg_lo, seg_hi;

  __device__ __forceinline__ bool live(int kt) const {
    if (seg == nullptr) return true;
    const int k0 = kt * WS_BN;
    return !(__ldg(seg + min(k0 + WS_BN, S) - 1) < seg_lo ||
             __ldg(seg + k0) > seg_hi);
  }
};

__device__ __forceinline__ KvPlan kv_plan(const int* seg, int q0, int S,
                                          int causal) {
  const int q_last = min(q0 + WS_BM, S) - 1;
  KvPlan p;
  p.seg = seg;
  p.S = S;
  p.n = (S + WS_BN - 1) / WS_BN;
  if (causal) p.n = min(p.n, q_last / WS_BN + 1);  // tiles past the diagonal
  // ids are nondecreasing: the q tile's range is its two ends
  p.seg_lo = seg ? __ldg(seg + q0) : 0;
  p.seg_hi = seg ? __ldg(seg + q_last) : 0;
  return p;
}

template <int D>
__global__ void __launch_bounds__(WS_THREADS, 1)
    flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const int* __restrict__ seg,
                          __nv_bfloat16* __restrict__ o,
                          float* __restrict__ lse, int H, int KVH, int S,
                          int causal, float scale_log2) {
  using C = WsCfg<D>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t base = (hopper::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_q = base;
  const uint32_t sQ = base + 1024 + C::SEG_BYTES;
  auto bar_full = [=](int st) { return base + 8u + 8u * st; };
  auto bar_empty = [=](int st) { return base + 8u + 8u * (C::STAGES + st); };
  auto sK = [=](int st) { return sQ + C::Q_BYTES + 2u * st * C::KV_BYTES; };
  auto sV = [=](int st) { return sK(st) + C::KV_BYTES; };
  // generic pointers for what threads read and write themselves: each
  // slot's tile index (-1: no more tiles) and its keys' segment ids (-1
  // past S)
  unsigned char* gbase = smem_raw + (base - hopper::smem_u32(smem_raw));
  int* slot_tile = reinterpret_cast<int*>(gbase + 512);
  int* slot_seg = reinterpret_cast<int*>(gbase + 1024);

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int kv_bh = b * KVH + h / (H / KVH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * WS_BM;  // heaviest first
  const int* segb = seg ? seg + (size_t)b * S : nullptr;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    hopper::mbar_init(bar_q, 1);
    for (int st = 0; st < C::STAGES; ++st) {
      hopper::mbar_init(bar_full(st), 1);
      hopper::mbar_init(bar_empty(st), 8);  // one arrival a consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one warp keeps the ring full; lane 0 issues the TMA loads,
    // the warp copies the keys' segment ids
    hopper::reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        hopper::mbar_arrive_expect_tx(bar_q, C::Q_BYTES);
        for (int c = 0; c < C::CHUNKS; ++c)
          hopper::tma_load_3d(sQ + c * WS_BM * C::SW, &tm_q, bar_q,
                              c * C::CW, q0, bh);
      }
      const KvPlan plan = kv_plan(segb, q0, S, causal);
      int stage = 0, phase = 0;
      for (int kt = 0; kt <= plan.n; ++kt) {  // kt == plan.n: the end marker
        const bool end = kt == plan.n;
        if (!end && !plan.live(kt)) continue;
        const int k0 = kt * WS_BN;
        int ids[WS_BN / 32];  // loaded before the wait, stored after it
        if (segb && !end)
#pragma unroll
          for (int i = 0; i < WS_BN / 32; ++i) {
            const int col = k0 + lane + 32 * i;
            ids[i] = col < S ? __ldg(segb + col) : -1;
          }
        hopper::mbar_wait(bar_empty(stage), phase ^ 1);  // slot released
        if (segb && !end)
#pragma unroll
          for (int i = 0; i < WS_BN / 32; ++i)
            slot_seg[stage * WS_BN + lane + 32 * i] = ids[i];
        if (lane == 0) slot_tile[stage] = end ? -1 : kt;
        __syncwarp();  // the warp's writes before lane 0's arrival
        if (lane == 0) {
          const uint32_t full = bar_full(stage);
          if (end) {
            hopper::mbar_arrive(full);
          } else {
            hopper::mbar_arrive_expect_tx(full, 2 * C::KV_BYTES);
            for (int c = 0; c < C::CHUNKS; ++c) {
              hopper::tma_load_3d(sK(stage) + c * WS_BN * C::SW, &tm_k, full,
                                  c * C::CW, k0, kv_bh);
              hopper::tma_load_3d(sV(stage) + c * WS_BN * C::SW, &tm_v, full,
                                  c * C::CW, k0, kv_bh);
            }
          }
        }
        if (++stage == C::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // consumers: warpgroup cw owns q rows [q0 + 64 cw, q0 + 64 cw + 64)
    hopper::reg_alloc<CONSUMER_REGS>();
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int w_lo = q0 + 64 * cw;
    const int r0 = w_lo + 16 * warp + g, r1 = r0 + 8;  // this thread's rows
    int sq0 = 0, sq1 = 0, sw_lo = 0, sw_hi = 0;
    if (segb) {
      sq0 = __ldg(segb + min(r0, S - 1));
      sq1 = __ldg(segb + min(r1, S - 1));
      sw_lo = __ldg(segb + min(w_lo, S - 1));
      sw_hi = __ldg(segb + min(w_lo + 63, S - 1));
    }
    // descriptors of this warpgroup's Q rows and of slot 0's K and V; a
    // step adds its byte offset / 16 to the start-address field
    const uint64_t dq = hopper::make_desc(sQ + cw * 64 * C::SW, 16,
                                          8 * C::SW, C::LAYOUT);
    const uint64_t dk = hopper::make_desc(sK(0), 16, 8 * C::SW, C::LAYOUT);
    const uint64_t dv = hopper::make_desc(sV(0), WS_BN * C::SW, 8 * C::SW,
                                          C::LAYOUT);

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    // running max of the raw scores (NEG_INF while a row has seen only
    // masked keys) and the normalizer of exp2 terms
    float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

    // The two consumers take turns on the tensor cores (FA3's ping-pong):
    // each issues its products only on its turn (named barrier 1 + cw)
    // and passes the turn once they are issued, so one warpgroup's softmax
    // runs while the other's products do. Warpgroup 0 takes the first
    // turn; every pass is matched by a wait, the last by the wait after
    // the loop.
    const auto take_turn = [cw] { hopper::named_bar_sync(1 + cw, 256); };
    const auto pass_turn = [cw] { hopper::named_bar_arrive(2 - cw, 256); };
    if (cw == 1) hopper::named_bar_arrive(1, 256);

    hopper::mbar_wait(bar_q, 0);
    for (int stage = 0, phase = 0;;) {
      hopper::mbar_wait(bar_full(stage), phase);
      const int kt = slot_tile[stage];
      if (kt < 0) break;
      const int k0 = kt * WS_BN;
      const int* tseg = slot_seg + stage * WS_BN;  // this tile's key ids

      // S = Q K^T for this warpgroup's 64 rows x 128 keys
      const uint32_t slot = stage * (2 * C::KV_BYTES / 16);
      float s[64];
      take_turn();
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        // 16 columns along D: the next 32 bytes of a row, or the next chunk
        const uint32_t off = hopper::kmajor_step(kk, WS_BM, C::SW);
        hopper::wgmma_m64n128k16_ss(s, dq + off, dk + slot + off, kk > 0);
      }
      hopper::wgmma_commit();
      pass_turn();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);

      // mask only where some entry of this warpgroup's block needs it
      bool need = k0 + WS_BN > S || (causal && k0 + WS_BN - 1 > w_lo);
      if (segb && !need) {
        const int a = tseg[0], z = tseg[WS_BN - 1];  // a full tile here
        need = !(a == z && a == sw_lo && sw_lo == sw_hi);
      }
      if (need) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = k0 + 8 * j + 2 * t + e;
            bool keep0 = col < S, keep1 = col < S;
            if (causal) {
              keep0 = keep0 && col <= r0;
              keep1 = keep1 && col <= r1;
            }
            if (segb) {
              const int sk = tseg[8 * j + 2 * t + e];
              keep0 = keep0 && sk == sq0;
              keep1 = keep1 && sk == sq1;
            }
            if (!keep0) s[4 * j + e] = NEG_INF;
            if (!keep1) s[4 * j + 2 + e] = NEG_INF;
          }
        }
      }

      // online softmax in base 2 over this thread's two rows: p =
      // exp2(s * scale_log2 - ms), one FMA an entry, with ms the scaled max
      // (0 while the max is NEG_INF: a masked entry then gives exp2 of
      // about -1e29, exactly 0, where NEG_INF * scale_log2 rounded would
      // leave a residue of ~1e22 in the FMA)
      float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
      const float mn0 = fmaxf(m0, quad_max(mx0));
      const float mn1 = fmaxf(m1, quad_max(mx1));
      const float alpha0 = fast_exp2((m0 - mn0) * scale_log2);
      const float alpha1 = fast_exp2((m1 - mn1) * scale_log2);
      m0 = mn0;
      m1 = mn1;
      const float ms0 = mn0 == NEG_INF ? 0.f : mn0 * scale_log2;
      const float ms1 = mn1 == NEG_INF ? 0.f : mn1 * scale_log2;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        s[4 * j] = fast_exp2(fmaf(s[4 * j], scale_log2, -ms0));
        s[4 * j + 1] = fast_exp2(fmaf(s[4 * j + 1], scale_log2, -ms0));
        s[4 * j + 2] = fast_exp2(fmaf(s[4 * j + 2], scale_log2, -ms1));
        s[4 * j + 3] = fast_exp2(fmaf(s[4 * j + 3], scale_log2, -ms1));
        sum0 += s[4 * j] + s[4 * j + 1];
        sum1 += s[4 * j + 2] + s[4 * j + 3];
      }
      l0 = l0 * alpha0 + sum0;  // quad-reduced once, at the end
      l1 = l1 * alpha1 + sum1;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= (i & 2) ? alpha1 : alpha0;

      // O += P V: the accumulators of keys [16c, 16c + 16) are exactly the
      // A fragment of step c (p cast to v's dtype)
      uint32_t pa[WS_BN / 16][4];
#pragma unroll
      for (int c = 0; c < WS_BN / 16; ++c) {
        pa[c][0] = hopper::pack_bf16(s[8 * c], s[8 * c + 1]);
        pa[c][1] = hopper::pack_bf16(s[8 * c + 2], s[8 * c + 3]);
        pa[c][2] = hopper::pack_bf16(s[8 * c + 4], s[8 * c + 5]);
        pa[c][3] = hopper::pack_bf16(s[8 * c + 6], s[8 * c + 7]);
      }
      take_turn();
      hopper::wgmma_fence();
#pragma unroll
      for (int c = 0; c < WS_BN / 16; ++c)  // 16 keys: 16 rows of V down
        hopper::wgmma_rs_tnsp<D>(acc, pa[c], dv + slot + c * C::SW);
      hopper::wgmma_commit();
      pass_turn();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);

      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(bar_empty(stage));  // slot read
      if (++stage == C::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }

    if (cw == 0) take_turn();  // warpgroup 1's last pass

    l0 = fmaxf(quad_sum(l0), 1e-30f);
    l1 = fmaxf(quad_sum(l1), 1e-30f);
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    const size_t row0 = (size_t)bh * S + r0, row1 = row0 + 8;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = 8 * j + 2 * t;
      if (r0 < S)
        *reinterpret_cast<uint32_t*>(o + row0 * D + c) =
            hopper::pack_bf16(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
      if (r1 < S)
        *reinterpret_cast<uint32_t*>(o + row1 * D + c) =
            hopper::pack_bf16(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
    }
    if (t == 0) {  // lse = m * scale + ln l, from base 2
      if (r0 < S) lse[row0] = (m0 * scale_log2 + log2f(l0)) * LN2;
      if (r1 < S) lse[row1] = (m1 * scale_log2 + log2f(l1)) * LN2;
    }
  }
}

// ---------------------------------------------------------------------------
// float32: plain FMAs, each warp owning 16 q rows, state in shared memory
// ---------------------------------------------------------------------------

template <int D>
__host__ __device__ constexpr int f32_sld() {
  return D > TILE_K ? D : TILE_K;
}

template <int D>
constexpr size_t f32_smem_bytes() {
  return (size_t)(TILE_Q * D + 2 * TILE_K * D + TILE_Q * TILE_K +
                  TILE_Q * f32_sld<D>() + TILE_Q * D + 3 * TILE_Q) *
         sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(NUM_THREADS)
    flash_fwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const int* __restrict__ seg, float* __restrict__ o,
                         float* __restrict__ lse, int H, int KVH, int S,
                         int causal, float scale) {
  constexpr int SLD = f32_sld<D>();
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);  // [TILE_Q][D]
  float* sK = sQ + TILE_Q * D;                     // [TILE_K][D]
  float* sV = sK + TILE_K * D;                     // [TILE_K][D]
  float* sP = sV + TILE_K * D;                     // [TILE_Q][TILE_K]
  float* sS = sP + TILE_Q * TILE_K;  // [TILE_Q][SLD]: scores, then P.V
  float* sAcc = sS + TILE_Q * SLD;   // [TILE_Q][D]
  float* sM = sAcc + TILE_Q * D;
  float* sL = sM + TILE_Q;
  float* sAlpha = sL + TILE_Q;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int kv_row = b * KVH + h / (H / KVH);
  const int q0 = blockIdx.x * TILE_Q;
  const int q_last = min(q0 + TILE_Q, S) - 1;
  const float* kb = k + (size_t)kv_row * S * D;
  const float* vb = v + (size_t)kv_row * S * D;
  const int* segb = seg ? seg + (size_t)b * S : nullptr;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  load_tile<float, D, D>(sQ, q + (size_t)bh * S * D, q0, S);
  for (int i = tid; i < TILE_Q * D; i += NUM_THREADS) sAcc[i] = 0.f;
  for (int i = tid; i < TILE_Q; i += NUM_THREADS) {
    sM[i] = NEG_INF;
    sL[i] = 0.f;
  }
  int nk = (S + TILE_K - 1) / TILE_K;
  if (causal) nk = min(nk, q_last / TILE_K + 1);
  int seg_lo = 0, seg_hi = 0;
  if (segb) {
    seg_lo = segb[q0];
    seg_hi = segb[q_last];
  }
  __syncthreads();

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * TILE_K;
    if (segb && (segb[min(k0 + TILE_K, S) - 1] < seg_lo || segb[k0] > seg_hi))
      continue;
    load_tile<float, D, D>(sK, kb, k0, S);
    load_tile<float, D, D>(sV, vb, k0, S);
    __syncthreads();

    for (int i = 0; i < 16; ++i) {  // scores of this warp's rows
      const int r = warp * 16 + i;
      for (int c = lane; c < TILE_K; c += 32) {
        float acc_s = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d)
          acc_s = fmaf(sQ[r * D + d], sK[c * D + d], acc_s);
        sS[r * SLD + c] = acc_s;
      }
    }
    __syncwarp();

    for (int i = 0; i < 16; ++i) {  // online softmax, 2 columns a lane
      const int r = warp * 16 + i, qi = q0 + r;
      const float m_prev = sM[r];  // read before the shuffles below
      const int seg_q = (segb && qi < S) ? segb[qi] : 0;
      float sv[TILE_K / 32];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < TILE_K / 32; ++j) {
        const int c = lane + 32 * j, kj = k0 + c;
        bool keep = kj < S;
        if (causal) keep = keep && kj <= qi;
        if (segb) keep = keep && kj < S && segb[kj] == seg_q;
        sv[j] = keep ? sS[r * SLD + c] * scale : NEG_INF;
        mx = fmaxf(mx, sv[j]);
      }
      const float m_cur = fmaxf(m_prev, warp_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < TILE_K / 32; ++j) {
        const float p = expf(sv[j] - m_cur);
        sum += p;
        sP[r * TILE_K + lane + 32 * j] = p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_cur);
        sAlpha[r] = alpha;
        sL[r] = sL[r] * alpha + sum;
        sM[r] = m_cur;
      }
    }
    __syncwarp();

    for (int i = 0; i < 16; ++i) {  // P.V, then rescale-and-add
      const int r = warp * 16 + i;
      for (int d = lane; d < D; d += 32) {
        float acc_o = 0.f;
#pragma unroll 8
        for (int j = 0; j < TILE_K; ++j)
          acc_o = fmaf(sP[r * TILE_K + j], sV[j * D + d], acc_o);
        sS[r * SLD + d] = acc_o;
      }
    }
    __syncwarp();
    for (int i = 0; i < 16; ++i) {
      const int r = warp * 16 + i;
      const float alpha = sAlpha[r];
      for (int c = lane; c < D; c += 32)
        sAcc[r * D + c] = sAcc[r * D + c] * alpha + sS[r * SLD + c];
    }
    __syncthreads();  // before the next tile overwrites sK / sV / sS
  }
  __syncthreads();

  for (int i = 0; i < 16; ++i) {
    const int r = warp * 16 + i, qi = q0 + r;
    if (qi >= S) break;
    const float l = fmaxf(sL[r], 1e-30f);
    float* orow = o + ((size_t)bh * S + qi) * D;
    for (int c = lane; c < D; c += 32) orow[c] = sAcc[r * D + c] / l;
    if (lane == 0) lse[(size_t)bh * S + qi] = sM[r] + logf(l);
  }
}

// cudaFuncSetAttribute once per kernel instantiation and device, not on
// every launch: the prefill launches under a host-bound serve loop
template <int D, bool BF16>
cudaError_t set_smem_once(const void* kern, size_t smem) {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, const int* seg,
                void* o, void* lse, int B, int H, int KVH, int S, int causal,
                float scale, cudaStream_t stream) {
  using C = WsCfg<D>;
  const int q_tiles = (S + WS_BM - 1) / WS_BM;
  if (q_tiles > 65535) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  int err = hopper::encode_tensor_map(&tq, q, B * H, S, D, WS_BM, C::CW);
  if (err == 0)
    err = hopper::encode_tensor_map(&tk, k, B * KVH, S, D, WS_BN, C::CW);
  if (err == 0)
    err = hopper::encode_tensor_map(&tv, v, B * KVH, S, D, WS_BN, C::CW);
  if (err != 0) return err;
  cudaError_t e = set_smem_once<D, true>(
      reinterpret_cast<const void*>(&flash_fwd_bf16_kernel<D>), C::SMEM);
  if (e != cudaSuccess) return (int)e;
  flash_fwd_bf16_kernel<D><<<dim3(B * H, q_tiles), WS_THREADS, C::SMEM,
                             stream>>>(
      tq, tk, tv, seg, static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), H, KVH, S, causal, scale * LOG2E);
  return (int)cudaGetLastError();
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, const int* seg,
               void* o, void* lse, int B, int H, int KVH, int S, int causal,
               float scale, cudaStream_t stream) {
  cudaError_t e = set_smem_once<D, false>(
      reinterpret_cast<const void*>(&flash_fwd_f32_kernel<D>),
      f32_smem_bytes<D>());
  if (e != cudaSuccess) return (int)e;
  dim3 grid((S + TILE_Q - 1) / TILE_Q, B * H);
  flash_fwd_f32_kernel<D><<<grid, NUM_THREADS, f32_smem_bytes<D>(), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), seg, static_cast<float*>(o),
      static_cast<float*>(lse), H, KVH, S, causal, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_d(const void* q, const void* k, const void* v, const int* seg,
             void* o, void* lse, int B, int H, int KVH, int S, int causal,
             float scale, int is_bf16, cudaStream_t stream) {
  if (is_bf16)
    return launch_bf16<D>(q, k, v, seg, o, lse, B, H, KVH, S, causal, scale,
                          stream);
  return launch_f32<D>(q, k, v, seg, o, lse, B, H, KVH, S, causal, scale,
                       stream);
}

}  // namespace

// Plain C entry point (bound with ctypes). Returns a cudaError_t code.
// All tensors contiguous on the current device, q/k/v 16-byte aligned (the
// TMA descriptors need it); seg may be null.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const int* seg, void* o, void* lse, int B, int H,
                         int KVH, int S, int D, int causal, float scale,
                         int is_bf16, void* stream) {
  if (B <= 0 || S <= 0 || KVH <= 0 || H % KVH != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch_d<32>(q, k, v, seg, o, lse, B, H, KVH, S, causal, scale,
                          is_bf16, st);
    case 64:
      return launch_d<64>(q, k, v, seg, o, lse, B, H, KVH, S, causal, scale,
                          is_bf16, st);
    case 128:
      return launch_d<128>(q, k, v, seg, o, lse, B, H, KVH, S, causal, scale,
                           is_bf16, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
