// FlashAttention-2 backward for Hopper (sm_90a): dq, and fused dk/dv per
// kv head, each re-materialising the probability tiles from q, k and the
// forward's saved logsumexp (p = exp(s - lse)); no [S, S] tensor is formed.
//
// Replaces the Pallas TPU kernels of multi_spatialmllm_tpu/ops/attention.py:
//   flash_bwd_dq  <- `_flash_bwd_dq_kernel` (:269, K2, resident K/V) and
//                    `_flash_bwd_dq_xl_kernel` (:592, K5, K/V streamed)
//   flash_bwd_dkv <- `_flash_bwd_dkv_kernel` (:324, K3, resident Q/dO) and
//                    `_flash_bwd_dkv_xl_kernel` (:645, K6, Q/dO streamed)
// The resident/streaming split on the TPU is a VMEM budget; here every tile
// streams through shared memory at every sequence length, so one kernel
// stands for each pair.
//
// Semantics (held against flash_attention_bwd_plain in ops/attention.py):
//   q, dO [B, H, S, D]; k, v [B, KVH, S, D] (native GQA: kv head =
//   h / (H/KVH)); lse, delta = rowsum(dO * O) [B, H, S] f32; optional
//   segment ids [B, S] int32 normalised to nondecreasing run indices.
//   s = q.k * scale, masked (causal and segment equality), p = exp(s - lse),
//   exactly 0 where masked; ds = p * (dO.v - delta) * scale; dq = ds.K,
//   dv = sum over the group's q heads of p^T.dO, dk = the same sum of
//   ds^T.Q. p and ds are rounded to bf16 before their products (as the TPU
//   kernels' `_dot_pv`, `_dot_tq` cast them), sums are f32.
//
// No atomics: dq and dk/dv are two kernels, and one dk/dv CTA owns a key
// tile of one kv head and walks the group's `rep` q heads itself, so the
// group sum is taken in f32 registers and each result is written once, in
// the same order on every run (bit-identical results).
//
// What bounds it (989 TFLOP/s bf16, 3.35 TB/s): dq runs three S x S x D
// products (q.k, dO.v, ds.K), dk/dv four (k.q, v.dO, p^T.dO, ds^T.Q).
//   - unpacked causal S 4096 (B1 H32 KVH8 hd128) and S 8192 (H8 KVH2):
//     operations, 206 and 275 GFLOP (0.208 and 0.278 ms) against ~120 MB
//     of operands (0.04 ms);
//   - the ViT shape (6 x H16 S1152 hd64, non-causal, a pad segment):
//     operations, 39 and 52 GFLOP (0.040, 0.053 ms) against ~72 MB;
//   - a packed S 4096 row (16 segments and a pad): about 1/16 of the causal
//     work is left (12 and 17 GFLOP), so bytes bound it (~0.03 ms).
// What the bf16 design does about it:
//   - wgmma for all seven products: the two score products of each kernel
//     with both operands in shared memory; dQ += dS.K, dV += P^T.dO and
//     dK += dS^T.Q with the left operand from registers (the score
//     accumulators converted in place to the A fragment) and the right one
//     read MN-major where it lies, so no transposed copy is made;
//   - K/V (dq) and Q/dO (dk/dv) tiles stream by TMA through a ring of
//     swizzled slots with full mbarriers, so loads overlap the products;
//     the tiles that stay (Q and dO, or K and V) are loaded once;
//   - dq: one CTA of two consumer warpgroups (64 q rows each) and a
//     producer warp that walks the key tiles (causal and segment skipping)
//     and publishes each slot's tile index and key segment ids in shared
//     memory, then an end marker, so the consumers read no device memory
//     in their loop and cannot disagree with it; the consumers take turns
//     on the tensor cores (named barriers), one's elementwise pass
//     overlapping the other's products;
//   - dk/dv: its four accumulators do not fit the registers of a thread in
//     a block that large, so one warpgroup owns 64 keys and two CTAs share
//     an SM (they overlap each other as the two dq consumers do); its warp
//     0 refills each slot itself with the q tile's Q, dO and rows' lse
//     (times log2 e), delta (times scale) and segment ids; the live q
//     tiles are one contiguous run a head, found once;
//   - exp2 with log2(e) folded into the scale and lse (one MUFU.EX2 an
//     entry); masks only on the tiles that need them (the causal diagonal,
//     the ragged last tile, tiles whose segment ids are not one value);
//   - the live tiles (causal bound; segment ids meeting at both ends) are
//     one contiguous run, found once by a warp, not tile by tile;
//   - heaviest causal tiles launch first (dq reverses the q tiles; dk/dv's
//     first key tiles see the most q tiles), and a dk/dv grid of one wave
//     pairs heavy and light key tiles on each SM.
// Tensor maps are per head ([B*H, S, D] and [B*KVH, S, D]), so a box past S
// reads TMA's zero fill, never the next head's rows. The float32 path (the
// f32 test configs) is plain FMAs over 64-row tiles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int TILE = 64;          // f32 path: rows of a q tile and a k tile
constexpr int NUM_WARPS = 4;      // f32 path: each warp owns 16 rows
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
// bf16: warp-specialised wgmma kernels fed by TMA rings
// ---------------------------------------------------------------------------

// dq's block: two consumer warpgroups (warps 0-7: wgmma needs warpgroups
// aligned to four warps), then one producer warp
constexpr int WS_THREADS = 288;
constexpr int PRODUCER_WG = 2;
constexpr float LOG2E = 1.4426950408889634f;
// lse of a q row past S in a dk/dv slot: exp2(s * scale - LSE_PAD) is 0
constexpr float LSE_PAD = 1e30f;

// 2^x in one MUFU.EX2 (flushes results below 2^-126 to 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The accumulators of a 64 x N score tile (this thread: N / 2 registers)
// re-packed as the bf16 A fragments of the N / 16 steps of a product that
// contracts the tile's columns (step c: columns [16c, 16c + 16)).
template <int N>
__device__ __forceinline__ void to_a_frags(uint32_t (&a)[N / 16][4],
                                           const float (&x)[N / 2]) {
#pragma unroll
  for (int c = 0; c < N / 16; ++c) {
    a[c][0] = hopper::pack_bf16(x[8 * c], x[8 * c + 1]);
    a[c][1] = hopper::pack_bf16(x[8 * c + 2], x[8 * c + 3]);
    a[c][2] = hopper::pack_bf16(x[8 * c + 4], x[8 * c + 5]);
    a[c][3] = hopper::pack_bf16(x[8 * c + 6], x[8 * c + 7]);
  }
}

// A 64 x D accumulator (rows r0 and r0 + 8 of this thread) as bf16 rows of
// a [*, D] row-major output; rows at or past S are not written.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out,
                                           const float (&acc)[D / 2],
                                           size_t row0, int r0, int S,
                                           int t) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + 2 * t;
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(out + row0 * D + c) =
          hopper::pack_bf16(acc[4 * j], acc[4 * j + 1]);
    if (r0 + 8 < S)
      *reinterpret_cast<uint32_t*>(out + (row0 + 8) * D + c) =
          hopper::pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// Swizzle of a [rows, D] bf16 tile: rows of SW bytes (128, or 64 at D 32),
// stored as CHUNKS boxes of [rows, CW] columns.
template <int D>
struct Sw {
  static constexpr int SW = D >= 64 ? 128 : 2 * D;
  static constexpr int CW = SW / 2;
  static constexpr int CHUNKS = D / CW;
  static constexpr int LAYOUT = hopper::desc_layout(SW);
};

// The two consumer warpgroups take turns on the tensor cores (FA3's
// ping-pong): each issues its products only on its turn (named barrier
// 1 + cw) and passes the turn once they are issued. Warpgroup 0 takes the
// first turn; every pass is matched by a wait, the last by `finish`. Both
// warpgroups must run the same number of turns (they consume every slot).
struct PingPong {
  int cw;
  __device__ __forceinline__ explicit PingPong(int cw_) : cw(cw_) {
    if (cw == 1) hopper::named_bar_arrive(1, 256);
  }
  __device__ __forceinline__ void take() const {
    hopper::named_bar_sync(1 + cw, 256);
  }
  __device__ __forceinline__ void pass() const {
    hopper::named_bar_arrive(2 - cw, 256);
  }
  __device__ __forceinline__ void finish() const {
    if (cw == 0) take();  // warpgroup 1's last pass
  }
};

// Narrows the tiles [lo, hi] (of `rows` rows each) to those whose segment
// ids meet [seg_lo, seg_hi]. The ids are nondecreasing, so the tiles whose
// ids all precede that range are a prefix and those whose ids all follow
// it a suffix: the rest is one contiguous run, found by one warp with two
// loads a lane for every 32 tiles, once (hi < lo if there is none).
__device__ __forceinline__ void live_run(const int* segb, int S, int rows,
                                         int seg_lo, int seg_hi, int lane,
                                         int& lo, int& hi) {
  int first = hi + 1, last = lo - 1;
  for (int j0 = lo; j0 <= hi; j0 += 32) {
    const int j = j0 + lane;
    const bool meets =
        j <= hi && !(__ldg(segb + min((j + 1) * rows, S) - 1) < seg_lo ||
                     __ldg(segb + j * rows) > seg_hi);
    const unsigned m = __ballot_sync(0xffffffffu, meets);
    if (m) {
      first = min(first, j0 + __ffs(m) - 1);
      last = j0 + 31 - __clz(m);
    }
  }
  lo = first;
  hi = last;
}

// ---- dq: one CTA per (b*h, 128-row q tile); K/V tiles of BN keys stream --

template <int D>
struct DqCfg {
  static constexpr int BM = 128;   // q rows a CTA: two consumers of 64
  // keys a K/V tile: S and dP take BN / 2 accumulators a thread each, dQ
  // D / 2; at 128 keys they outgrow the 168 registers a thread of this
  // 9-warp block gets (ptxas spilled them and serialised the wgmmas)
  static constexpr int BN = 64;
  static constexpr int STAGES = 4;
  static constexpr uint32_t Q_BYTES = BM * D * 2;   // Q, and dO
  static constexpr uint32_t KV_BYTES = BN * D * 2;  // one K or V tile
  // 1 KB of barriers and slot tile indices, the slots' key segment ids
  // (BN ints each, rounded up to 1 KB), then Q, dO and STAGES x (K, V),
  // each on a 1024-byte boundary; 1 KB of slack for the alignment
  static constexpr uint32_t SEG_BYTES =
      (STAGES * BN * 4 + 1023) / 1024 * 1024;
  static constexpr size_t SMEM =
      2048 + SEG_BYTES + 2 * Q_BYTES + (size_t)2 * STAGES * KV_BYTES;
};

template <int D>
__global__ void __launch_bounds__(WS_THREADS, 1)
    flash_bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             const __grid_constant__ CUtensorMap tm_do,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             const int* __restrict__ seg,
                             __nv_bfloat16* __restrict__ dq, int H, int KVH,
                             int S, int causal, float scale,
                             float scale_log2) {
  using C = DqCfg<D>;
  using W = Sw<D>;
  constexpr int BM = C::BM, BN = C::BN;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t base = (hopper::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_q = base;
  const uint32_t sQ = base + 1024 + C::SEG_BYTES;
  const uint32_t sDO = sQ + C::Q_BYTES;
  auto bar_full = [=](int st) { return base + 8u + 8u * st; };
  auto bar_empty = [=](int st) { return base + 8u + 8u * (C::STAGES + st); };
  auto sK = [=](int st) { return sDO + C::Q_BYTES + 2u * st * C::KV_BYTES; };
  auto sV = [=](int st) { return sK(st) + C::KV_BYTES; };
  // what threads read and write themselves: each slot's tile index (-1:
  // no more tiles) and its keys' segment ids (-1 past S)
  unsigned char* gbase = smem_raw + (base - hopper::smem_u32(smem_raw));
  int* slot_tile = reinterpret_cast<int*>(gbase + 512);
  int* slot_seg = reinterpret_cast<int*>(gbase + 1024);

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int kv_bh = b * KVH + h / (H / KVH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;  // heaviest first
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

  if (wg == PRODUCER_WG) {
    // producer: one warp keeps the ring full; lane 0 issues the TMA loads,
    // the warp copies the keys' segment ids
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      hopper::mbar_arrive_expect_tx(bar_q, 2 * C::Q_BYTES);
      for (int c = 0; c < W::CHUNKS; ++c) {
        hopper::tma_load_3d(sQ + c * BM * W::SW, &tm_q, bar_q, c * W::CW,
                            q0, bh);
        hopper::tma_load_3d(sDO + c * BM * W::SW, &tm_do, bar_q,
                            c * W::CW, q0, bh);
      }
    }
    // the key tiles this q tile sees: up to the diagonal, and with segment
    // ids the run whose ids meet the q tile's (its two ends)
    const int q_last = min(q0 + BM, S) - 1;
    int lo = 0, hi = (S + BN - 1) / BN - 1;
    if (causal) hi = min(hi, q_last / BN);
    if (segb)
      live_run(segb, S, BN, __ldg(segb + q0), __ldg(segb + q_last), lane, lo,
               hi);
    int stage = 0, phase = 0;
    for (int kt = lo;; ++kt) {
      const bool end = kt > hi;  // past the last tile: the end marker
      const int k0 = kt * BN;
      int ids[BN / 32];  // loaded before the wait, stored after it
      if (segb && !end)
#pragma unroll
        for (int i = 0; i < BN / 32; ++i) {
          const int col = k0 + lane + 32 * i;
          ids[i] = col < S ? __ldg(segb + col) : -1;
        }
      hopper::mbar_wait(bar_empty(stage), phase ^ 1);  // slot released
      if (segb && !end)
#pragma unroll
        for (int i = 0; i < BN / 32; ++i)
          slot_seg[stage * BN + lane + 32 * i] = ids[i];
      if (lane == 0) slot_tile[stage] = end ? -1 : kt;
      __syncwarp();  // the warp's writes before lane 0's arrival
      if (lane == 0) {
        const uint32_t full = bar_full(stage);
        if (end) {
          hopper::mbar_arrive(full);
        } else {
          hopper::mbar_arrive_expect_tx(full, 2 * C::KV_BYTES);
          for (int c = 0; c < W::CHUNKS; ++c) {
            hopper::tma_load_3d(sK(stage) + c * BN * W::SW, &tm_k, full,
                                c * W::CW, k0, kv_bh);
            hopper::tma_load_3d(sV(stage) + c * BN * W::SW, &tm_v, full,
                                c * W::CW, k0, kv_bh);
          }
        }
      }
      if (++stage == C::STAGES) {
        stage = 0;
        phase ^= 1;
      }
      if (end) break;
    }
  } else {
    // consumers: warpgroup cw owns q rows [q0 + 64 cw, q0 + 64 cw + 64)
    const int cw = wg;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int w_lo = q0 + 64 * cw;
    const int r0 = w_lo + 16 * warp + g, r1 = r0 + 8;  // this thread's rows
    // each row's lse (base 2) and delta (times scale), read once
    const size_t row0 = (size_t)bh * S + r0;
    const float lse0 = r0 < S ? __ldg(lse + row0) * LOG2E : 0.f;
    const float lse1 = r1 < S ? __ldg(lse + row0 + 8) * LOG2E : 0.f;
    const float dl0 = r0 < S ? __ldg(delta + row0) * scale : 0.f;
    const float dl1 = r1 < S ? __ldg(delta + row0 + 8) * scale : 0.f;
    int sq0 = 0, sq1 = 0, sw_lo = 0, sw_hi = 0;
    if (segb) {
      sq0 = __ldg(segb + min(r0, S - 1));
      sq1 = __ldg(segb + min(r1, S - 1));
      sw_lo = __ldg(segb + min(w_lo, S - 1));
      sw_hi = __ldg(segb + min(w_lo + 63, S - 1));
    }
    // descriptors of this warpgroup's Q and dO rows (K-major A), of slot
    // 0's K and V as the K-major B of the score products, and of slot 0's
    // K read MN-major as the B of dQ += dS K; a step adds its byte offset
    // / 16 to the start-address field
    const uint64_t dq_a = hopper::make_desc(sQ + cw * 64 * W::SW, 16,
                                            8 * W::SW, W::LAYOUT);
    const uint64_t ddo_a = hopper::make_desc(sDO + cw * 64 * W::SW, 16,
                                             8 * W::SW, W::LAYOUT);
    const uint64_t dk_b = hopper::make_desc(sK(0), 16, 8 * W::SW, W::LAYOUT);
    const uint64_t dv_b = hopper::make_desc(sV(0), 16, 8 * W::SW, W::LAYOUT);
    const uint64_t dk_t = hopper::make_desc(sK(0), BN * W::SW, 8 * W::SW,
                                            W::LAYOUT);

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    const PingPong turn(cw);

    hopper::mbar_wait(bar_q, 0);
    for (int stage = 0, phase = 0;;) {
      hopper::mbar_wait(bar_full(stage), phase);
      const int kt = slot_tile[stage];
      if (kt < 0) break;
      const int k0 = kt * BN;
      const int* tseg = slot_seg + stage * BN;  // this tile's key ids
      const uint32_t slot = stage * (2 * C::KV_BYTES / 16);

      // S = Q K^T and dP = dO V^T for this warpgroup's 64 rows x BN keys
      float s[BN / 2], dp[BN / 2];
      turn.take();
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_ss<BN>(s, dq_a + hopper::kmajor_step(kk, BM, W::SW),
                             dk_b + slot + hopper::kmajor_step(kk, BN, W::SW),
                             kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_ss<BN>(dp, ddo_a + hopper::kmajor_step(kk, BM, W::SW),
                             dv_b + slot + hopper::kmajor_step(kk, BN, W::SW),
                             kk > 0);
      hopper::wgmma_commit();
      turn.pass();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);
      hopper::fence_regs(dp);

      // mask only where some entry of this warpgroup's block needs it
      bool need = k0 + BN > S || (causal && k0 + BN - 1 > w_lo);
      if (segb && !need) {
        const int a = tseg[0], z = tseg[BN - 1];  // a full tile here
        need = !(a == z && a == sw_lo && sw_lo == sw_hi);
      }
      // p = exp2(s * scale_log2 - lse2), 0 where masked; ds = p * (dp *
      // scale - delta * scale), kept in s
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float p0 = fast_exp2(fmaf(s[4 * j + e], scale_log2, -lse0));
          float p1 = fast_exp2(fmaf(s[4 * j + 2 + e], scale_log2, -lse1));
          if (need) {
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
            if (!keep0) p0 = 0.f;
            if (!keep1) p1 = 0.f;
          }
          s[4 * j + e] = p0 * fmaf(dp[4 * j + e], scale, -dl0);
          s[4 * j + 2 + e] = p1 * fmaf(dp[4 * j + 2 + e], scale, -dl1);
        }
      }

      // dQ += dS K: dS (bf16) from registers, K read MN-major in its slot
      uint32_t da[BN / 16][4];
      to_a_frags<BN>(da, s);
      turn.take();
      hopper::wgmma_fence();
#pragma unroll
      for (int c = 0; c < BN / 16; ++c)  // 16 keys: 16 rows of K down
        hopper::wgmma_rs_tnsp<D>(acc, da[c], dk_t + slot + c * W::SW);
      hopper::wgmma_commit();
      turn.pass();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);

      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(bar_empty(stage));  // slot read
      if (++stage == C::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    turn.finish();
    store_rows<D>(dq, acc, row0, r0, S, t);
  }
}

// ---- dk/dv: one warpgroup CTA per (b*kvh, 64-key tile), two CTAs an SM --
//
// Each thread holds S^T, dP^T (32 f32 each) and dK, dV (64 each at hd 128):
// 192 accumulators, more than the 168 registers a thread of a 9- or
// 12-warp block gets (three warps then share one of the SM's four 16K
// register files; ptxas held such blocks to 168 whatever setmaxnreg
// claimed, and spilled). A 4-warp block launched two to an SM gets 255.
// So the warpgroup that multiplies also keeps its own ring full: warp 0
// refills a slot as soon as the products that read it are done (their
// completion means all four warps are past the slot's row data), with the
// next tile's row data loaded one tile ahead. The live q tiles form one
// contiguous run per head (causal start; nondecreasing segment ids), found
// once, so every thread computes tile i's head and rows from i alone.

template <int D>
struct DkvCfg {
  static constexpr int BN = 64;  // keys a CTA: one warpgroup's wgmma M
  // q rows a Q/dO tile: S^T and dP^T take BM / 2 accumulators a thread
  // each, dK and dV D / 2; 128 rows fit 255 registers below hd 128
  static constexpr int BM = D == 128 ? 64 : 128;
  static constexpr int THREADS = 128;
  // two CTAs an SM: at most ~113 KB of shared memory each
  static constexpr int STAGES = D == 32 ? 4 : 2;
  static constexpr uint32_t KV_BYTES = BN * D * 2;  // K, and V
  static constexpr uint32_t QT_BYTES = BM * D * 2;  // one Q or dO tile
  // 1 KB of barriers and the live range, each slot's rows' lse, delta and
  // segment ids (3 x BM words, rounded up to 1 KB in all), then K, V and
  // STAGES x (Q, dO), each on a 1024-byte boundary; 1 KB of slack
  static constexpr uint32_t META_BYTES =
      (STAGES * 3 * BM * 4 + 1023) / 1024 * 1024;
  static constexpr size_t SMEM =
      2048 + META_BYTES + 2 * KV_BYTES + (size_t)2 * STAGES * QT_BYTES;
};

// One q tile's BM rows as a slot needs them, BM / 32 a lane of warp 0:
// lse times log2 e (LSE_PAD past S), delta times scale (0 past S), segment
// id (-1 past S).
template <int BM>
struct RowMeta {
  static constexpr int N = BM / 32;
  float l2[N], dl[N];
  int id[N];

  __device__ __forceinline__ void load(const float* lse_h, const float* dl_h,
                                       const int* segb, int q0, int S,
                                       float scale, int lane) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int row = q0 + lane + 32 * i;
      const bool in = row < S;
      l2[i] = in ? __ldg(lse_h + row) * LOG2E : LSE_PAD;
      dl[i] = in ? __ldg(dl_h + row) * scale : 0.f;
      id[i] = segb && in ? __ldg(segb + row) : -1;
    }
  }
  __device__ __forceinline__ void store(float* l2_at, float* dl_at,
                                        int* id_at, int lane) const {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      l2_at[lane + 32 * i] = l2[i];
      dl_at[lane + 32 * i] = dl[i];
      id_at[lane + 32 * i] = id[i];
    }
  }
};

template <int D>
__global__ void __launch_bounds__(DkvCfg<D>::THREADS, 2)
    flash_bwd_dkv_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const __grid_constant__ CUtensorMap tm_do,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              const int* __restrict__ seg,
                              __nv_bfloat16* __restrict__ dk,
                              __nv_bfloat16* __restrict__ dv, int H, int KVH,
                              int S, int causal, float scale,
                              float scale_log2, int fold) {
  using C = DkvCfg<D>;
  using W = Sw<D>;
  constexpr int BM = C::BM, BN = C::BN;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t base = (hopper::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_kv = base;
  const uint32_t sK = base + 1024 + C::META_BYTES;
  const uint32_t sV = sK + C::KV_BYTES;
  auto bar_full = [=](int st) { return base + 8u + 8u * st; };
  auto sQ = [=](int st) { return sV + C::KV_BYTES + 2u * st * C::QT_BYTES; };
  auto sDO = [=](int st) { return sQ(st) + C::QT_BYTES; };
  // the live range (first q tile, live tiles a head), and each slot's rows'
  // lse * log2 e, delta * scale and segment ids
  unsigned char* gbase = smem_raw + (base - hopper::smem_u32(smem_raw));
  int* live = reinterpret_cast<int*>(gbase + 512);
  float* slot_lse = reinterpret_cast<float*>(gbase + 1024);
  float* slot_dl = slot_lse + C::STAGES * BM;
  int* slot_seg = reinterpret_cast<int*>(slot_dl + C::STAGES * BM);

  // launch order: heaviest first (causal: the first key tiles see the most
  // q tiles). When the grid is one wave of two CTAs an SM (`fold`: the SM
  // count, else 0), the blocks after the first `fold` take the lightest
  // tiles, lightest first, so that the two CTAs an SM carry about the mean
  int r = blockIdx.x + gridDim.x * blockIdx.y;
  if (fold > 0 && r >= fold) r = gridDim.x * gridDim.y - 1 - (r - fold);
  const int bkv = r % gridDim.x, b = bkv / KVH, kvh = bkv % KVH;
  const int rep = H / KVH;
  const int k0 = r / gridDim.x * BN;
  const int* segb = seg ? seg + (size_t)b * S : nullptr;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;

  if (warp == 0) {
    if (lane == 0) {
      hopper::mbar_init(bar_kv, 1);
      for (int st = 0; st < C::STAGES; ++st)
        hopper::mbar_init(bar_full(st), 1);
      hopper::fence_barrier_init();
      hopper::mbar_arrive_expect_tx(bar_kv, 2 * C::KV_BYTES);
      for (int c = 0; c < W::CHUNKS; ++c) {
        hopper::tma_load_3d(sK + c * BN * W::SW, &tm_k, bar_kv, c * W::CW,
                            k0, bkv);
        hopper::tma_load_3d(sV + c * BN * W::SW, &tm_v, bar_kv, c * W::CW,
                            k0, bkv);
      }
    }
    // causal: q tiles wholly before these keys see none of them; with
    // segment ids, the run of q tiles whose ids meet these keys'
    int lo = causal ? k0 / BM : 0, hi = (S + BM - 1) / BM - 1;
    if (segb)
      live_run(segb, S, BM, __ldg(segb + k0),
               __ldg(segb + min(k0 + BN, S) - 1), lane, lo, hi);
    if (lane == 0) {
      live[0] = lo;
      live[1] = max(0, hi - lo + 1);
    }
  }
  __syncthreads();
  const int q_lo = live[0], per_head = live[1], n = rep * per_head;

  // tile i of the walk: q head kvh * rep + i / per_head, rows from
  // (q_lo + i % per_head) * BM
  const auto head_of = [&](int i) { return b * H + kvh * rep + i / per_head; };
  const auto row_of = [&](int i) { return (q_lo + i % per_head) * BM; };
  // warp 0: the tile's row data into slot st, then its Q and dO by TMA
  const auto publish = [&](int i, int st, const RowMeta<BM>& m) {
    m.store(slot_lse + st * BM, slot_dl + st * BM, slot_seg + st * BM, lane);
    __syncwarp();  // the warp's writes before lane 0's arrival
    if (lane == 0) {
      const uint32_t full = bar_full(st);
      const int bh = head_of(i), q0 = row_of(i);
      hopper::mbar_arrive_expect_tx(full, 2 * C::QT_BYTES);
      for (int c = 0; c < W::CHUNKS; ++c) {
        hopper::tma_load_3d(sQ(st) + c * BM * W::SW, &tm_q, full, c * W::CW,
                            q0, bh);
        hopper::tma_load_3d(sDO(st) + c * BM * W::SW, &tm_do, full,
                            c * W::CW, q0, bh);
      }
    }
  };
  const auto meta_of = [&](int i) {
    RowMeta<BM> m;
    const size_t row0 = (size_t)head_of(i) * S;
    m.load(lse + row0, delta + row0, segb, row_of(i), S, scale, lane);
    return m;
  };
  if (warp == 0)
    for (int i = 0; i < min(n, C::STAGES); ++i) publish(i, i, meta_of(i));

  // register i of a transposed score tile is key row 16 warp + g + 8 ((i /
  // 2) % 2) and q column 8 (i / 4) + 2 t + i % 2
  const int ka = k0 + 16 * warp + g, kb = ka + 8;  // this thread's keys
  int ska = 0, skb = 0, sk_lo = 0, sk_hi = 0;
  if (segb) {
    ska = __ldg(segb + min(ka, S - 1));
    skb = __ldg(segb + min(kb, S - 1));
    sk_lo = __ldg(segb + k0);
    sk_hi = __ldg(segb + min(k0 + BN, S) - 1);
  }
  // descriptors: K and V (K-major A), slot 0's Q and dO as the K-major B of
  // the score products, and slot 0's Q and dO read MN-major as the B of
  // dK += dS^T Q and dV += P^T dO
  const uint64_t dk_a = hopper::make_desc(sK, 16, 8 * W::SW, W::LAYOUT);
  const uint64_t dv_a = hopper::make_desc(sV, 16, 8 * W::SW, W::LAYOUT);
  const uint64_t dq_b = hopper::make_desc(sQ(0), 16, 8 * W::SW, W::LAYOUT);
  const uint64_t ddo_b = hopper::make_desc(sDO(0), 16, 8 * W::SW, W::LAYOUT);
  const uint64_t dq_t = hopper::make_desc(sQ(0), BM * W::SW, 8 * W::SW,
                                          W::LAYOUT);
  const uint64_t ddo_t = hopper::make_desc(sDO(0), BM * W::SW, 8 * W::SW,
                                           W::LAYOUT);

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  hopper::mbar_wait(bar_kv, 0);
  for (int i = 0; i < n; ++i) {
    const int stage = i % C::STAGES;
    // warp 0 refills this slot with tile i + STAGES once it is read; that
    // tile's row data loads meanwhile
    const bool refill = warp == 0 && i + C::STAGES < n;
    RowMeta<BM> next;
    if (refill) next = meta_of(i + C::STAGES);
    hopper::mbar_wait(bar_full(stage), (i / C::STAGES) & 1);
    const int q0 = row_of(i);
    const float* tl = slot_lse + stage * BM;
    const float* td = slot_dl + stage * BM;
    const int* ts = slot_seg + stage * BM;
    const uint32_t slot = stage * (2 * C::QT_BYTES / 16);

    // S^T = K Q^T and dP^T = V dO^T: 64 keys x BM q rows
    float st[BM / 2], dpt[BM / 2];
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::wgmma_ss<BM>(st, dk_a + hopper::kmajor_step(kk, BN, W::SW),
                           dq_b + slot + hopper::kmajor_step(kk, BM, W::SW),
                           kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::wgmma_ss<BM>(dpt, dv_a + hopper::kmajor_step(kk, BN, W::SW),
                           ddo_b + slot + hopper::kmajor_step(kk, BM, W::SW),
                           kk > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(st);
    hopper::fence_regs(dpt);

    // mask only where some entry of the tile needs it (q rows past S need
    // none: their lse is LSE_PAD, so p is 0)
    bool need = causal && k0 + BN - 1 > q0;
    if (segb && !need) {
      const int a = ts[0], z = ts[BM - 1];  // -1 past S
      need = !(a == z && a == sk_lo && sk_lo == sk_hi);
    }
    // p^T = exp2(s^T * scale_log2 - lse2[col]), 0 where masked, kept in st;
    // ds^T = p^T * (dp^T * scale - delta[col] * scale), kept in dpt
#pragma unroll
    for (int j = 0; j < BM / 8; ++j) {
      const int c0 = 8 * j + 2 * t;
      const float2 l2 = *reinterpret_cast<const float2*>(tl + c0);
      const float2 dl = *reinterpret_cast<const float2*>(td + c0);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float lc = e ? l2.y : l2.x, dc = e ? dl.y : dl.x;
        float pa = fast_exp2(fmaf(st[4 * j + e], scale_log2, -lc));
        float pb = fast_exp2(fmaf(st[4 * j + 2 + e], scale_log2, -lc));
        if (need) {
          const int col = q0 + c0 + e;
          bool keep_a = true, keep_b = true;
          if (causal) {
            keep_a = ka <= col;
            keep_b = kb <= col;
          }
          if (segb) {
            const int sq = ts[c0 + e];
            keep_a = keep_a && ska == sq;
            keep_b = keep_b && skb == sq;
          }
          if (!keep_a) pa = 0.f;
          if (!keep_b) pb = 0.f;
        }
        st[4 * j + e] = pa;
        st[4 * j + 2 + e] = pb;
        dpt[4 * j + e] = pa * fmaf(dpt[4 * j + e], scale, -dc);
        dpt[4 * j + 2 + e] = pb * fmaf(dpt[4 * j + 2 + e], scale, -dc);
      }
    }

    // dV += P^T dO and dK += dS^T Q: the left operands (bf16) from
    // registers, dO and Q read MN-major in their slot
    uint32_t pf[BM / 16][4], df[BM / 16][4];
    to_a_frags<BM>(pf, st);
    to_a_frags<BM>(df, dpt);
    hopper::wgmma_fence();
#pragma unroll
    for (int c = 0; c < BM / 16; ++c)  // 16 q rows of dO down
      hopper::wgmma_rs_tnsp<D>(dv_acc, pf[c], ddo_t + slot + c * W::SW);
#pragma unroll
    for (int c = 0; c < BM / 16; ++c)
      hopper::wgmma_rs_tnsp<D>(dk_acc, df[c], dq_t + slot + c * W::SW);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dv_acc);
    hopper::fence_regs(dk_acc);

    // the products are done, so every warp is past this slot
    if (refill) publish(i + C::STAGES, stage, next);
  }
  // a CTA with no tile to visit writes zeros
  const size_t row = (size_t)bkv * S + ka;
  store_rows<D>(dk, dk_acc, row, ka, S, t);
  store_rows<D>(dv, dv_acc, row, ka, S, t);
}

// ---------------------------------------------------------------------------
// float32: plain FMAs over 64-row tiles, all tiles in shared memory
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

// cudaFuncSetAttribute once per kernel instantiation and device, not on
// every launch (KIND tells the four kernels apart)
template <int KIND, int D>
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

// The current device's SM count, looked up once per device.
cudaError_t sm_count(int* n) {
  static int count[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && count[dev] > 0) {
    *n = count[dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(n, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < 64) count[dev] = *n;
  return err;
}

// The four per-head tensor maps: q and dO as [B*H, S, D] with boxes of
// q_rows, k and v as [B*KVH, S, D] with boxes of k_rows.
template <int D>
int encode_maps(CUtensorMap (&m)[4], const void* q, const void* k,
                const void* v, const void* dout, int B, int H, int KVH,
                int S, int q_rows, int k_rows) {
  constexpr int CW = Sw<D>::CW;
  int err = hopper::encode_tensor_map(&m[0], q, B * H, S, D, q_rows, CW);
  if (err == 0)
    err = hopper::encode_tensor_map(&m[1], k, B * KVH, S, D, k_rows, CW);
  if (err == 0)
    err = hopper::encode_tensor_map(&m[2], v, B * KVH, S, D, k_rows, CW);
  if (err == 0)
    err = hopper::encode_tensor_map(&m[3], dout, B * H, S, D, q_rows, CW);
  return err;
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, const int* seg, void* dq,
              int B, int H, int KVH, int S, int causal, float scale,
              int is_bf16, cudaStream_t st) {
  if (is_bf16) {
    using C = DqCfg<D>;
    const int q_tiles = (S + C::BM - 1) / C::BM;
    if (q_tiles > 65535) return (int)cudaErrorInvalidValue;
    CUtensorMap m[4];
    int err = encode_maps<D>(m, q, k, v, dout, B, H, KVH, S, C::BM, C::BN);
    if (err != 0) return err;
    cudaError_t e = set_smem_once<0, D>(
        reinterpret_cast<const void*>(&flash_bwd_dq_bf16_kernel<D>),
        C::SMEM);
    if (e != cudaSuccess) return (int)e;
    flash_bwd_dq_bf16_kernel<D><<<dim3(B * H, q_tiles), WS_THREADS, C::SMEM,
                                  st>>>(
        m[0], m[1], m[2], m[3], lse, delta, seg,
        static_cast<__nv_bfloat16*>(dq), H, KVH, S, causal, scale,
        scale * LOG2E);
  } else {
    const size_t smem = f32_dq_smem_bytes<D>();
    cudaError_t err = set_smem_once<1, D>(
        reinterpret_cast<const void*>(&flash_bwd_dq_f32_kernel<D>), smem);
    if (err != cudaSuccess) return (int)err;
    flash_bwd_dq_f32_kernel<D><<<dim3((S + TILE - 1) / TILE, B * H),
                                 NUM_THREADS, smem, st>>>(
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
  if (is_bf16) {
    using C = DkvCfg<D>;
    const int k_tiles = (S + C::BN - 1) / C::BN;
    if (k_tiles > 65535) return (int)cudaErrorInvalidValue;
    CUtensorMap m[4];
    int err = encode_maps<D>(m, q, k, v, dout, B, H, KVH, S, C::BM, C::BN);
    if (err != 0) return err;
    cudaError_t e = set_smem_once<2, D>(
        reinterpret_cast<const void*>(&flash_bwd_dkv_bf16_kernel<D>),
        C::SMEM);
    if (e != cudaSuccess) return (int)e;
    int sms = 0;
    e = sm_count(&sms);
    if (e != cudaSuccess) return (int)e;
    const int fold = causal && B * KVH * k_tiles <= 2 * sms ? sms : 0;
    flash_bwd_dkv_bf16_kernel<D><<<dim3(B * KVH, k_tiles), C::THREADS,
                                   C::SMEM, st>>>(
        m[0], m[1], m[2], m[3], lse, delta, seg,
        static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), H,
        KVH, S, causal, scale, scale * LOG2E, fold);
  } else {
    const size_t smem = f32_dkv_smem_bytes<D>();
    cudaError_t err = set_smem_once<3, D>(
        reinterpret_cast<const void*>(&flash_bwd_dkv_f32_kernel<D>), smem);
    if (err != cudaSuccess) return (int)err;
    flash_bwd_dkv_f32_kernel<D><<<dim3((S + TILE - 1) / TILE, B * KVH),
                                  NUM_THREADS, smem, st>>>(
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
// All tensors contiguous on the current device, q/k/v/dO 16-byte aligned
// (the TMA descriptors need it); seg may be null.
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
