// One-token decode attention over paged KV pools for Hopper (sm_90a),
// with the write of the step's new kv row fused in.
//
// Replaces the Pallas TPU kernel `_paged_decode_kernel` (called through
// `paged_decode_attention`) in multi_spatialmllm_tpu/ops/paged_attention.py:
// entry `paged_decode` for native-dtype pools, entry `paged_decode_int8` for
// its `quant` branch (int8 pools with per-row f32 scales, below).
//
// Semantics (held against the gather-window plain version in
// ops/paged_attention.py):
//   q [B, H, HD]; pools k/v [P, KVH, ps, HD] updated IN PLACE;
//   page_table [B, PPS] int32 (logical page -> pool page); index [B] int32;
//   k_new/v_new [B, KVH, HD]. Each slot first lands its new kv row at
//   (page_table[b, index/ps], index % ps), then attends over logical
//   positions 0..index. Scores f32, NEG_INF = -1e30 masking, softmax in
//   f32, probabilities cast to v's dtype (int8 pools: q's dtype, after the
//   v scale) before P.V.
//
// What bounds it: decode attention reads every live kv byte once and does
// ~2 flops a byte with rep <= 8 q rows a kv head, far below the card's
// ridge point: it is bound by memory bandwidth, and at serving sizes
// (a few MB a call) by latency: how many bytes are in flight, on how many
// SMs. A CTA per (slot, kv head) walking its slot alone leaves half the
// SMs idle and waits out two dependent global latencies a tile. So:
//
// 1. Split over positions. The grid is (split, slot x kv head), with
//    `n_split` splits a (slot, kv head) that the wrapper's plan
//    (`split_plan`) takes from the shapes alone, never from `index`, so
//    the launch is static and captures in a CUDA graph. Each CTA reads
//    its slot's index and deals the live chunks (`chunk` positions inside
//    one page) 0..index/chunk out in order over min(n_split, live chunks)
//    splits: a long slot spreads over all its splits, a short one leaves
//    the rest with nothing to read (they exit at once, and the combine
//    reads only the live ones).
// 2. A ring of page chunks fed by bulk copies. For one (page, kv head) a
//    chunk's K rows are one contiguous block (as are its V rows and, for
//    int8, its two scale runs), so one thread issues one `cp.async.bulk`
//    per block, completing on the stage's mbarrier (warp 0 reads the
//    slot's first 64 page-table entries beside the index, so a chunk's
//    page costs no dependent global read). Two stages are in flight, so
//    chunk i+1 loads while chunk i is computed, and several CTAs share an
//    SM. Rows past index in the last chunk are copied with it and
//    masked: the score, softmax and P.V loops stop at index.
// 3. The fused write. The last live split, whose last chunk holds index,
//    writes the new row (quantised for int8 with `quantize_kv_rows`'
//    arithmetic) to the pool and patches it into its stage after the copy
//    lands (as the TPU kernel does), so no ordering between the generic
//    store and the bulk copy is needed. That chunk is the CTA's last, so
//    no copy refills a stage it patched.
// 4. A fixed-order combine. A split leaves (m, l, unnormalised f32 acc
//    [REP, HD]) in the wrapper's workspace and takes a ticket; the last of
//    a (slot, kv head)'s live splits combines all of them in split order
//    and resets the ticket, so two calls on the same inputs are
//    bit-identical. A slot with one live split writes its output directly.
//
// Compute is CUDA-core FMA (wgmma's 64-row products would be mostly
// padding): a warp splits each K/V row over LPR lanes (16-byte bf16/f32
// or 8-byte int8 vectors, contiguous, so no bank conflicts in the
// unpadded bulk-copied rows), each lane keeping its slice of the REP q
// rows and of the accumulators in registers.
//
// Sink page: idle slots have all-zero table rows and index 0, so every
// idle slot's CTA writes row 0 of page 0 concurrently (and patches its own
// row into shared memory). That race is benign: page 0 is never
// allocated, so no token the host keeps is computed from it (a slot reads
// it only past its coverage, in steps after it has finished), and the
// idle slots' outputs are discarded.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int NUM_THREADS = 256;
constexpr int NUM_WARPS = NUM_THREADS / 32;
constexpr int MAX_STAGES = 2;
// a chunk: at most 128 positions and 16 KB of K rows
constexpr int MAX_CHUNK = 128;
constexpr int MAX_CHUNK_BYTES = 16384;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// pool elements a lane loads at once: 16 bytes of f32 or bf16, 8 of int8
template <typename P>
__host__ __device__ constexpr int vec() {
  return sizeof(P) == 4 ? 4 : 8;
}

template <typename P, int VEC>
__device__ __forceinline__ void load_vec(const P* src, float (&f)[VEC]) {
  if constexpr (sizeof(P) * VEC == 16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src);
    const P* e = reinterpret_cast<const P*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) f[i] = to_f(e[i]);
  } else {
    // int8 without I2F (a quarter-rate conversion): a byte b ^ 0x80 is
    // b + 128, placed under the exponent of 2^23 it reads 2^23 + b + 128,
    // and one subtraction leaves b exactly
    const uint2 raw = *reinterpret_cast<const uint2*>(src);
    const uint32_t w[2] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u};
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      f[i] = __uint_as_float(__byte_perm(w[i / 4], 0x4B000000u,
                                         0x7540 + i % 4)) -
             8388736.f;
  }
}

__host__ __device__ constexpr int align16(int x) { return (x + 15) & ~15; }
__host__ __device__ constexpr int ilog2(int x) {
  return x <= 1 ? 0 : 1 + ilog2(x / 2);
}

template <typename P, int HD>
__host__ __device__ constexpr int max_chunk() {
  return MAX_CHUNK_BYTES / (HD * (int)sizeof(P)) < MAX_CHUNK
             ? MAX_CHUNK_BYTES / (HD * (int)sizeof(P))
             : MAX_CHUNK;
}

// Dynamic shared memory, in byte offsets: MAX_STAGES stages of [K chunk |
// V chunk | (int8) k scales | v scales], then the scores [REP][chunk],
// the warps' accumulators [NUM_WARPS][REP][HD] (over the stages, which
// are free by then, where they fit), m / l / alpha [REP], the new rows
// (two f32 scales, then [2][HD] pool elements), the barriers.
template <typename P, int HD, int REP>
struct Layout {
  static constexpr bool QUANT = std::is_same<P, int8_t>::value;
  int chunk;
  __host__ __device__ int kv_bytes() const {
    return chunk * HD * (int)sizeof(P);
  }
  __host__ __device__ int scale_bytes() const { return QUANT ? chunk * 4 : 0; }
  __host__ __device__ int stage_bytes() const {
    return 2 * kv_bytes() + 2 * scale_bytes();
  }
  __host__ __device__ int scores() const {
    return MAX_STAGES * stage_bytes();
  }
  static constexpr int RED_BYTES = NUM_WARPS * REP * HD * 4;
  __host__ __device__ bool red_on_stages() const {
    return scores() >= RED_BYTES;
  }
  __host__ __device__ int red() const {
    return red_on_stages() ? 0 : scores() + align16(REP * chunk * 4);
  }
  __host__ __device__ int stats() const {
    return scores() + align16(REP * chunk * 4) +
           (red_on_stages() ? 0 : RED_BYTES);
  }
  __host__ __device__ int new_rows() const {
    return stats() + align16(3 * REP * 4);
  }
  __host__ __device__ int bars() const {
    return new_rows() + align16(8 + 2 * HD * (int)sizeof(P));
  }
  __host__ __device__ int bytes() const {
    return bars() + 8 * MAX_STAGES + 16;
  }
};

// One warp quantises one [HD] row with `quantize_kv_rows`' arithmetic
// (scale = max|x| / 127 floored at 1e-8, true division, rintf's
// round-half-even, clamp to +-127): writes it to the pool row `dst` and to
// shared memory `sdst`, returns the scale (all lanes agree).
template <typename T, int HD>
__device__ __forceinline__ float quantize_row(const T* src, int8_t* dst,
                                              int8_t* sdst, int lane) {
  float amax = 0.f;
  for (int d = lane; d < HD; d += 32) amax = fmaxf(amax, fabsf(to_f(src[d])));
  amax = warp_max(amax);
  const float scale = fmaxf(amax / 127.0f, 1e-8f);
  for (int d = lane; d < HD; d += 32) {
    const float v = fminf(fmaxf(rintf(to_f(src[d]) / scale), -127.f), 127.f);
    dst[d] = sdst[d] = (int8_t)v;
  }
  return scale;
}

// T: q's dtype (float or bf16); P: the pools' (T, or int8 with scales).
// REP: the q rows of a kv head rounded up to 1, 2, 4 or 8 (rows past the
// true rep are computed on zero q rows and not written). The pools are
// neither const nor __restrict__: the CTA holding index writes its row.
template <typename T, typename P, int HD, int REP>
__global__ void __launch_bounds__(NUM_THREADS,
                                  REP <= 2 ? 3 : REP <= 4 ? 2 : 1)
    paged_decode_split_kernel(const T* __restrict__ q, P* k_pages,
                              P* v_pages, float* k_scale, float* v_scale,
                              const int* __restrict__ page_table,
                              const int* __restrict__ index,
                              const T* __restrict__ k_new,
                              const T* __restrict__ v_new, T* __restrict__ out,
                              float* __restrict__ ws,
                              int* __restrict__ tickets,
                              int H, int KVH, int ps, int pps, int chunk,
                              float scale) {
  using Lay = Layout<P, HD, REP>;
  constexpr bool QUANT = Lay::QUANT;
  constexpr int VEC = vec<P>(), LPR = HD / VEC, GPW = 32 / LPR,
                JG = NUM_THREADS / LPR;
  // after the scores' reduce-scatter: rows a lane holds, and the low lane
  // bits whose lanes hold the same totals (only the lowest lane writes)
  constexpr int RK = REP > LPR ? REP / LPR : 1;
  constexpr int WRITERS = REP >= LPR ? 0 : LPR / REP - 1;
  extern __shared__ __align__(128) unsigned char smem[];

  const int split = blockIdx.x, n_split = gridDim.x, bg = blockIdx.y;
  const int b = bg / KVH, g = bg % KVH, rep = H / KVH;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int* pt = page_table + (size_t)b * pps;
  // warp 0 holds the slot's first 64 page-table entries, read in flight
  // with the index (the chunks' pages then cost no dependent read)
  int pt_lo = 0, pt_hi = 0;
  if (warp == 0) {
    if (lane < pps) pt_lo = pt[lane];
    if (lane + 32 < pps) pt_hi = pt[lane + 32];
  }
  const int idx = index[b];
  // the slot's live chunks 0..idx/chunk dealt out in order over the live
  // splits: split s takes q consecutive chunks, or q + 1 for the first
  // `extra` splits; splits past the live chunks have nothing to read
  const int live = idx / chunk + 1, n_live = min(n_split, live);
  if (split >= n_live) return;
  const int q_chunks = live / n_live, extra = live % n_live;
  const int n_chunks = q_chunks + (split < extra);
  const int run0 = (split * q_chunks + min(split, extra)) * chunk;
  const bool holds_idx = split == n_live - 1;
  const int dv = lane % LPR, jg = warp * GPW + lane / LPR;

  const Lay lay{chunk};
  float* sS = reinterpret_cast<float*>(smem + lay.scores());
  float* sRed = reinterpret_cast<float*>(smem + lay.red());
  float* sM = reinterpret_cast<float*>(smem + lay.stats());
  float* sL = sM + REP;
  float* sAlpha = sL + REP;
  float* sNewScale = reinterpret_cast<float*>(smem + lay.new_rows());
  P* sNew = reinterpret_cast<P*>(smem + lay.new_rows() + 8);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + lay.bars());
  int* sLast = reinterpret_cast<int*>(bars + MAX_STAGES);

  // warp 0: the page of the CTA's chunk c; then lane 0 issues one bulk
  // copy per contiguous block of it into stage s
  auto issue = [&](int c, int s) {
    const int pos = run0 + c * chunk, p = pos / ps;
    int page = __shfl_sync(0xffffffffu, p < 32 ? pt_lo : pt_hi, p % 32);
    if (lane != 0) return;
    if (p >= 64) page = pt[p];
    const size_t row = ((size_t)page * KVH + g) * ps + pos % ps;
    const uint32_t bar = hopper::smem_u32(bars + s);
    const uint32_t dst = hopper::smem_u32(smem + s * lay.stage_bytes());
    hopper::mbar_arrive_expect_tx(bar, lay.stage_bytes());
    hopper::bulk_load(dst, k_pages + row * HD, lay.kv_bytes(), bar);
    hopper::bulk_load(dst + lay.kv_bytes(), v_pages + row * HD,
                      lay.kv_bytes(), bar);
    if constexpr (QUANT) {
      hopper::bulk_load(dst + 2 * lay.kv_bytes(), k_scale + row,
                        lay.scale_bytes(), bar);
      hopper::bulk_load(dst + 2 * lay.kv_bytes() + lay.scale_bytes(),
                        v_scale + row, lay.scale_bytes(), bar);
    }
  };
  if (warp == 0) {
    if (lane == 0) {
      for (int s = 0; s < MAX_STAGES; ++s)
        hopper::mbar_init(hopper::smem_u32(bars + s), 1);
      hopper::fence_barrier_init();
    }
    __syncwarp();
    for (int c = 0; c < min(MAX_STAGES, n_chunks); ++c) issue(c, c);
  }

  // the fused write, while the first chunks are in flight
  if (holds_idx) {
    const size_t row = ((size_t)pt[idx / ps] * KVH + g) * ps + idx % ps;
    const size_t src = (size_t)bg * HD;
    if constexpr (QUANT) {
      if (warp < 2) {
        const float s = quantize_row<T, HD>(
            (warp == 0 ? k_new : v_new) + src,
            (warp == 0 ? k_pages : v_pages) + row * HD, sNew + warp * HD,
            lane);
        if (lane == 0) {
          (warp == 0 ? k_scale : v_scale)[row] = s;
          sNewScale[warp] = s;
        }
      }
    } else {
      for (int d = tid; d < HD; d += NUM_THREADS) {
        const P kv = k_new[src + d], vv = v_new[src + d];
        k_pages[row * HD + d] = sNew[d] = kv;
        v_pages[row * HD + d] = sNew[HD + d] = vv;
      }
    }
  }
  // this lane's slice of the group's q rows (heads g*rep .. g*rep+rep-1)
  float qr[REP][VEC], acc[REP][VEC];
  const T* qg = q + ((size_t)b * H + (size_t)g * rep) * HD + dv * VEC;
#pragma unroll
  for (int r = 0; r < REP; ++r)
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      qr[r][e] = r < rep ? to_f(qg[r * HD + e]) : 0.f;
      acc[r][e] = 0.f;
    }
  if (tid < REP) {
    sM[tid] = NEG_INF;
    sL[tid] = 0.f;
  }
  __syncthreads();

  for (int c = 0; c < n_chunks; ++c) {
    const int s = c % MAX_STAGES;
    hopper::mbar_wait(hopper::smem_u32(bars + s), (c / MAX_STAGES) & 1);
    P* sK = reinterpret_cast<P*>(smem + s * lay.stage_bytes());
    P* sV = sK + chunk * HD;
    float* sKs = reinterpret_cast<float*>(sV + chunk * HD);
    float* sVs = sKs + chunk;
    const int pos0 = run0 + c * chunk;
    const int n_valid = min(chunk, idx - pos0 + 1);
    if (holds_idx && idx - pos0 < chunk) {  // the chunk holding index
      const int j = idx - pos0;
      for (int d = tid; d < HD; d += NUM_THREADS) {
        sK[j * HD + d] = sNew[d];
        sV[j * HD + d] = sNew[HD + d];
      }
      if (QUANT && tid == 0) {
        sKs[j] = sNewScale[0];
        sVs[j] = sNewScale[1];
      }
      __syncthreads();
    }

    // scores of the live rows: LPR lanes a row, JG rows at a time
#pragma unroll 2
    for (int j0 = 0; j0 < n_valid; j0 += JG) {
      const int j = j0 + jg;
      float kf[VEC];
      if (j < n_valid) {
        load_vec<P, VEC>(sK + j * HD + dv * VEC, kf);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) kf[e] = 0.f;
      }
      float part[REP];
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        float a = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) a = fmaf(qr[r][e], kf[e], a);
        part[r] = a;
      }
      // sum over the row's LPR lanes by reduce-scatter: each halving round
      // trades half the rows with the partner lane, so a lane ends with
      // the totals of RK rows from r0; the rounds left once one row
      // remains sum it
      int r0 = 0;
#pragma unroll
      for (int step = 0; step < ilog2(LPR); ++step) {
        const int o = LPR >> (step + 1), n = REP >> (step + 1);
        if (n >= 1) {
          const bool up = dv & o;
#pragma unroll
          for (int i = 0; i < n; ++i) {
            const float send = up ? part[i] : part[i + n];
            const float keep = up ? part[i + n] : part[i];
            part[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
          }
          if (up) r0 += n;
        } else {
          part[0] += __shfl_xor_sync(0xffffffffu, part[0], o);
        }
      }
      if ((dv & WRITERS) == 0 && j < n_valid) {
#pragma unroll
        for (int k = 0; k < RK; ++k) {
          float sc = part[k] * scale;
          if constexpr (QUANT) sc *= sKs[j];
          sS[(r0 + k) * chunk + j] = sc;
        }
      }
    }
    __syncthreads();

    // online softmax over the chunk, a warp a row
    for (int r = warp; r < REP; r += NUM_WARPS) {
      float* row = sS + r * chunk;
      const float m_prev = sM[r];
      float mx = NEG_INF;
      for (int j = lane; j < n_valid; j += 32) mx = fmaxf(mx, row[j]);
      const float m_cur = fmaxf(m_prev, warp_max(mx));
      float sum = 0.f;
      for (int j = lane; j < n_valid; j += 32) {
        float p = expf(row[j] - m_cur);
        sum += p;
        if constexpr (QUANT) p *= sVs[j];
        row[j] = to_f(from_f<T>(p));  // in v's (int8: q's) dtype
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_cur);
        sAlpha[r] = alpha;
        sL[r] = sL[r] * alpha + sum;
        sM[r] = m_cur;
      }
    }
    __syncthreads();

    // P.V over the live rows (rows past index may hold anything)
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      const float a = sAlpha[r];
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[r][e] *= a;
    }
    for (int j = jg; j < n_valid; j += JG) {
      float vf[VEC];
      load_vec<P, VEC>(sV + j * HD + dv * VEC, vf);
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        const float p = sS[r * chunk + j];
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[r][e] = fmaf(p, vf[e], acc[r][e]);
      }
    }
    __syncthreads();  // stage s and the scores are free again
    if (warp == 0 && c + MAX_STAGES < n_chunks) issue(c + MAX_STAGES, s);
  }

  // sum the accumulators over the position groups, in a fixed order
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1)
#pragma unroll
    for (int r = 0; r < REP; ++r)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], o);
  if (lane < LPR) {
#pragma unroll
    for (int r = 0; r < REP; ++r)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        sRed[(warp * REP + r) * HD + dv * VEC + e] = acc[r][e];
  }
  __syncthreads();
  auto split_acc = [&](int i) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < NUM_WARPS; ++w) a += sRed[w * REP * HD + i];
    return a;
  };

  T* og = out + ((size_t)b * H + (size_t)g * rep) * HD;
  if (n_live == 1) {
    for (int i = tid; i < rep * HD; i += NUM_THREADS)
      og[i] = from_f<T>(split_acc(i) / fmaxf(sL[i / HD], 1e-30f));
    return;
  }
  // this split's partial: acc [REP][HD], then (m, l) [REP]
  constexpr int STRIDE = REP * (HD + 2);
  float* w_bg = ws + (size_t)bg * n_split * STRIDE;
  float* mine = w_bg + (size_t)split * STRIDE;
  for (int i = tid; i < REP * HD; i += NUM_THREADS) mine[i] = split_acc(i);
  if (tid < REP) {
    mine[REP * HD + 2 * tid] = sM[tid];
    mine[REP * HD + 2 * tid + 1] = sL[tid];
  }
  __syncthreads();
  if (tid == 0) {
    __threadfence();  // the CTA's partial, ordered by the barrier, first
    *sLast = atomicAdd(tickets + bg, 1) == n_live - 1;
  }
  __syncthreads();
  if (!*sLast) return;
  __threadfence();
  // the last live split: combine splits 0..n_live-1 in split order, one
  // pass rescaling to the running max (the loads of 8 splits in flight)
  for (int i = tid; i < rep * HD; i += NUM_THREADS) {
    const int ml = REP * HD + 2 * (i / HD);
    float m = NEG_INF, a = 0.f, l = 0.f;
#pragma unroll 8
    for (int sp = 0; sp < n_live; ++sp) {
      const float* part = w_bg + (size_t)sp * STRIDE;
      const float m_i = __ldcg(part + ml), l_i = __ldcg(part + ml + 1),
                  a_i = __ldcg(part + i);
      const float m_new = fmaxf(m, m_i);
      const float f = expf(m - m_new), f_i = expf(m_i - m_new);
      a = a * f + a_i * f_i;
      l = l * f + l_i * f_i;
      m = m_new;
    }
    og[i] = from_f<T>(a / fmaxf(l, 1e-30f));
  }
  if (tid == 0) tickets[bg] = 0;  // ready for the next call
}

// cudaFuncSetAttribute once per instantiation and device (its largest
// layout), not on every launch: decode launches under a host-bound loop
template <typename T, typename P, int HD, int REP>
cudaError_t set_smem_once(const void* kern, int smem) {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

struct Args {
  const void* q;
  void *k_pages, *v_pages, *k_scale, *v_scale;
  const int *page_table, *index;
  const void *k_new, *v_new;
  void* out;
  float* ws;
  int* tickets;
  int B, H, KVH, ps, pps, HD, chunk, n_split;
  float scale;
  cudaStream_t stream;
};

template <typename T, typename P, int HD, int REP>
int launch(const Args& a) {
  using Lay = Layout<P, HD, REP>;
  if (a.chunk < 1 || a.chunk > max_chunk<P, HD>() || a.ps % a.chunk ||
      (Lay::QUANT && a.chunk % 4) || a.n_split < 1)
    return (int)cudaErrorInvalidValue;
  auto kern = paged_decode_split_kernel<T, P, HD, REP>;
  cudaError_t err = set_smem_once<T, P, HD, REP>(
      reinterpret_cast<const void*>(kern),
      Lay{max_chunk<P, HD>()}.bytes());
  if (err != cudaSuccess) return (int)err;
  const int smem = Lay{a.chunk}.bytes();
  kern<<<dim3(a.n_split, a.B * a.KVH), NUM_THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<P*>(a.k_pages),
      static_cast<P*>(a.v_pages), static_cast<float*>(a.k_scale),
      static_cast<float*>(a.v_scale), a.page_table, a.index,
      static_cast<const T*>(a.k_new), static_cast<const T*>(a.v_new),
      static_cast<T*>(a.out), a.ws, a.tickets, a.H, a.KVH, a.ps, a.pps,
      a.chunk, a.scale);
  return (int)cudaGetLastError();
}

template <typename T, typename P, int HD>
int dispatch_rep(const Args& a) {
  const int rep = a.H / a.KVH;
  if (rep == 1) return launch<T, P, HD, 1>(a);
  if (rep == 2) return launch<T, P, HD, 2>(a);
  if (rep <= 4) return launch<T, P, HD, 4>(a);
  if (rep <= 8) return launch<T, P, HD, 8>(a);
  return (int)cudaErrorInvalidValue;
}

template <typename T, bool QUANT>
int dispatch(const Args& a) {
  using P = typename std::conditional<QUANT, int8_t, T>::type;
  switch (a.HD) {
    case 32:
      return dispatch_rep<T, P, 32>(a);
    case 64:
      return dispatch_rep<T, P, 64>(a);
    case 128:
      return dispatch_rep<T, P, 128>(a);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <bool QUANT>
int entry(const Args& a, int is_bf16) {
  if (a.B <= 0 || a.KVH <= 0 || a.H % a.KVH != 0 || a.ps <= 0 || a.pps <= 0)
    return (int)cudaErrorInvalidValue;
  return is_bf16 ? dispatch<__nv_bfloat16, QUANT>(a)
                 : dispatch<float, QUANT>(a);
}

}  // namespace

// Plain C entry points (bound with ctypes). Return a cudaError_t code. All
// tensors contiguous on the current device, pools and scale pools 16-byte
// aligned. `workspace`: B*KVH*n_split*REP*(HD+2) floats, REP the rep
// rounded up to 1, 2, 4 or 8; `tickets`: B*KVH ints, zero on entry and
// left zero; (chunk, n_split): the wrapper's split plan. q, k_new, v_new
// and out in float32 or bf16 (is_bf16), rep at most 8, HD 32, 64 or 128.
extern "C" int paged_decode(const void* q, void* k_pages, void* v_pages,
                            const int* page_table, const int* index,
                            const void* k_new, const void* v_new, void* out,
                            void* workspace, void* tickets, int B, int H,
                            int KVH, int ps, int pps, int HD, int chunk,
                            int n_split, float scale, int is_bf16,
                            void* stream) {
  const Args a{q, k_pages, v_pages, nullptr, nullptr, page_table, index,
               k_new, v_new, out, static_cast<float*>(workspace),
               static_cast<int*>(tickets), B, H, KVH, ps, pps, HD, chunk,
               n_split, scale, static_cast<cudaStream_t>(stream)};
  return entry<false>(a, is_bf16);
}

// int8 pools: k_pages/v_pages [P, KVH, ps, HD] int8 and k_scale/v_scale
// [P, KVH, ps] f32 (a row stands for int8 * scale), all updated in place
// by the quantised fused write. As on the TPU, the k scale multiplies the
// scores after Q.K and the v scale the probabilities (after the
// normaliser has taken them, before they are cast to q's dtype for P.V).
extern "C" int paged_decode_int8(const void* q, void* k_pages, void* v_pages,
                                 void* k_scale, void* v_scale,
                                 const int* page_table, const int* index,
                                 const void* k_new, const void* v_new,
                                 void* out, void* workspace, void* tickets,
                                 int B, int H, int KVH, int ps, int pps,
                                 int HD, int chunk, int n_split,
                                 float scale, int is_bf16, void* stream) {
  const Args a{q, k_pages, v_pages, k_scale, v_scale, page_table, index,
               k_new, v_new, out, static_cast<float*>(workspace),
               static_cast<int*>(tickets), B, H, KVH, ps, pps, HD, chunk,
               n_split, scale, static_cast<cudaStream_t>(stream)};
  return entry<true>(a, is_bf16);
}
