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
//   positions 0..index. Scores f32, NEG_INF = -1e30 masking, online
//   softmax in f32, probabilities cast to v's dtype before P.V.
//
// What bounds it: decode attention reads every live kv byte once and does
// ~2 flops per byte, far below the card's ridge point, so it is bound by
// memory bandwidth (and, at 8 slots x 8 kv heads = 64 CTAs, by too few
// CTAs to fill 132 SMs). This first version reads only live pages (the
// loop stops at index), one CTA of 256 threads per (slot, kv head) so the
// group's `rep` q heads share every K/V tile read (GQA batched, kv never
// widened), with 16-byte vector loads of 64-position tiles into shared
// memory (K rows padded against bank conflicts). Split-K over the
// positions and cp.async/TMA pipelining are later work.
//
// Sink page: idle slots have all-zero table rows and index 0, so every
// idle CTA writes row 0 of page 0 concurrently and reads it back. That
// race is benign: page 0 is never allocated, so no token the host keeps
// is computed from it (a slot reads it only past its coverage, in steps
// after it has finished), and the idle slots' outputs are discarded.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;  // kv positions per step
constexpr int NUM_THREADS = 256;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
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

// 16-byte vectors; K rows are padded by one vector so that the score
// loop's 16-byte reads of 8 consecutive rows hit 8 distinct bank groups
template <typename T>
__host__ __device__ constexpr int vec() { return 16 / sizeof(T); }
template <typename T, int HD>
__host__ __device__ constexpr int k_stride() {
  return HD + vec<T>();
}

template <typename T, int HD>
size_t smem_bytes(int rep) {
  return (size_t)TILE * (k_stride<T, HD>() + HD) * sizeof(T) +
         (size_t)(2 * rep * HD + rep * TILE + 3 * rep) * sizeof(float);
}

// The pools are neither const nor __restrict__: this CTA writes its new
// row and reads it back, so the loads must not take the read-only path.
template <typename T, int HD>
__global__ void __launch_bounds__(NUM_THREADS)
    paged_decode_kernel(const T* __restrict__ q, T* k_pages, T* v_pages,
                        const int* __restrict__ page_table,
                        const int* __restrict__ index,
                        const T* __restrict__ k_new,
                        const T* __restrict__ v_new, T* __restrict__ out,
                        int H, int KVH, int ps, int pps, float scale) {
  constexpr int VEC = vec<T>();
  constexpr int CHUNKS = HD / VEC;
  constexpr int KS = k_stride<T, HD>();
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int rep = H / KVH;
  T* sK = reinterpret_cast<T*>(smem_raw);           // [TILE][KS]
  T* sV = sK + TILE * KS;                           // [TILE][HD]
  float* sQ = reinterpret_cast<float*>(sV + TILE * HD);  // [rep][HD]
  float* sAcc = sQ + rep * HD;                      // [rep][HD]
  float* sS = sAcc + rep * HD;                      // [rep][TILE]
  float* sM = sS + rep * TILE;
  float* sL = sM + rep;
  float* sAlpha = sL + rep;

  const int b = blockIdx.x / KVH, g = blockIdx.x % KVH;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int idx = index[b];
  const int* pt = page_table + (size_t)b * pps;

  // 1. land the step's kv row (visible to this CTA after the barrier)
  {
    const int page = pt[idx / ps];
    const size_t row = (((size_t)page * KVH + g) * ps + idx % ps) * HD;
    const size_t src = ((size_t)b * KVH + g) * HD;
    for (int d = tid; d < HD; d += NUM_THREADS) {
      k_pages[row + d] = k_new[src + d];
      v_pages[row + d] = v_new[src + d];
    }
  }
  // 2. the group's rep q rows (heads g*rep .. g*rep+rep-1 are contiguous)
  const T* qg = q + ((size_t)b * H + (size_t)g * rep) * HD;
  for (int i = tid; i < rep * HD; i += NUM_THREADS) {
    sQ[i] = to_f(qg[i]);
    sAcc[i] = 0.f;
  }
  for (int i = tid; i < rep; i += NUM_THREADS) {
    sM[i] = NEG_INF;
    sL[i] = 0.f;
  }
  __syncthreads();

  // 3. online softmax over the live positions 0..idx, TILE at a time
  const int n_live = idx + 1;
  for (int p0 = 0; p0 < n_live; p0 += TILE) {
    for (int i = tid; i < TILE * CHUNKS; i += NUM_THREADS) {
      const int j = i / CHUNKS, c = (i % CHUNKS) * VEC, pos = p0 + j;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (pos < n_live) {
        const size_t row =
            (((size_t)pt[pos / ps] * KVH + g) * ps + pos % ps) * HD + c;
        kv = *reinterpret_cast<const uint4*>(k_pages + row);
        vv = *reinterpret_cast<const uint4*>(v_pages + row);
      }
      *reinterpret_cast<uint4*>(sK + j * KS + c) = kv;
      *reinterpret_cast<uint4*>(sV + j * HD + c) = vv;
    }
    __syncthreads();

    for (int i = tid; i < rep * TILE; i += NUM_THREADS) {
      const int r = i / TILE, j = i % TILE;
      const float* qr = sQ + r * HD;  // same r across a warp: broadcast
      const T* kr = sK + j * KS;
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < HD; c += VEC) {
        const uint4 raw = *reinterpret_cast<const uint4*>(kr + c);
        const T* kv = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int e = 0; e < VEC; ++e) s = fmaf(qr[c + e], to_f(kv[e]), s);
      }
      sS[i] = (p0 + j < n_live) ? s * scale : NEG_INF;
    }
    __syncthreads();

    for (int r = warp; r < rep; r += NUM_THREADS / 32) {
      const float m_prev = sM[r];  // read before the shuffles below
      float mx = NEG_INF;
      for (int j = lane; j < TILE; j += 32) mx = fmaxf(mx, sS[r * TILE + j]);
      const float m_cur = fmaxf(m_prev, warp_max(mx));
      float sum = 0.f;
      for (int j = lane; j < TILE; j += 32) {
        const float p = expf(sS[r * TILE + j] - m_cur);
        sum += p;
        sS[r * TILE + j] = to_f(from_f<T>(p));  // p in v's dtype
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

    for (int i = tid; i < rep * HD; i += NUM_THREADS) {
      const int r = i / HD, d = i % HD;
      const float* pr = sS + r * TILE;
      float s = 0.f;
#pragma unroll 8
      for (int j = 0; j < TILE; ++j) s = fmaf(pr[j], to_f(sV[j * HD + d]), s);
      sAcc[i] = sAcc[i] * sAlpha[r] + s;
    }
    __syncthreads();  // before the next tile overwrites sK / sV / sS
  }

  T* og = out + ((size_t)b * H + (size_t)g * rep) * HD;
  for (int i = tid; i < rep * HD; i += NUM_THREADS)
    og[i] = from_f<T>(sAcc[i] / fmaxf(sL[i / HD], 1e-30f));
}

template <typename T, int HD>
int launch(const void* q, void* kp, void* vp, const int* pt, const int* idx,
           const void* kn, const void* vn, void* out, int B, int H, int KVH,
           int ps, int pps, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, HD>(H / KVH);
  auto kern = paged_decode_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<B * KVH, NUM_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<T*>(kp), static_cast<T*>(vp), pt,
      idx, static_cast<const T*>(kn), static_cast<const T*>(vn),
      static_cast<T*>(out), H, KVH, ps, pps, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(const void* q, void* kp, void* vp, const int* pt,
                const int* idx, const void* kn, const void* vn, void* out,
                int B, int H, int KVH, int ps, int pps, int HD, float scale,
                cudaStream_t stream) {
  switch (HD) {
    case 32:
      return launch<T, 32>(q, kp, vp, pt, idx, kn, vn, out, B, H, KVH, ps,
                           pps, scale, stream);
    case 64:
      return launch<T, 64>(q, kp, vp, pt, idx, kn, vn, out, B, H, KVH, ps,
                           pps, scale, stream);
    case 128:
      return launch<T, 128>(q, kp, vp, pt, idx, kn, vn, out, B, H, KVH, ps,
                            pps, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// int8 pools (the TPU kernel's `quant` branch)
// ---------------------------------------------------------------------------
//
// Pools k/v [P, KVH, ps, HD] int8 and scale pools [P, KVH, ps] f32, a row
// standing for int8 * scale. The fused write quantises the step's new row
// with exactly `quantize_kv_rows`' formula (scale = max|x| / 127 floored at
// 1e-8, then rint(x / scale) clamped to +-127; true division and rintf's
// round-half-even, so pools and scales are bit-equal to the plain version's).
// Attention reads the live int8 rows into shared memory (half the bytes of
// bf16 pools) and widens them in registers; as on the TPU, the k scale
// multiplies the scores after Q.K and the v scale the probabilities (after
// the normaliser has taken them, before they are cast to q's dtype for P.V).
// Bound, structure and sink-page race as for the native kernel above.

constexpr int I8_VEC = 16;  // int8 values per 16-byte vector

template <int HD>
__host__ __device__ constexpr int i8_k_stride() {
  return HD + I8_VEC;
}

template <int HD>
size_t smem_bytes_int8(int rep) {
  return (size_t)TILE * (i8_k_stride<HD>() + HD) +
         (size_t)(2 * TILE + 2 * rep * HD + rep * TILE + 3 * rep) *
             sizeof(float);
}

// One warp quantises one [HD] row: returns this lane's scale (all lanes
// agree) and writes the int8 row to dst.
template <typename T, int HD>
__device__ __forceinline__ float quantize_row(const T* src, int8_t* dst,
                                              int lane) {
  float amax = 0.f;
  for (int d = lane; d < HD; d += 32) amax = fmaxf(amax, fabsf(to_f(src[d])));
  amax = warp_max(amax);
  const float scale = fmaxf(amax / 127.0f, 1e-8f);
  for (int d = lane; d < HD; d += 32) {
    const float v = fminf(fmaxf(rintf(to_f(src[d]) / scale), -127.f), 127.f);
    dst[d] = (int8_t)v;
  }
  return scale;
}

template <typename T, int HD>
__global__ void __launch_bounds__(NUM_THREADS)
    paged_decode_int8_kernel(const T* __restrict__ q, int8_t* k_pages,
                             int8_t* v_pages, float* k_scale, float* v_scale,
                             const int* __restrict__ page_table,
                             const int* __restrict__ index,
                             const T* __restrict__ k_new,
                             const T* __restrict__ v_new, T* __restrict__ out,
                             int H, int KVH, int ps, int pps, float scale) {
  constexpr int CHUNKS = HD / I8_VEC;
  constexpr int KS = i8_k_stride<HD>();
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int rep = H / KVH;
  int8_t* sK = reinterpret_cast<int8_t*>(smem_raw);  // [TILE][KS]
  int8_t* sV = sK + TILE * KS;                       // [TILE][HD]
  float* sKs = reinterpret_cast<float*>(sV + TILE * HD);  // [TILE]
  float* sVs = sKs + TILE;                                 // [TILE]
  float* sQ = sVs + TILE;                            // [rep][HD]
  float* sAcc = sQ + rep * HD;                       // [rep][HD]
  float* sS = sAcc + rep * HD;                       // [rep][TILE]
  float* sM = sS + rep * TILE;
  float* sL = sM + rep;
  float* sAlpha = sL + rep;

  const int b = blockIdx.x / KVH, g = blockIdx.x % KVH;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int idx = index[b];
  const int* pt = page_table + (size_t)b * pps;

  // 1. quantise and land the step's kv row and its scales (warp 0: k,
  //    warp 1: v; visible to this CTA after the barrier)
  if (warp < 2) {
    const int page = pt[idx / ps];
    const size_t srow = ((size_t)page * KVH + g) * ps + idx % ps;
    const size_t src = ((size_t)b * KVH + g) * HD;
    int8_t* pool = warp == 0 ? k_pages : v_pages;
    const float s = quantize_row<T, HD>((warp == 0 ? k_new : v_new) + src,
                                        pool + srow * HD, lane);
    if (lane == 0) (warp == 0 ? k_scale : v_scale)[srow] = s;
  }
  // 2. the group's rep q rows (heads g*rep .. g*rep+rep-1 are contiguous)
  const T* qg = q + ((size_t)b * H + (size_t)g * rep) * HD;
  for (int i = tid; i < rep * HD; i += NUM_THREADS) {
    sQ[i] = to_f(qg[i]);
    sAcc[i] = 0.f;
  }
  for (int i = tid; i < rep; i += NUM_THREADS) {
    sM[i] = NEG_INF;
    sL[i] = 0.f;
  }
  __syncthreads();

  // 3. online softmax over the live positions 0..idx, TILE at a time
  const int n_live = idx + 1;
  for (int p0 = 0; p0 < n_live; p0 += TILE) {
    for (int i = tid; i < TILE * CHUNKS; i += NUM_THREADS) {
      const int j = i / CHUNKS, c = (i % CHUNKS) * I8_VEC, pos = p0 + j;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (pos < n_live) {
        const size_t row =
            (((size_t)pt[pos / ps] * KVH + g) * ps + pos % ps) * HD + c;
        kv = *reinterpret_cast<const uint4*>(k_pages + row);
        vv = *reinterpret_cast<const uint4*>(v_pages + row);
      }
      *reinterpret_cast<uint4*>(sK + j * KS + c) = kv;
      *reinterpret_cast<uint4*>(sV + j * HD + c) = vv;
    }
    for (int j = tid; j < TILE; j += NUM_THREADS) {
      const int pos = p0 + j;
      float ks = 0.f, vs = 0.f;
      if (pos < n_live) {
        const size_t srow = ((size_t)pt[pos / ps] * KVH + g) * ps + pos % ps;
        ks = k_scale[srow];
        vs = v_scale[srow];
      }
      sKs[j] = ks;
      sVs[j] = vs;
    }
    __syncthreads();

    for (int i = tid; i < rep * TILE; i += NUM_THREADS) {
      const int r = i / TILE, j = i % TILE;
      const float* qr = sQ + r * HD;  // same r across a warp: broadcast
      const int8_t* kr = sK + j * KS;
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < HD; c += I8_VEC) {
        const uint4 raw = *reinterpret_cast<const uint4*>(kr + c);
        const int8_t* kv = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
        for (int e = 0; e < I8_VEC; ++e)
          s = fmaf(qr[c + e], (float)kv[e], s);
      }
      sS[i] = (p0 + j < n_live) ? (s * scale) * sKs[j] : NEG_INF;
    }
    __syncthreads();

    for (int r = warp; r < rep; r += NUM_THREADS / 32) {
      const float m_prev = sM[r];  // read before the shuffles below
      float mx = NEG_INF;
      for (int j = lane; j < TILE; j += 32) mx = fmaxf(mx, sS[r * TILE + j]);
      const float m_cur = fmaxf(m_prev, warp_max(mx));
      float sum = 0.f;
      for (int j = lane; j < TILE; j += 32) {
        const float p = expf(sS[r * TILE + j] - m_cur);
        sum += p;
        sS[r * TILE + j] = to_f(from_f<T>(p * sVs[j]));  // in q's dtype
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

    for (int i = tid; i < rep * HD; i += NUM_THREADS) {
      const int r = i / HD, d = i % HD;
      const float* pr = sS + r * TILE;
      float s = 0.f;
#pragma unroll 8
      for (int j = 0; j < TILE; ++j) s = fmaf(pr[j], (float)sV[j * HD + d], s);
      sAcc[i] = sAcc[i] * sAlpha[r] + s;
    }
    __syncthreads();  // before the next tile overwrites the tiles
  }

  T* og = out + ((size_t)b * H + (size_t)g * rep) * HD;
  for (int i = tid; i < rep * HD; i += NUM_THREADS)
    og[i] = from_f<T>(sAcc[i] / fmaxf(sL[i / HD], 1e-30f));
}

template <typename T, int HD>
int launch_int8(const void* q, int8_t* kp, int8_t* vp, float* ks, float* vs,
                const int* pt, const int* idx, const void* kn, const void* vn,
                void* out, int B, int H, int KVH, int ps, int pps,
                float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes_int8<HD>(H / KVH);
  auto kern = paged_decode_int8_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<B * KVH, NUM_THREADS, smem, stream>>>(
      static_cast<const T*>(q), kp, vp, ks, vs, pt, idx,
      static_cast<const T*>(kn), static_cast<const T*>(vn),
      static_cast<T*>(out), H, KVH, ps, pps, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd_int8(const void* q, int8_t* kp, int8_t* vp, float* ks,
                     float* vs, const int* pt, const int* idx, const void* kn,
                     const void* vn, void* out, int B, int H, int KVH, int ps,
                     int pps, int HD, float scale, cudaStream_t stream) {
  switch (HD) {
    case 32:
      return launch_int8<T, 32>(q, kp, vp, ks, vs, pt, idx, kn, vn, out, B,
                                H, KVH, ps, pps, scale, stream);
    case 64:
      return launch_int8<T, 64>(q, kp, vp, ks, vs, pt, idx, kn, vn, out, B,
                                H, KVH, ps, pps, scale, stream);
    case 128:
      return launch_int8<T, 128>(q, kp, vp, ks, vs, pt, idx, kn, vn, out, B,
                                 H, KVH, ps, pps, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). Returns a cudaError_t code.
// All tensors contiguous on the current device.
extern "C" int paged_decode(const void* q, void* k_pages, void* v_pages,
                            const int* page_table, const int* index,
                            const void* k_new, const void* v_new, void* out,
                            int B, int H, int KVH, int ps, int pps, int HD,
                            float scale, int is_bf16, void* stream) {
  if (B <= 0 || KVH <= 0 || H % KVH != 0 || ps <= 0 || pps <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch_hd<__nv_bfloat16>(q, k_pages, v_pages, page_table, index,
                                      k_new, v_new, out, B, H, KVH, ps, pps,
                                      HD, scale, st);
  return dispatch_hd<float>(q, k_pages, v_pages, page_table, index, k_new,
                            v_new, out, B, H, KVH, ps, pps, HD, scale, st);
}

// int8 pools: k_pages/v_pages [P, KVH, ps, HD] int8 and k_scale/v_scale
// [P, KVH, ps] f32, all updated in place by the fused write; q, k_new,
// v_new and out in float32 or bf16 (is_bf16). Returns a cudaError_t code.
extern "C" int paged_decode_int8(const void* q, void* k_pages, void* v_pages,
                                 void* k_scale, void* v_scale,
                                 const int* page_table, const int* index,
                                 const void* k_new, const void* v_new,
                                 void* out, int B, int H, int KVH, int ps,
                                 int pps, int HD, float scale, int is_bf16,
                                 void* stream) {
  if (B <= 0 || KVH <= 0 || H % KVH != 0 || ps <= 0 || pps <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* kp = static_cast<int8_t*>(k_pages);
  int8_t* vp = static_cast<int8_t*>(v_pages);
  float* ks = static_cast<float*>(k_scale);
  float* vs = static_cast<float*>(v_scale);
  if (is_bf16)
    return dispatch_hd_int8<__nv_bfloat16>(q, kp, vp, ks, vs, page_table,
                                           index, k_new, v_new, out, B, H,
                                           KVH, ps, pps, HD, scale, st);
  return dispatch_hd_int8<float>(q, kp, vp, ks, vs, page_table, index, k_new,
                                 v_new, out, B, H, KVH, ps, pps, HD, scale,
                                 st);
}
