// Grouped matrix products of the routed MoE for Hopper (sm_90a): `gmm`,
// its transposed-rhs form `gmm_t`, and `tgmm`.
//
// Replaces the megablox Pallas TPU kernels that `_pallas_gmm` and its
// custom VJP call in multi_spatialmllm_tpu/models/moe.py (:133-165: `gmm`
// for the forward, `gmm(transpose_rhs=True)` for dlhs, `tgmm` for drhs;
// the library is jax/experimental/pallas/ops/tpu/megablox/gmm.py).
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
// Two bf16 paths, chosen by the wrapper from M (a shape, known on the
// host):
//
// The general path (every form; train and prefill shapes) is bound by
// tensor-core operations: a train-shape call is 275 GFLOP against ~0.3 GB
// moved. `gmm_wgmma_kernel` is persistent: one CTA an SM walks a list of
// work items with stride gridDim.x, which every CTA derives from
// group_sizes in shared memory (offsets, then per-group tile counts or a
// largest-first group order, by warp scans). A CTA is a producer warp that
// keeps TMA loads in flight through a ring of 64-deep stages (128-byte
// rows, 128-byte swizzle; one full and one empty mbarrier a slot; the ring
// runs on across items, so the next item's loads overlap this one's
// epilogue) and two consumer warpgroups that own 64 rows each of a
// 128 x BN output tile and run wgmma m64nBNk16 with both operands in
// shared memory, keeping one stage's products in flight. BN is 256 (128
// f32 accumulators a thread: ptxas fits them in the 168 registers a
// 12-warp block gets, with no spill) wherever that still gives every SM
// an item, else 128. Each form reads its operands where they lie, with no
// copies: gmm's A (lhs) is K-major and its B (w[g], [K, N]) MN-major
// (read transposed); gmm_t's A (dy) and B (w[g] rows, contracted over N)
// are both K-major; tgmm's A (lhs^T) and B (dy) are both MN-major and the
// contraction runs over the group's rows. The epilogue stages each warp's
// 16 x 64 blocks in shared memory and stores whole 128-byte row segments:
// the fragments' own 4-byte stores (16 bytes of a row each) cost as much
// as the products at K 2048.
//   gmm / gmm_t items: (group g, 128-row tile overlapping g's rows, BN
//   column tile), plus the tiles that write zeros past the groups' total;
//   a tile that straddles a boundary is one item per group, each a full K
//   loop with its group's weights, storing only its group's rows (the TMA
//   boxes need no masking). Items run in bands of 1024 output columns,
//   row tiles outer, so the CTAs in flight share the band's weight columns
//   and a few row tiles in L2.
//   tgmm items: (group g, 128-row tile of K, BN column tile), groups
//   largest first (a skewed split does not end on one long CTA), each
//   contracting over g's rows in 64-row steps that start at the group's
//   first row. A step's rows past the group's end belong to the next
//   group: the consumers zero them in both operands' slots and fence the
//   writes to the async proxy before the products read them.
//
// The few-rows path (gmm at M <= 64: decode) is bound by the weights'
// bytes: 16 rows in three live groups read ~100 MB of weights for ~0.5
// GFLOP. `gmm_rows_kernel` swaps the operands, out^T[N, rows_g] =
// w[g]^T x_g^T, so the weight fills wgmma's 64-row side (A, MN-major) and
// a group's <= 64 rows are its N (B = the rows of x, K-major): items are
// (live group, 128 columns of N, K part); each CTA (one consumer
// warpgroup, one producer warp) streams its items' weight tiles through a
// 7-8 stage TMA ring; an empty group's weights are never read. On the
// general kernel these rows would cost a 128-row tile's products for
// every weight tile. The contraction is cut in parts only where the items
// would leave most SMs idle (one live group, the down projection); the
// parts write f32 partials to a workspace and `gmm_splitk_reduce_kernel`
// sums them in a fixed order and rounds once: results are bitwise
// repeatable.
//
// The float32 path (the f32 test configs) is a plain FMA kernel, one
// output per thread.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int MAX_GROUPS = 512;

enum Mode { GMM = 0, GMM_T = 1, TGMM = 2 };

using bf16 = __nv_bfloat16;

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

// ---------------------------------------------------------------------------
// group tables for the bf16 kernels
// ---------------------------------------------------------------------------

// In-place exclusive prefix sum of v[0, n) by one whole warp; v[n] gets
// the total.
__device__ __forceinline__ void warp_exclusive_scan(int* v, int n) {
  const int lane = threadIdx.x & 31;
  int carry = 0;
  for (int base = 0; base < n; base += 32) {
    const int x = base + lane < n ? v[base + lane] : 0;
    int incl = x;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    if (base + lane < n) v[base + lane] = carry + incl - x;
    carry += __shfl_sync(0xffffffffu, incl, 31);
  }
  if (lane == 0) v[n] = carry;
  __syncwarp();
}

// off[g] = the clamped exclusive cumsum of the sizes, g = 0..E, by the
// whole block (every thread calls it).
__device__ __forceinline__ void block_group_offsets(int* off,
                                                    const int* sizes, int E,
                                                    int M) {
  for (int g = threadIdx.x; g < E; g += blockDim.x)
    off[g] = max(__ldg(sizes + g), 0);
  __syncthreads();
  if (threadIdx.x < 32) warp_exclusive_scan(off, E);
  __syncthreads();
  for (int g = threadIdx.x; g <= E; g += blockDim.x) off[g] = min(off[g], M);
  __syncthreads();
}

// ---------------------------------------------------------------------------
// bf16, general path: persistent, warp-specialised wgmma kernel
// ---------------------------------------------------------------------------

constexpr int BM = 128;  // output rows a tile: two consumer warpgroups of 64
constexpr int BK = 64;   // contraction a stage: 128-byte rows
constexpr uint32_t BOX_BYTES = 64 * 64 * 2;  // one [64][64] TMA box
constexpr int GEN_THREADS = 384;  // producer warpgroup, two consumers
constexpr int BAND_COLS = 1024;   // output columns a band of items
// barriers (<= 256 bytes), then three int tables of up to MAX_GROUPS + 2
// entries; the ring starts on the next 1024-byte boundary after them
constexpr uint32_t TABLE_BYTES = 7 * 1024;
constexpr uint32_t TABLE_STRIDE = 2304;
// the epilogue's staging: a consumer warp's 16 rows x 64 columns in bf16,
// rows padded to 144 bytes (the fragment writes hit 32 distinct banks)
constexpr int STG_LD = 72;
constexpr uint32_t STG_BYTES = 16 * STG_LD * 2;

template <int BN>
struct GenCfg {
  static constexpr int B_BOXES = BN / 64;
  static constexpr uint32_t STAGE_BYTES = (2 + B_BOXES) * BOX_BYTES;
  static constexpr int STAGES = BN == 128 ? 6 : 4;
  static constexpr int BAND = BAND_COLS / BN;  // column tiles a band
  static constexpr size_t SMEM = 1024 + TABLE_BYTES +
                                 (size_t)STAGES * STAGE_BYTES + 8 * STG_BYTES;
};

// One work item: the group, the output tile's first row and column, the
// rows [lo, hi) it covers (gmm / gmm_t: of the tile, to store; tgmm: of
// the group, to contract), and its 64-deep contraction steps.
struct Tile {
  int g, row0, col0, lo, hi, steps;
};

// gmm / gmm_t: item -> (group, 128-row tile, BN-column tile). cum[g] is
// the number of row tiles of groups before g (g = E: the rows past the
// total, which store zeros), cum[E + 1] their total.
template <int BN>
__device__ __forceinline__ Tile gmm_tile(int item, const int* off,
                                         const int* cum, int E, int M,
                                         int n_tiles, int k_steps) {
  constexpr int BAND = GenCfg<BN>::BAND;
  const int m_items = cum[E + 1];
  const int band = item / (m_items * BAND);
  const int nb = min(BAND, n_tiles - band * BAND);
  const int r = item - band * m_items * BAND;
  const int mi = r / nb;
  int a = 0, b = E + 1;  // the last g with cum[g] <= mi
  while (b - a > 1) {
    const int mid = (a + b) >> 1;
    if (cum[mid] <= mi)
      a = mid;
    else
      b = mid;
  }
  const int lo = off[a], hi = a < E ? off[a + 1] : M;
  Tile t;
  t.g = a;
  t.row0 = (lo / BM + mi - cum[a]) * BM;
  t.col0 = (band * BAND + r % nb) * BN;
  t.lo = max(lo, t.row0);
  t.hi = min(hi, t.row0 + BM);
  t.steps = a < E ? k_steps : 0;
  return t;
}

// tgmm: item -> (group order[.], 128-row tile of K, BN-column tile of N)
__device__ __forceinline__ Tile tgmm_tile(int item, const int* off,
                                          const int* order, int k_tiles,
                                          int n_tiles, int bn) {
  const int per = k_tiles * n_tiles;
  const int g = order[item / per], rem = item % per;
  Tile t;
  t.g = g;
  t.row0 = (rem % k_tiles) * BM;
  t.col0 = (rem / k_tiles) * bn;
  t.lo = off[g];
  t.hi = off[g + 1];
  t.steps = (t.hi - t.lo + BK - 1) / BK;
  return t;
}

// The TMA loads of one stage: A as two [64][64] boxes (gmm / gmm_t: 128
// rows x 64 of the contraction; tgmm: 64 group rows x 128 columns of K),
// B as BN / 64 boxes.
template <int MODE, int BN>
__device__ __forceinline__ void load_stage(uint32_t slot, uint32_t bar,
                                           const CUtensorMap* ta,
                                           const CUtensorMap* tb,
                                           const Tile& t, int s) {
  constexpr int B_BOXES = GenCfg<BN>::B_BOXES;
  hopper::mbar_arrive_expect_tx(bar, GenCfg<BN>::STAGE_BYTES);
  const uint32_t sb = slot + 2 * BOX_BYTES;
  if (MODE == TGMM) {
    const int r = t.lo + s * BK;  // lhs [M, K], dy [M, N] rows
#pragma unroll
    for (int j = 0; j < 2; ++j)
      hopper::tma_load_3d(slot + j * BOX_BYTES, ta, bar, t.row0 + 64 * j, r,
                          0);
#pragma unroll
    for (int j = 0; j < B_BOXES; ++j)
      hopper::tma_load_3d(sb + j * BOX_BYTES, tb, bar, t.col0 + 64 * j, r, 0);
  } else {
    const int c = s * BK;  // contraction columns of A
#pragma unroll
    for (int j = 0; j < 2; ++j)
      hopper::tma_load_3d(slot + j * BOX_BYTES, ta, bar, c, t.row0 + 64 * j,
                          0);
#pragma unroll
    for (int j = 0; j < B_BOXES; ++j) {
      if (MODE == GMM)  // w[g] rows c.. (K), columns col0.. (N)
        hopper::tma_load_3d(sb + j * BOX_BYTES, tb, bar, t.col0 + 64 * j, c,
                            t.g);
      else  // w[g] rows col0.. (K: the output columns), columns c.. (N)
        hopper::tma_load_3d(sb + j * BOX_BYTES, tb, bar, c, t.col0 + 64 * j,
                            t.g);
    }
  }
}

// gmm (MODE GMM: a = lhs [M, K], b = rhs [E, K, N], out [M, N]), gmm_t
// (GMM_T: a = dy [M, N], b = rhs [E, K, N], out [M, K]) and tgmm (TGMM:
// a = lhs [M, K], b = dy [M, N], out [E, K, N]); tm_a / tm_b map a and b
// as [depth, rows, cols] with [64][64] boxes.
template <int MODE, int BN>
__global__ void __launch_bounds__(GEN_THREADS, 1)
    gmm_wgmma_kernel(const __grid_constant__ CUtensorMap tm_a,
                     const __grid_constant__ CUtensorMap tm_b,
                     const int* __restrict__ sizes, bf16* __restrict__ out,
                     int M, int K, int N, int E) {
  using C = GenCfg<BN>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t base = (hopper::smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - hopper::smem_u32(smem_raw));
  const uint32_t ring = base + TABLE_BYTES;
  auto bar_full = [=](int st) { return base + 8u * st; };
  auto bar_empty = [=](int st) { return base + 128u + 8u * st; };
  int* off = reinterpret_cast<int*>(gbase + 256);
  int* aux = reinterpret_cast<int*>(gbase + 256 + TABLE_STRIDE);

  if (threadIdx.x == 0) {
    for (int st = 0; st < C::STAGES; ++st) {
      hopper::mbar_init(bar_full(st), 1);
      hopper::mbar_init(bar_empty(st), 8);  // one arrival a consumer warp
    }
    hopper::fence_barrier_init();
  }
  block_group_offsets(off, sizes, E, M);
  const int n_out = MODE == GMM ? N : MODE == GMM_T ? K : N;
  const int n_tiles = (n_out + BN - 1) / BN;
  const int k_tiles = (K + BM - 1) / BM;  // tgmm
  const int k_steps = ((MODE == GMM ? K : N) + BK - 1) / BK;
  int n_items;
  if (MODE == TGMM) {
    // groups by size, largest first (ties by index): aux[rank] = g
    for (int g = threadIdx.x; g < E; g += blockDim.x) {
      const int sz = off[g + 1] - off[g];
      int rank = 0;
      for (int h = 0; h < E; ++h) {
        const int sh = off[h + 1] - off[h];
        rank += sh > sz || (sh == sz && h < g);
      }
      aux[rank] = g;
    }
    __syncthreads();
    n_items = E * k_tiles * n_tiles;
  } else {
    // row tiles of each group, g = E being the rows past the total
    for (int g = threadIdx.x; g <= E; g += blockDim.x) {
      const int lo = off[g], hi = g < E ? off[g + 1] : M;
      aux[g] = hi > lo ? (hi - 1) / BM - lo / BM + 1 : 0;
    }
    __syncthreads();
    if (threadIdx.x < 32) warp_exclusive_scan(aux, E + 1);
    __syncthreads();
    n_items = aux[E + 1] * n_tiles;
  }
  auto tile_of = [&](int item) {
    return MODE == TGMM
               ? tgmm_tile(item, off, aux, k_tiles, n_tiles, BN)
               : gmm_tile<BN>(item, off, aux, E, M, n_tiles, k_steps);
  };
  const int wg = threadIdx.x / 128;

  if (wg == 0) {
    // producer: one thread walks the items and fills the ring
    if (BN > 128) hopper::reg_dealloc<40>();
    if (threadIdx.x == 0) {
      int stage = 0, phase = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
        const Tile t = tile_of(item);
        for (int s = 0; s < t.steps; ++s) {
          hopper::mbar_wait(bar_empty(stage), phase ^ 1);  // slot released
          load_stage<MODE, BN>(ring + stage * C::STAGE_BYTES,
                               bar_full(stage), &tm_a, &tm_b, t, s);
          if (++stage == C::STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // consumers: warpgroup cw owns rows [64 cw, 64 cw + 64) of the tile
    if (BN > 128) hopper::reg_alloc<232>();
    const int cw = wg - 1;
    const int ctid = threadIdx.x - 128;  // 0..255
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g8 = lane / 4, t4 = lane % 4;
    // descriptors of slot 0 (a slot adds STAGE_BYTES / 16, a 16-deep step
    // of a K-major operand 2 (32 bytes along its rows), of an MN-major
    // one 128 (16 rows of 128 bytes)); MN-major: LBO = the stride between
    // 64-column boxes, SBO = 8 rows
    constexpr int TA = MODE == TGMM;
    constexpr int TB = MODE != GMM_T;
    const uint64_t da = hopper::make_desc(ring + cw * BOX_BYTES,
                                          TA ? BOX_BYTES : 16, 1024, 1);
    const uint64_t db = hopper::make_desc(ring + 2 * BOX_BYTES,
                                          TB ? BOX_BYTES : 16, 1024, 1);
    constexpr uint32_t a_step = TA ? 128 : 2, b_step = TB ? 128 : 2;
    bf16* stg = reinterpret_cast<bf16*>(gbase + (ring - base) +
                                        C::STAGES * C::STAGE_BYTES +
                                        (ctid / 32) * STG_BYTES);

    float acc[BN / 2];
    int stage = 0, phase = 0;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
      const Tile t = tile_of(item);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      int prev = -1;
      for (int s = 0; s < t.steps; ++s) {
        hopper::mbar_wait(bar_full(stage), phase);
        const uint32_t so = stage * (C::STAGE_BYTES / 16);
        if (MODE == TGMM && s == t.steps - 1) {
          const int valid = t.hi - (t.lo + s * BK);
          if (valid < BK) {
            // rows valid.. of every box of the slot are the next group's:
            // zero them (whole 128-byte rows, whatever the swizzle)
            unsigned char* slot =
                gbase + (ring - base) + stage * C::STAGE_BYTES;
            const int units = (BK - valid) * 8;  // 16-byte units a box
            for (int u = ctid; u < (2 + C::B_BOXES) * units; u += 256) {
              const int bx = u / units, rem = u % units;
              *reinterpret_cast<uint4*>(slot + bx * BOX_BYTES +
                                        (valid + rem / 8) * 128 +
                                        (rem % 8) * 16) =
                  make_uint4(0u, 0u, 0u, 0u);
            }
            hopper::fence_proxy_async();
            hopper::named_bar_sync(1, 256);
          }
        }
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          hopper::wgmma_ss_t<BN, TA, TB>(acc, da + so + kk * a_step,
                                         db + so + kk * b_step, 1);
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();  // the previous stage's products are done
        if (prev >= 0) {
          __syncwarp();
          if (lane == 0) hopper::mbar_arrive(bar_empty(prev));
        }
        prev = stage;
        if (++stage == C::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      if (prev >= 0) {
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(bar_empty(prev));
      }
      // epilogue: register i holds row 16 warp + g8 + 8 ((i / 2) % 2),
      // column 8 (i / 4) + 2 t4 + i % 2 of this warpgroup's 64 x BN block.
      // Each warp stages its 16 rows 64 columns at a time and writes them
      // as whole 128-byte row segments (16 bytes a lane): the fragments'
      // own 4-byte stores reach only 16 bytes of a row each, which made
      // the stores cost more than the products.
      const int r0w = t.row0 + 64 * cw + 16 * warp;
#pragma unroll
      for (int cb = 0; cb < BN / 64; ++cb) {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int j = 8 * cb + jj;
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<uint32_t*>(stg + (g8 + 8 * h) * STG_LD +
                                         8 * jj + 2 * t4) =
                hopper::pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
        __syncwarp();
#pragma unroll
        for (int it = 0; it < 4; ++it) {
          const int r = 4 * it + lane / 8, ch = lane % 8;
          const int row = r0w + r, col = t.col0 + 64 * cb + 8 * ch;
          const bool ok = (MODE == TGMM ? row < K
                                        : row >= t.lo && row < t.hi) &&
                          col < n_out;
          if (ok) {
            bf16* dst = MODE == TGMM ? out + ((size_t)t.g * K + row) * N
                                     : out + (size_t)row * n_out;
            *reinterpret_cast<uint4*>(dst + col) =
                *reinterpret_cast<const uint4*>(stg + r * STG_LD + 8 * ch);
          }
        }
        __syncwarp();
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16, few-rows path (gmm, M <= ROWS_MAX): swapped operands
// ---------------------------------------------------------------------------

constexpr int ROWS_MAX = 64;
constexpr int ROWS_THREADS = 160;  // one consumer warpgroup, a producer warp
constexpr int RN = 128;  // weight columns an item: two wgmma M of 64
constexpr int RSTG_LD = RN + 4;  // f32 staging row, padded: 132 floats

template <int NR>
struct RowsCfg {
  static constexpr uint32_t X_BYTES = NR * 128;  // [NR][64] rows of x
  static constexpr uint32_t STAGE_BYTES = 2 * BOX_BYTES + X_BYTES;
  static constexpr int STAGES = NR == 64 ? 7 : 8;
  // an item's [NR rows][RN columns] in f32, staged for row-wise stores
  static constexpr uint32_t STG_BYTES = NR * RSTG_LD * 4;
  static constexpr size_t SMEM =
      1024 + TABLE_BYTES + (size_t)STAGES * STAGE_BYTES + STG_BYTES;
};

// lhs [M, K] (tm_x: [1, M, K], boxes [NR][64]) against rhs [E, K, N]
// (tm_w, boxes [64][64]); NR >= M. splits == 1: out [M, N] in bf16;
// splits > 1: f32 partials ws [splits, M, N] (rows past the total
// unwritten), summed by gmm_splitk_reduce_kernel.
template <int NR>
__global__ void __launch_bounds__(ROWS_THREADS, 1)
    gmm_rows_kernel(const __grid_constant__ CUtensorMap tm_w,
                    const __grid_constant__ CUtensorMap tm_x,
                    const int* __restrict__ sizes, bf16* __restrict__ out,
                    float* __restrict__ ws, int M, int K, int N, int E,
                    int splits) {
  using C = RowsCfg<NR>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t base = (hopper::smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - hopper::smem_u32(smem_raw));
  const uint32_t ring = base + TABLE_BYTES;
  auto bar_full = [=](int st) { return base + 8u * st; };
  auto bar_empty = [=](int st) { return base + 128u + 8u * st; };
  int* off = reinterpret_cast<int*>(gbase + 256);
  int* pos = reinterpret_cast<int*>(gbase + 256 + TABLE_STRIDE);
  int* live = reinterpret_cast<int*>(gbase + 256 + 2 * TABLE_STRIDE);
  float* stg = reinterpret_cast<float*>(gbase + TABLE_BYTES +
                                        C::STAGES * C::STAGE_BYTES);

  if (threadIdx.x == 0) {
    for (int st = 0; st < C::STAGES; ++st) {
      hopper::mbar_init(bar_full(st), 1);
      hopper::mbar_init(bar_empty(st), 4);  // one arrival a consumer warp
    }
    hopper::fence_barrier_init();
  }
  block_group_offsets(off, sizes, E, M);
  // the live groups, in order: live[0, n_live)
  for (int g = threadIdx.x; g < E; g += blockDim.x)
    pos[g] = off[g + 1] > off[g];
  __syncthreads();
  if (threadIdx.x < 32) warp_exclusive_scan(pos, E);
  __syncthreads();
  for (int g = threadIdx.x; g < E; g += blockDim.x)
    if (off[g + 1] > off[g]) live[pos[g]] = g;
  __syncthreads();
  const int n_live = pos[E];
  const int n_blocks = (N + RN - 1) / RN;
  const int k_steps = (K + BK - 1) / BK;
  const int n_items = n_live * n_blocks * splits;
  // item -> (live group, column block, split), the split fastest
  auto item_of = [&](int item, int& g, int& col0, int& k_lo, int& k_hi) {
    const int sp = item % splits, rest = item / splits;
    g = live[rest / n_blocks];
    col0 = (rest % n_blocks) * RN;
    k_lo = sp * k_steps / splits;
    k_hi = (sp + 1) * k_steps / splits;
  };

  if (splits == 1) {  // rows past the total are zero
    const int total = off[E];
    const size_t n_zero = (size_t)(M - total) * N;
    for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
         i < n_zero; i += (size_t)gridDim.x * blockDim.x)
      out[(size_t)total * N + i] = __float2bfloat16(0.f);
  }

  if (threadIdx.x >= 128) {
    // producer: warp 4's lane 0 streams the weight tiles and the rows
    if (threadIdx.x == 128) {
      int stage = 0, phase = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
        int g, col0, k_lo, k_hi;
        item_of(item, g, col0, k_lo, k_hi);
        for (int ks = k_lo; ks < k_hi; ++ks) {
          hopper::mbar_wait(bar_empty(stage), phase ^ 1);
          const uint32_t slot = ring + stage * C::STAGE_BYTES;
          const uint32_t full = bar_full(stage);
          hopper::mbar_arrive_expect_tx(full, C::STAGE_BYTES);
#pragma unroll
          for (int j = 0; j < 2; ++j)
            hopper::tma_load_3d(slot + j * BOX_BYTES, &tm_w, full,
                                col0 + 64 * j, ks * BK, g);
          hopper::tma_load_3d(slot + 2 * BOX_BYTES, &tm_x, full, ks * BK,
                              off[g], 0);
          if (++stage == C::STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // the consumer warpgroup: D^T blocks [64 weight columns][NR rows]
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g8 = lane / 4, t4 = lane % 4;
    // A = w^T, MN-major (box j: weight columns col0 + 64 j..); B = the
    // rows of x, K-major
    const uint64_t dw = hopper::make_desc(ring, BOX_BYTES, 1024, 1);
    const uint64_t dx = hopper::make_desc(ring + 2 * BOX_BYTES, 16, 1024, 1);
    float acc[2][NR / 2];
    int stage = 0, phase = 0;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
      int g, col0, k_lo, k_hi;
      item_of(item, g, col0, k_lo, k_hi);
#pragma unroll
      for (int i = 0; i < NR / 2; ++i) acc[0][i] = acc[1][i] = 0.f;
      int prev = -1;
      for (int ks = k_lo; ks < k_hi; ++ks) {
        hopper::mbar_wait(bar_full(stage), phase);
        const uint32_t so = stage * (C::STAGE_BYTES / 16);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
          for (int j = 0; j < 2; ++j)
            hopper::wgmma_ss_t<NR, 1, 0>(
                acc[j], dw + so + j * (BOX_BYTES / 16) + kk * 128,
                dx + so + kk * 2, 1);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();
        if (prev >= 0) {
          __syncwarp();
          if (lane == 0) hopper::mbar_arrive(bar_empty(prev));
        }
        prev = stage;
        if (++stage == C::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc[0]);
      hopper::fence_regs(acc[1]);
      if (prev >= 0) {
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(bar_empty(prev));
      }
      // register i of block j: weight column 64 j + 16 warp + g8 +
      // 8 ((i / 2) % 2), row 8 (i / 4) + 2 t4 + i % 2 of the item. Staged
      // as [rows][columns] in f32, then stored a row segment at a time.
      const int lo = off[g], hi = off[g + 1];
      const int sp = item % splits;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < NR / 2; ++i)
          stg[(8 * (i / 4) + 2 * t4 + i % 2) * RSTG_LD + 64 * j + 16 * warp +
              g8 + 8 * ((i / 2) % 2)] = acc[j][i];
      hopper::named_bar_sync(1, 128);
      for (int idx = threadIdx.x; idx < NR * (RN / 4); idx += 128) {
        const int r = idx / (RN / 4), c = (idx % (RN / 4)) * 4;
        if (lo + r >= hi || col0 + c >= N) continue;
        const float4 v = *reinterpret_cast<const float4*>(
            stg + r * RSTG_LD + c);
        const size_t at = (size_t)(lo + r) * N + col0 + c;
        if (splits == 1)
          *reinterpret_cast<uint2*>(out + at) = make_uint2(
              hopper::pack_bf16(v.x, v.y), hopper::pack_bf16(v.z, v.w));
        else
          *reinterpret_cast<float4*>(ws + (size_t)sp * M * N + at) = v;
      }
      hopper::named_bar_sync(1, 128);  // before the next item's staging
    }
  }
}

// out[M, N] = the sum over s = 0, 1, .. of ws[s] in that order, rounded
// once to bf16; rows past the groups' total zero.
__global__ void __launch_bounds__(256)
    gmm_splitk_reduce_kernel(const float* __restrict__ ws,
                         const int* __restrict__ sizes,
                         bf16* __restrict__ out, int M, int N, int E,
                         int splits) {
  __shared__ int total;
  if (threadIdx.x == 0) total = 0;
  __syncthreads();
  int part = 0;
  for (int g = threadIdx.x; g < E; g += blockDim.x)
    part += max(__ldg(sizes + g), 0);
  atomicAdd(&total, part);  // integers: exact in any order
  __syncthreads();
  const int rows = min(total, M);
  const size_t n4 = (size_t)M * N / 4;  // N % 8 == 0: a float4 is one row's
  const float4* w4 = reinterpret_cast<const float4*>(ws);
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    if ((int)(i * 4 / N) < rows)
      for (int s = 0; s < splits; ++s) {
        const float4 v = w4[(size_t)s * n4 + i];
        a.x += v.x;
        a.y += v.y;
        a.z += v.z;
        a.w += v.w;
      }
    *reinterpret_cast<uint2*>(out + i * 4) =
        make_uint2(hopper::pack_bf16(a.x, a.y), hopper::pack_bf16(a.z, a.w));
  }
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

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

bool bad_shape(int M, int K, int N, int E, int is_bf16) {
  return M < 0 || K <= 0 || N <= 0 || E <= 0 || E > MAX_GROUPS ||
         (is_bf16 && (K % 8 != 0 || N % 8 != 0));
}

// the general path's column tile: 0 picks it by shape (general_tile_n),
// 128 or 256 forces it
int g_tile_n = 0;

int sm_count() {
  static int cached[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 1;
  if (dev < 64 && cached[dev] > 0) return cached[dev];
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      n <= 0)
    return 1;
  if (dev < 64) cached[dev] = n;
  return n;
}

// cudaFuncSetAttribute once per kernel instantiation (KEY) and device
template <int KEY>
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

// Work items of the general kernel at column tile bn (gmm / gmm_t: at
// most, as the tiles that straddle a group boundary depend on the sizes)
template <int MODE>
long general_items(int M, int K, int N, int E, int bn) {
  const long n_tiles = ((MODE == GMM_T ? K : N) + bn - 1) / bn;
  return MODE == TGMM ? (long)E * ((K + BM - 1) / BM) * n_tiles
                      : ((long)(M + BM - 1) / BM + E) * n_tiles;
}

// BN 256 halves the items of BN 128 and reads each A tile half as often:
// faster wherever it still gives every SM an item, slower where it leaves
// SMs idle (both measured by chip_smoke.py phase 10)
template <int MODE>
int general_tile_n(int M, int K, int N, int E) {
  if (g_tile_n != 0) return g_tile_n;
  return general_items<MODE>(M, K, N, E, 256) >= sm_count() ? 256 : 128;
}

// The entry points' names: gmm a = lhs [M, K], b = rhs [E, K, N]; gmm_t
// a = dy [M, N], b = rhs; tgmm a = lhs, b = dy [M, N].
template <int MODE, int BN>
int launch_wgmma(const void* a, const void* b, const int* sizes, void* out,
                 int M, int K, int N, int E, cudaStream_t st) {
  using C = GenCfg<BN>;
  CUtensorMap ta, tb;
  int err = hopper::encode_tensor_map(&ta, a, 1, M, MODE == GMM_T ? N : K,
                                      64, 64);
  if (err == 0)
    err = MODE == TGMM ? hopper::encode_tensor_map(&tb, b, 1, M, N, 64, 64)
                       : hopper::encode_tensor_map(&tb, b, E, K, N, 64, 64);
  if (err != 0) return err;
  const long items = general_items<MODE>(M, K, N, E, BN);
  if (items > (1L << 30)) return (int)cudaErrorInvalidValue;
  const int grid = (int)(items < sm_count() ? items : sm_count());
  const void* kern = reinterpret_cast<const void*>(
      &gmm_wgmma_kernel<MODE, BN>);
  cudaError_t e = set_smem_once<MODE * 1000 + BN>(kern, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  gmm_wgmma_kernel<MODE, BN><<<grid, GEN_THREADS, C::SMEM, st>>>(
      ta, tb, sizes, static_cast<bf16*>(out), M, K, N, E);
  return (int)cudaGetLastError();
}

template <int MODE>
int launch_general(const void* a, const void* b, const int* sizes,
                   void* out, int M, int K, int N, int E, cudaStream_t st) {
  return general_tile_n<MODE>(M, K, N, E) == 256
             ? launch_wgmma<MODE, 256>(a, b, sizes, out, M, K, N, E, st)
             : launch_wgmma<MODE, 128>(a, b, sizes, out, M, K, N, E, st);
}

template <int NR>
int launch_rows(const void* lhs, const void* rhs, const int* sizes,
                void* out, void* ws, int M, int K, int N, int E, int splits,
                cudaStream_t st) {
  using C = RowsCfg<NR>;
  CUtensorMap tw, tx;
  int err = hopper::encode_tensor_map(&tw, rhs, E, K, N, 64, 64);
  if (err == 0) err = hopper::encode_tensor_map(&tx, lhs, 1, M, K, NR, 64);
  if (err != 0) return err;
  const long items =
      (long)(E < M ? E : M) * ((N + RN - 1) / RN) * splits;
  const int grid = (int)(items < sm_count() ? items : sm_count());
  const void* kern = reinterpret_cast<const void*>(&gmm_rows_kernel<NR>);
  cudaError_t e = set_smem_once<10000 + NR>(kern, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  gmm_rows_kernel<NR><<<grid, ROWS_THREADS, C::SMEM, st>>>(
      tw, tx, sizes, static_cast<bf16*>(out), static_cast<float*>(ws), M, K,
      N, E, splits);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  const long n4 = (long)M * N / 4;
  const long blocks = (n4 + 255) / 256;
  gmm_splitk_reduce_kernel<<<(int)(blocks < 4L * sm_count() ? blocks
                                                         : 4L * sm_count()),
                         256, 0, st>>>(static_cast<const float*>(ws), sizes,
                                       static_cast<bf16*>(out), M, N, E,
                                       splits);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes). Each returns a cudaError_t code.
// All tensors contiguous on the current device; bf16 operands start on a
// 16-byte boundary (the TMA maps need it); group_sizes int32 [E]; is_bf16
// selects bf16 operands (else float32).

// lhs [M, K], rhs [E, K, N] -> out [M, N]. splits 0: the general path;
// splits >= 1 (bf16, M <= 64): the few-rows path with the contraction cut
// in `splits` parts, whose f32 partials go to ws [splits, M, N] when
// splits > 1 (else ws may be null).
extern "C" int gmm(const void* lhs, const void* rhs, const int* group_sizes,
                   void* out, void* ws, int M, int K, int N, int E,
                   int is_bf16, int splits, void* stream) {
  if (bad_shape(M, K, N, E, is_bf16) || splits < 0 ||
      (splits > 0 && (!is_bf16 || M > ROWS_MAX)) ||
      (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16 && splits > 0) {
    if (M <= 16)
      return launch_rows<16>(lhs, rhs, group_sizes, out, ws, M, K, N, E,
                             splits, st);
    if (M <= 32)
      return launch_rows<32>(lhs, rhs, group_sizes, out, ws, M, K, N, E,
                             splits, st);
    return launch_rows<64>(lhs, rhs, group_sizes, out, ws, M, K, N, E,
                           splits, st);
  }
  if (is_bf16)
    return launch_general<GMM>(lhs, rhs, group_sizes, out, M, K, N, E, st);
  dim3 grid((N + 31) / 32, (M + 7) / 8);
  gmm_f32_kernel<GMM><<<grid, 256, 0, st>>>(
      static_cast<const float*>(lhs), static_cast<const float*>(rhs),
      group_sizes, static_cast<float*>(out), M, K, N, E);
  return (int)cudaGetLastError();
}

// dy [M, N], rhs [E, K, N] -> out [M, K] (rhs read transposed)
extern "C" int gmm_t(const void* dy, const void* rhs, const int* group_sizes,
                     void* out, int M, int K, int N, int E, int is_bf16,
                     void* stream) {
  if (bad_shape(M, K, N, E, is_bf16)) return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_general<GMM_T>(dy, rhs, group_sizes, out, M, K, N, E, st);
  dim3 grid((K + 31) / 32, (M + 7) / 8);
  gmm_f32_kernel<GMM_T><<<grid, 256, 0, st>>>(
      static_cast<const float*>(dy), static_cast<const float*>(rhs),
      group_sizes, static_cast<float*>(out), M, K, N, E);
  return (int)cudaGetLastError();
}

// lhs [M, K], dy [M, N] -> out [E, K, N]
extern "C" int tgmm(const void* lhs, const void* dy, const int* group_sizes,
                    void* out, int M, int K, int N, int E, int is_bf16,
                    void* stream) {
  if (bad_shape(M, K, N, E, is_bf16)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (M == 0)  // every group empty: zero slabs (no rows to map)
      return (int)cudaMemsetAsync(out, 0, (size_t)E * K * N * sizeof(bf16),
                                  st);
    return launch_general<TGMM>(lhs, dy, group_sizes, out, M, K, N, E, st);
  }
  dim3 grid((N + 31) / 32, (K + 7) / 8, E);
  tgmm_f32_kernel<<<grid, 256, 0, st>>>(
      static_cast<const float*>(lhs), static_cast<const float*>(dy),
      group_sizes, static_cast<float*>(out), M, K, N, E);
  return (int)cudaGetLastError();
}

// Forces the general path's column tile to 128 or 256, or (0) lets the
// shape pick it; any other value leaves it. Returns the setting before
// the call. For measurements that compare the two tiles.
extern "C" int gmm_tile_n(int bn) {
  const int prev = g_tile_n;
  if (bn == 0 || bn == 128 || bn == 256) g_tile_n = bn;
  return prev;
}
