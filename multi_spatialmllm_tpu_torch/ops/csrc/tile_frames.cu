// A frame's InternVL tiles on the card: OpenCV's INTER_AREA resizes, the
// crops into tiles and the ImageNet normalisation, in one launch.
//
// Replaces no TPU kernel: the JAX package tiles frames on the host
// (multi_spatialmllm_tpu/models/preprocess.py, `cv2.resize`), as the
// port's plain version does in numpy (models/preprocess._tile_image over
// models/resize.py). It was added because that host work, 300-660 ms a
// 968 x 1296 frame, left the card idle in training and serving.
//
// Semantics (held bit for bit against the plain version):
//   src [h, w, 3] uint8 RGB; out [n_tiles, tile, tile, 3] float32. Tile
//   i < n_grid is the crop (i / cols, i % cols) of the frame resized to
//   (n_grid / cols * tile) x (cols * tile); tile n_grid, where n_tiles >
//   n_grid, is the frame resized to tile x tile (the thumbnail). Each
//   uint8 value v becomes (v / 255 - mean[c]) / std[c] in float32.
//   `resize_frame` writes one resize as uint8 [dh, dw, 3] (a fixed
//   `resize_hw` before the tiling).
//
// Each resize takes one of cv2's three paths, chosen on the host
// (models/resize.area_path) with its tables (models/resize.card_tables),
// and repeats the plain version's arithmetic in its order:
//   BLOCK (both axes shrink by whole factors iy, ix): the int sum of the
//     block, (sum + 2) >> 2 at 2 x 2, else sum * (1 / (iy * ix)) in float32
//     rounded half to even; 1 x 1 is the pixel itself;
//   AREA (both shrink, one by a fraction): float32 sums of products, along
//     x in table order from 0, then along y, each product and each sum
//     rounded on its own (__fmul_rn / __fadd_rn: no FMA contraction), then
//     rounded half to even and clipped;
//   GENERIC (an axis grows): cv2's 11-bit fixed point, in the same int32
//     arithmetic.
// The normalisation divides with __fdiv_rn and subtracts with __fsub_rn,
// as numpy's float32 operations round.
//
// What bounds it: a frame is read (3.76 MB at 968 x 1296) and ~17 MB of
// float32 tiles written, a few operations a byte: it is bound by bytes,
// about 6 us at 3.35 TB/s. So nothing intermediate goes to device memory:
// both resizes, the crops and the normalisation are one pass, each thread
// computing four consecutive pixels of the channel-last output from the
// source (which stays in L2) and storing their 12 floats as three 16-byte
// vectors, consecutive threads on consecutive addresses.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 0, kArea = 1, kGeneric = 2;
constexpr int kPixels = 4;          // output pixels a thread
constexpr int kThreads = 256;

struct Resize {
  int path, dh, dw, a, b;           // a, b: iy, ix (BLOCK); ky, kx (AREA)
  const int* ytab;                  // AREA: [dh, ky] index, [dh, ky] weight
  const int* xtab;                  // GENERIC: [d, 4] s0, s1, w0, w1
};

__device__ __forceinline__ int round_clip(float v) {
  return (int)fminf(fmaxf(rintf(v), 0.f), 255.f);
}

// One destination pixel's three channels of resize `r` of src [h, w, 3].
__device__ __forceinline__ void resize_pixel(const Resize& r,
                                             const uint8_t* __restrict__ src,
                                             int w, int dy, int dx,
                                             int out[3]) {
  if (r.path == kBlock) {
    const int iy = r.a, ix = r.b;
    int s0 = 0, s1 = 0, s2 = 0;
    for (int i = 0; i < iy; ++i) {
      const uint8_t* p = src + ((size_t)(dy * iy + i) * w + dx * ix) * 3;
      for (int j = 0; j < ix; ++j, p += 3) {
        s0 += p[0];
        s1 += p[1];
        s2 += p[2];
      }
    }
    if (iy == 2 && ix == 2) {
      out[0] = (s0 + 2) >> 2;
      out[1] = (s1 + 2) >> 2;
      out[2] = (s2 + 2) >> 2;
    } else {
      const float inv = __fdiv_rn(1.f, (float)(iy * ix));
      out[0] = round_clip(__fmul_rn((float)s0, inv));
      out[1] = round_clip(__fmul_rn((float)s1, inv));
      out[2] = round_clip(__fmul_rn((float)s2, inv));
    }
  } else if (r.path == kArea) {
    const int ky = r.a, kx = r.b;
    const int* yi = r.ytab + dy * ky;
    const float* yw =
        reinterpret_cast<const float*>(r.ytab + r.dh * ky) + dy * ky;
    const int* xi = r.xtab + dx * kx;
    const float* xw =
        reinterpret_cast<const float*>(r.xtab + r.dw * kx) + dx * kx;
    float o0 = 0.f, o1 = 0.f, o2 = 0.f;
    for (int jy = 0; jy < ky; ++jy) {
      const uint8_t* row = src + (size_t)yi[jy] * w * 3;
      float b0 = 0.f, b1 = 0.f, b2 = 0.f;
      for (int jx = 0; jx < kx; ++jx) {
        const uint8_t* p = row + xi[jx] * 3;
        const float wx = xw[jx];
        b0 = __fadd_rn(b0, __fmul_rn((float)p[0], wx));
        b1 = __fadd_rn(b1, __fmul_rn((float)p[1], wx));
        b2 = __fadd_rn(b2, __fmul_rn((float)p[2], wx));
      }
      const float wy = yw[jy];
      o0 = __fadd_rn(o0, __fmul_rn(b0, wy));
      o1 = __fadd_rn(o1, __fmul_rn(b1, wy));
      o2 = __fadd_rn(o2, __fmul_rn(b2, wy));
    }
    out[0] = round_clip(o0);
    out[1] = round_clip(o1);
    out[2] = round_clip(o2);
  } else {
    const int* y = r.ytab + dy * 4;
    const int* x = r.xtab + dx * 4;
    const uint8_t* r0 = src + (size_t)y[0] * w * 3;
    const uint8_t* r1 = src + (size_t)y[1] * w * 3;
    for (int c = 0; c < 3; ++c) {
      const int h0 = (r0[x[0] * 3 + c] * x[2] + r0[x[1] * 3 + c] * x[3]) >> 4;
      const int h1 = (r1[x[0] * 3 + c] * x[2] + r1[x[1] * 3 + c] * x[3]) >> 4;
      const int v = (((h0 * y[2]) >> 16) + ((h1 * y[3]) >> 16) + 2) >> 2;
      out[c] = min(max(v, 0), 255);
    }
  }
}

struct Tiles {
  const uint8_t* src;
  float* out;
  int w, tile, cols, n_grid;
  long long pixels;                 // n_tiles * tile * tile
  Resize grid, thumb;
  float mean[3], std[3];
};

__global__ void __launch_bounds__(kThreads)
tile_frames_kernel(const Tiles t) {
  const long long first =
      ((long long)blockIdx.x * kThreads + threadIdx.x) * kPixels;
  if (first >= t.pixels) return;
  const int per_tile = t.tile * t.tile;
  float v[kPixels * 3];
  for (int i = 0; i < kPixels; ++i) {
    const long long p = first + i;
    if (p >= t.pixels) break;
    const int n = (int)(p / per_tile);
    const int rem = (int)(p - (long long)n * per_tile);
    const int y = rem / t.tile, x = rem - y * t.tile;
    int px[3];
    if (n < t.n_grid) {
      resize_pixel(t.grid, t.src, t.w, n / t.cols * t.tile + y,
                   n % t.cols * t.tile + x, px);
    } else {
      resize_pixel(t.thumb, t.src, t.w, y, x, px);
    }
    for (int c = 0; c < 3; ++c) {
      v[i * 3 + c] = __fdiv_rn(
          __fsub_rn(__fdiv_rn((float)px[c], 255.f), t.mean[c]), t.std[c]);
    }
  }
  float* dst = t.out + first * 3;
  if (first + kPixels <= t.pixels) {
    float4* d4 = reinterpret_cast<float4*>(dst);
    d4[0] = make_float4(v[0], v[1], v[2], v[3]);
    d4[1] = make_float4(v[4], v[5], v[6], v[7]);
    d4[2] = make_float4(v[8], v[9], v[10], v[11]);
  } else {
    for (int i = 0; i < (int)(t.pixels - first) * 3; ++i) dst[i] = v[i];
  }
}

__global__ void __launch_bounds__(kThreads)
resize_frame_kernel(const uint8_t* __restrict__ src, int w,
                    uint8_t* __restrict__ dst, const Resize r) {
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p >= (long long)r.dh * r.dw) return;
  const int dy = (int)(p / r.dw), dx = (int)(p - (long long)dy * r.dw);
  int px[3];
  resize_pixel(r, src, w, dy, dx, px);
  dst[p * 3] = (uint8_t)px[0];
  dst[p * 3 + 1] = (uint8_t)px[1];
  dst[p * 3 + 2] = (uint8_t)px[2];
}

// A resize from its host header [path, dh, dw, a, b] and its device table
// (the y table, then the x table); false where the header is not one the
// kernel takes for a source of h x w.
bool make_resize(const int* hdr, const int* tab, int h, int w, Resize* r) {
  if (hdr == nullptr) return false;
  *r = Resize{hdr[0], hdr[1], hdr[2], hdr[3], hdr[4], tab, nullptr};
  if (r->dh <= 0 || r->dw <= 0) return false;
  if (r->path == kBlock) {
    return r->a > 0 && r->b > 0 && r->dh * r->a <= h && r->dw * r->b <= w;
  }
  if (tab == nullptr) return false;
  if (r->path == kArea) {
    if (r->a <= 0 || r->b <= 0) return false;
    r->xtab = tab + 2 * r->dh * r->a;
    return true;
  }
  if (r->path == kGeneric) {
    r->xtab = tab + 4 * r->dh;
    return true;
  }
  return false;
}

}  // namespace

// src [h, w, 3] uint8 -> out [n_tiles, tile, tile, 3] float32: the grid's
// n_grid tiles (cols a row) from resize `grid_hdr`/`grid_tab`, then, where
// n_tiles > n_grid, the thumbnail from `thumb_hdr`/`thumb_tab`. Headers
// and mean_std (mean[3], std[3]) are host memory; the rest device memory.
extern "C" int tile_frame(const void* src, int h, int w, void* out, int tile,
                          int cols, int n_grid, int n_tiles,
                          const int* grid_hdr, const int* grid_tab,
                          const int* thumb_hdr, const int* thumb_tab,
                          const float* mean_std, void* stream) {
  Tiles t{};
  t.src = static_cast<const uint8_t*>(src);
  t.out = static_cast<float*>(out);
  t.w = w;
  t.tile = tile;
  t.cols = cols;
  t.n_grid = n_grid;
  t.pixels = (long long)n_tiles * tile * tile;
  if (h <= 0 || w <= 0 || tile <= 0 || cols <= 0 || n_grid <= 0 ||
      n_grid % cols != 0 || n_tiles < n_grid || n_tiles > n_grid + 1 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      !make_resize(grid_hdr, grid_tab, h, w, &t.grid) ||
      t.grid.dh != n_grid / cols * tile || t.grid.dw != cols * tile) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_tiles > n_grid &&
      (!make_resize(thumb_hdr, thumb_tab, h, w, &t.thumb) ||
       t.thumb.dh != tile || t.thumb.dw != tile)) {
    return (int)cudaErrorInvalidValue;
  }
  for (int c = 0; c < 3; ++c) {
    t.mean[c] = mean_std[c];
    t.std[c] = mean_std[3 + c];
  }
  const long long threads = (t.pixels + kPixels - 1) / kPixels;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  tile_frames_kernel<<<(unsigned)blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(t);
  return (int)cudaGetLastError();
}

// src [h, w, 3] uint8 -> dst [dh, dw, 3] uint8 by resize `hdr`/`tab`.
extern "C" int resize_frame(const void* src, int h, int w, void* dst,
                            const int* hdr, const int* tab, void* stream) {
  Resize r;
  if (h <= 0 || w <= 0 || !make_resize(hdr, tab, h, w, &r)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long blocks =
      ((long long)r.dh * r.dw + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  resize_frame_kernel<<<(unsigned)blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), w, static_cast<uint8_t*>(dst), r);
  return (int)cudaGetLastError();
}
