// Baseline JPEG encoder with a row-splice fast path for the annotated
// ("dot") QA engines.
//
// The reference's dot engines re-encode a FULL 480x640 JPEG per sample
// (depth_estimation_dot_engine.py:162-173 draws one circle, then
// cv2.imwrite) — encode dominates their 62/s rate. This encoder exploits
// baseline JPEG structure instead: every image is encoded with a DRI
// (restart interval) of one MCU row, which makes each 16-pixel row band
// an independent, BYTE-ALIGNED bitstream segment (DC predictors reset at
// restarts; RST markers are byte-padded by spec). A source frame is
// encoded once and its per-row segments cached; each annotated sample
// then re-encodes ONLY the MCU rows its circle/letter touches and
// memcpy-splices the untouched rows — ~10-30x less encode work per
// sample. Output is standard baseline JFIF (4:2:0, Annex K Huffman
// tables, IJG quality scaling) decodable by any reader; bytes differ
// from cv2/libjpeg-turbo (different encoder), pixel parity is
// test-asserted after decode (tests/test_jpeg_native.py).
//
// Plain C, no dependencies; exported via ctypes (ingest/native/__init__).

#include <algorithm>
#include <array>
#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <cmath>
#include <utility>
#include <vector>
#include <mutex>
#include <unordered_map>

namespace {

// ---------------------------------------------------------------------------
// Tables (JPEG Annex K)
// ---------------------------------------------------------------------------

static const uint8_t kZigzag[64] = {
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

static const uint8_t kLumaQ[64] = {
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};

static const uint8_t kChromaQ[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// Standard Huffman specs: (bits[1..16], values)
static const uint8_t kDcLumaBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0,
                                        0, 0, 0, 0, 0, 0};
static const uint8_t kDcLumaVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
static const uint8_t kDcChromaBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1,
                                          1, 0, 0, 0, 0, 0};
static const uint8_t kDcChromaVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10,
                                          11};
static const uint8_t kAcLumaBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4,
                                        4, 0, 0, 1, 0x7d};
static const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
static const uint8_t kAcChromaBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5,
                                          4, 4, 0, 1, 2, 0x77};
static const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct HuffTable {
  uint16_t code[256];
  uint8_t len[256];
};

void build_huff(const uint8_t bits[17], const uint8_t *vals, HuffTable *t) {
  std::memset(t->len, 0, sizeof(t->len));
  uint16_t code = 0;
  int k = 0;
  for (int l = 1; l <= 16; ++l) {
    for (int i = 0; i < bits[l]; ++i) {
      t->code[vals[k]] = code;
      t->len[vals[k]] = (uint8_t)l;
      ++code;
      ++k;
    }
    code <<= 1;
  }
}

struct Tables {
  HuffTable dc_luma, ac_luma, dc_chroma, ac_chroma;
  Tables() {
    build_huff(kDcLumaBits, kDcLumaVals, &dc_luma);
    build_huff(kAcLumaBits, kAcLumaVals, &ac_luma);
    build_huff(kDcChromaBits, kDcChromaVals, &dc_chroma);
    build_huff(kAcChromaBits, kAcChromaVals, &ac_chroma);
  }
};
static const Tables g_tables;

void scale_quant(const uint8_t *base, int quality, uint8_t *out) {
  if (quality < 1) quality = 1;
  if (quality > 100) quality = 100;
  int scale = quality < 50 ? 5000 / quality : 200 - 2 * quality;
  for (int i = 0; i < 64; ++i) {
    int v = (base[i] * scale + 50) / 100;
    if (v < 1) v = 1;
    if (v > 255) v = 255;
    out[i] = (uint8_t)v;
  }
}

// ---------------------------------------------------------------------------
// Bit writer (with 0xFF byte stuffing)
// ---------------------------------------------------------------------------

// Raw (UNSTUFFED) MSB-first bitstream. Keeping the entropy bits unstuffed
// is what makes bit-granular splicing practical: cached bit offsets stay
// valid, ranges copy with word shifts, and the 0xFF00 byte stuffing is a
// single final pass.
struct RawBits {
  std::vector<uint8_t> bytes;
  uint64_t acc = 0;
  int nacc = 0;  // bits buffered in acc (not yet in `bytes`)

  uint64_t nbits() const { return bytes.size() * 8ull + nacc; }

  inline void put(uint32_t bits, int n) {
    acc = (acc << n) | (uint64_t)(bits & (n == 32 ? 0xFFFFFFFFu
                                                  : ((1u << n) - 1)));
    nacc += n;
    if (nacc >= 32) {  // bulk: 4 bytes in one append (hot in bit-copies)
      uint32_t w = (uint32_t)(acc >> (nacc - 32));
      uint8_t be[4] = {(uint8_t)(w >> 24), (uint8_t)(w >> 16),
                       (uint8_t)(w >> 8), (uint8_t)w};
      bytes.insert(bytes.end(), be, be + 4);
      nacc -= 32;
    }
    while (nacc >= 8) {
      bytes.push_back((uint8_t)(acc >> (nacc - 8)));
      nacc -= 8;
    }
  }

  inline void pad_to_byte() {  // 1-fill (JPEG flush convention)
    if (nacc) put(0xFF, 8 - nacc);
  }

  // read up to 32 bits at absolute bit position `pos` (caller guarantees
  // pos + n <= nbits and the stream is byte-flushed)
  inline uint32_t read(uint64_t pos, int n) const {
    uint64_t byte = pos >> 3;
    int off = (int)(pos & 7);
    uint64_t v = 0;
    size_t need = (size_t)((off + n + 7) / 8);
    for (size_t i = 0; i < need; ++i)
      v = (v << 8) | bytes[byte + i];
    int total = (int)need * 8;
    return (uint32_t)((v >> (total - off - n)) & (n == 32
        ? 0xFFFFFFFFull : ((1ull << n) - 1)));
  }

  // append source bits [lo, hi) — word-wise; the splice bit-copies run
  // through here, so the 32-bit reads take a direct 5-byte load instead
  // of read()'s per-byte shift loop whenever in bounds
  inline void append_range(const RawBits &src, uint64_t lo, uint64_t hi) {
    const uint8_t *sb = src.bytes.data();
    const size_t sbn = src.bytes.size();
    while (lo + 32 <= hi) {
      uint64_t b = lo >> 3;
      int off = (int)(lo & 7);
      if (b + 5 <= sbn) {
        uint64_t w = ((uint64_t)sb[b] << 32) | ((uint64_t)sb[b + 1] << 24) |
                     ((uint64_t)sb[b + 2] << 16) |
                     ((uint64_t)sb[b + 3] << 8) | (uint64_t)sb[b + 4];
        put((uint32_t)(w >> (8 - off)), 32);
      } else {
        put(src.read(lo, 32), 32);
      }
      lo += 32;
    }
    if (lo < hi) put(src.read(lo, (int)(hi - lo)), (int)(hi - lo));
  }

  // byte-stuffed copy (0xFF -> 0xFF 0x00) appended to `out`; stream must
  // be byte-flushed. Bulk-copies the runs between 0xFF bytes (memchr)
  // instead of branching per byte.
  void stuff_into(std::vector<uint8_t> *out) const {
    out->reserve(out->size() + bytes.size() + 16);
    const uint8_t *p = bytes.data();
    const uint8_t *end = p + bytes.size();
    while (p < end) {
      const uint8_t *ff =
          (const uint8_t *)std::memchr(p, 0xFF, (size_t)(end - p));
      if (!ff) {
        out->insert(out->end(), p, end);
        break;
      }
      out->insert(out->end(), p, ff + 1);
      out->push_back(0x00);
      p = ff + 1;
    }
  }
};

inline int bit_size(int v) {
  unsigned a = v < 0 ? -v : v;
  return a ? 32 - __builtin_clz(a) : 0;
}

// ---------------------------------------------------------------------------
// Forward DCT (AAN, float, 8-lane vectorized) + quantization
// ---------------------------------------------------------------------------

typedef float v8f __attribute__((vector_size(32)));

// One AAN pass on 8 parallel lanes: d[i] holds position i of EIGHT
// independent 8-point DCTs (butterflies go across the array index, so
// every op is an elementwise vector op — the classic SIMD-JPEG layout).
static inline void fdct8v(v8f *d) {
  v8f tmp0 = d[0] + d[7], tmp7 = d[0] - d[7];
  v8f tmp1 = d[1] + d[6], tmp6 = d[1] - d[6];
  v8f tmp2 = d[2] + d[5], tmp5 = d[2] - d[5];
  v8f tmp3 = d[3] + d[4], tmp4 = d[3] - d[4];
  v8f tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  v8f tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  d[0] = tmp10 + tmp11;
  d[4] = tmp10 - tmp11;
  v8f z1 = (tmp12 + tmp13) * 0.707106781f;
  d[2] = tmp13 + z1;
  d[6] = tmp13 - z1;
  tmp10 = tmp4 + tmp5;
  tmp11 = tmp5 + tmp6;
  tmp12 = tmp6 + tmp7;
  v8f z5 = (tmp10 - tmp12) * 0.382683433f;
  v8f z2 = tmp10 * 0.541196100f + z5;
  v8f z4 = tmp12 * 1.306562965f + z5;
  v8f z3 = tmp11 * 0.707106781f;
  v8f z11 = tmp7 + z3, z13 = tmp7 - z3;
  d[5] = z13 + z2;
  d[3] = z13 - z2;
  d[1] = z11 + z4;
  d[7] = z11 - z4;
}

static inline void transpose8(v8f *d) {
  float t[64];
  std::memcpy(t, d, sizeof(t));
  float *o = (float *)d;
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 8; ++j) o[i * 8 + j] = t[j * 8 + i];
}

// AAN output scale factors: S[u] = 1 / (cu * cos(u*pi/16) * ... ) folded
// reciprocals per coefficient; standard libjpeg "aanscalefactor".
struct AanScale {
  float s[64];
  AanScale() {
    static const double a[8] = {1.0, 1.387039845, 1.306562965, 1.175875602,
                                1.0, 0.785694958, 0.541196100, 0.275899379};
    for (int v = 0; v < 8; ++v)
      for (int u = 0; u < 8; ++u) s[v * 8 + u] = (float)(1.0 / (a[u] * a[v] * 8.0));
  }
};
static const AanScale g_aan;

// blk: 64 floats row-major (level-shifted); qmul: coef * aan_scale / q
// reciprocals, row-major natural order -> out: 64 ints natural order.
void fdct_quant(float *blk, const float *qmul, int32_t *out) {
  v8f d[8];
  std::memcpy(d, blk, sizeof(d));
  fdct8v(d);      // column (y) pass: lanes are x positions
  transpose8(d);  // lanes become y positions
  fdct8v(d);      // row (x) pass
  transpose8(d);  // back to row-major [v][u]
  const float *f = (const float *)d;
  for (int i = 0; i < 64; ++i) {
    // fast round-half-away (lrintf is a libm call and dominated the
    // profile); any consistent rounding is fine — this encoder only
    // needs to agree with itself (splice invariant)
    float x = f[i] * qmul[i];
    out[i] = (int32_t)(x + (x >= 0.0f ? 0.5f : -0.5f));
  }
}

inline void emit_dc(RawBits &bw, int diff, const HuffTable &dc) {
  int n = bit_size(diff);
  bw.put(dc.code[n], dc.len[n]);
  if (n) bw.put(diff < 0 ? diff - 1 : diff, n);
}

void encode_block(RawBits &bw, const int32_t *coef, int *dc_pred,
                  const HuffTable &dc, const HuffTable &ac) {
  emit_dc(bw, coef[0] - *dc_pred, dc);
  *dc_pred = coef[0];
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    int v = coef[kZigzag[k]];
    if (v == 0) {
      ++run;
      continue;
    }
    while (run > 15) {
      bw.put(ac.code[0xF0], ac.len[0xF0]);
      run -= 16;
    }
    int s = bit_size(v);
    int sym = (run << 4) | s;
    bw.put(ac.code[sym], ac.len[sym]);
    bw.put(v < 0 ? v - 1 : v, s);
    run = 0;
  }
  if (run) bw.put(ac.code[0x00], ac.len[0x00]);
}

// Per-MCU metadata recorded during a full-row encode: enough to restart
// the DC predictor chains at any MCU boundary (column splicing) and to
// recode the three chain-entry DC diffs of the MCU right after a
// re-encoded region.
struct McuMeta {
  uint32_t start_bit;
  uint32_t y00_dc_end, cb_start, cb_dc_end, cr_start, cr_dc_end;
  int32_t dc_y_in, dc_cb_in, dc_cr_in;  // predictors BEFORE this MCU
  int32_t dc_y00, dc_cb_v, dc_cr_v;     // DC values of Y00 / Cb / Cr
};

// ---------------------------------------------------------------------------
// Encoder state
// ---------------------------------------------------------------------------

struct Encoder {
  int h, w, quality;
  int mcu_w, mcu_h;  // MCUs per row / rows of MCUs
  uint8_t qy[64], qc[64];
  float qmul_y[64], qmul_c[64];
  std::vector<uint8_t> header;  // SOI..SOS (incl.)

  Encoder(int h_, int w_, int q_) : h(h_), w(w_), quality(q_) {
    mcu_w = (w + 15) / 16;
    mcu_h = (h + 15) / 16;
    scale_quant(kLumaQ, quality, qy);
    scale_quant(kChromaQ, quality, qc);
    for (int i = 0; i < 64; ++i) {
      qmul_y[i] = g_aan.s[i] / (float)qy[i];
      qmul_c[i] = g_aan.s[i] / (float)qc[i];
    }
    build_header();
  }

  void put16(std::vector<uint8_t> &v, int x) {
    v.push_back((uint8_t)(x >> 8));
    v.push_back((uint8_t)(x & 0xFF));
  }

  void build_header() {
    std::vector<uint8_t> &o = header;
    o.insert(o.end(), {0xFF, 0xD8});                      // SOI
    o.insert(o.end(), {0xFF, 0xE0});                      // APP0 JFIF
    put16(o, 16);
    o.insert(o.end(), {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0});
    for (int t = 0; t < 2; ++t) {                          // DQT x2
      o.insert(o.end(), {0xFF, 0xDB});
      put16(o, 67);
      o.push_back((uint8_t)t);
      const uint8_t *q = t == 0 ? qy : qc;
      for (int i = 0; i < 64; ++i) o.push_back(q[kZigzag[i]]);
    }
    o.insert(o.end(), {0xFF, 0xC0});                      // SOF0
    put16(o, 17);
    o.push_back(8);
    put16(o, h);
    put16(o, w);
    o.push_back(3);
    o.insert(o.end(), {1, 0x22, 0});  // Y 2x2, qtable 0
    o.insert(o.end(), {2, 0x11, 1});  // Cb
    o.insert(o.end(), {3, 0x11, 1});  // Cr
    struct Spec {
      uint8_t cls_id;
      const uint8_t *bits;
      const uint8_t *vals;
      int nvals;
    } specs[4] = {{0x00, kDcLumaBits, kDcLumaVals, 12},
                  {0x10, kAcLumaBits, kAcLumaVals, 162},
                  {0x01, kDcChromaBits, kDcChromaVals, 12},
                  {0x11, kAcChromaBits, kAcChromaVals, 162}};
    for (auto &s : specs) {                                // DHT x4
      o.insert(o.end(), {0xFF, 0xC4});
      put16(o, 2 + 1 + 16 + s.nvals);
      o.push_back(s.cls_id);
      for (int l = 1; l <= 16; ++l) o.push_back(s.bits[l]);
      for (int i = 0; i < s.nvals; ++i) o.push_back(s.vals[i]);
    }
    o.insert(o.end(), {0xFF, 0xDD});                      // DRI
    put16(o, 4);
    put16(o, mcu_w);  // restart every MCU row
    o.insert(o.end(), {0xFF, 0xDA});                      // SOS
    put16(o, 12);
    o.push_back(3);
    o.insert(o.end(), {1, 0x00, 2, 0x11, 3, 0x11});
    o.insert(o.end(), {0, 63, 0});
  }

  // Encode MCUs [m0, m1) of MCU row `mr` from BGR image `img` into `bw`,
  // starting from DC predictors `dc[3]` ({y, cb, cr}; updated in place).
  // The pixel band [m0*16, m1*16) is converted to planar YCbCr in one
  // tight pass first (a per-MCU gather with per-pixel clamps was ~2x
  // slower). `meta`, when non-null, receives one McuMeta per MCU
  // (bit offsets RELATIVE to bw's state at entry must be zero — callers
  // pass a fresh RawBits when recording).
  void encode_mcus(const uint8_t *img, int mr, int m0, int m1,
                   int32_t dc[3], RawBits &bw,
                   std::vector<McuMeta> *meta) {
    int y0 = mr * 16;
    int x0b = m0 * 16;
    int wb = (m1 - m0) * 16;  // band width, whole MCUs
    int hw = wb / 2;
    std::vector<float> yplane((size_t)16 * wb);
    std::vector<float> cbp((size_t)8 * hw), crp((size_t)8 * hw);
    std::vector<float> rf(wb), gf(wb), bf(wb);
    std::vector<float> rsum(hw), gsum(hw), bsum(hw);
    for (int yy = 0; yy < 16; ++yy) {
      int sy = y0 + yy < h ? y0 + yy : h - 1;
      const uint8_t *row = img + (size_t)sy * w * 3;
      float *yrow = yplane.data() + (size_t)yy * wb;
      // deinterleave BGR -> planar floats (plain byte moves; the float
      // math below then auto-vectorizes)
      for (int xx = 0; xx < wb; ++xx) {
        int sx = x0b + xx < w ? x0b + xx : w - 1;  // edge-replicate
        bf[xx] = row[3 * sx];
        gf[xx] = row[3 * sx + 1];
        rf[xx] = row[3 * sx + 2];
      }
      for (int xx = 0; xx < wb; ++xx)
        yrow[xx] = 0.299f * rf[xx] + 0.587f * gf[xx] + 0.114f * bf[xx]
                   - 128.0f;
      if ((yy & 1) == 0) {
        for (int hx = 0; hx < hw; ++hx) {
          rsum[hx] = rf[2 * hx] + rf[2 * hx + 1];
          gsum[hx] = gf[2 * hx] + gf[2 * hx + 1];
          bsum[hx] = bf[2 * hx] + bf[2 * hx + 1];
        }
      } else {
        float *cbr = cbp.data() + (size_t)(yy >> 1) * hw;
        float *crr = crp.data() + (size_t)(yy >> 1) * hw;
        for (int hx = 0; hx < hw; ++hx) {
          float rb = (rsum[hx] + rf[2 * hx] + rf[2 * hx + 1]) * 0.25f;
          float gb = (gsum[hx] + gf[2 * hx] + gf[2 * hx + 1]) * 0.25f;
          float bb = (bsum[hx] + bf[2 * hx] + bf[2 * hx + 1]) * 0.25f;
          cbr[hx] = -0.168735892f * rb - 0.331264108f * gb + 0.5f * bb;
          crr[hx] = 0.5f * rb - 0.418687589f * gb - 0.081312411f * bb;
        }
      }
    }
    float blk[64];
    int32_t coef[64];
    for (int m = 0; m < m1 - m0; ++m) {
      int x0 = m * 16;
      McuMeta mm;
      mm.start_bit = (uint32_t)bw.nbits();
      mm.dc_y_in = dc[0];
      mm.dc_cb_in = dc[1];
      mm.dc_cr_in = dc[2];
      // 4 Y blocks
      for (int by = 0; by < 2; ++by)
        for (int bx = 0; bx < 2; ++bx) {
          const float *src = yplane.data() + (size_t)(by * 8) * wb +
                             x0 + bx * 8;
          for (int r = 0; r < 8; ++r)
            std::memcpy(blk + r * 8, src + (size_t)r * wb,
                        8 * sizeof(float));
          fdct_quant(blk, qmul_y, coef);
          if (by == 0 && bx == 0) {
            mm.dc_y00 = coef[0];
            emit_dc(bw, coef[0] - dc[0], g_tables.dc_luma);
            mm.y00_dc_end = (uint32_t)bw.nbits();
            dc[0] = coef[0];
            emit_ac(bw, coef, g_tables.ac_luma);
          } else {
            int pi = (int)dc[0];
            encode_block(bw, coef, &pi, g_tables.dc_luma,
                         g_tables.ac_luma);
            dc[0] = pi;
          }
        }
      mm.cb_start = (uint32_t)bw.nbits();
      for (int r = 0; r < 8; ++r)
        std::memcpy(blk + r * 8, cbp.data() + (size_t)r * hw + x0 / 2,
                    8 * sizeof(float));
      fdct_quant(blk, qmul_c, coef);
      mm.dc_cb_v = coef[0];
      emit_dc(bw, coef[0] - dc[1], g_tables.dc_chroma);
      mm.cb_dc_end = (uint32_t)bw.nbits();
      dc[1] = coef[0];
      emit_ac(bw, coef, g_tables.ac_chroma);
      mm.cr_start = (uint32_t)bw.nbits();
      for (int r = 0; r < 8; ++r)
        std::memcpy(blk + r * 8, crp.data() + (size_t)r * hw + x0 / 2,
                    8 * sizeof(float));
      fdct_quant(blk, qmul_c, coef);
      mm.dc_cr_v = coef[0];
      emit_dc(bw, coef[0] - dc[2], g_tables.dc_chroma);
      mm.cr_dc_end = (uint32_t)bw.nbits();
      dc[2] = coef[0];
      emit_ac(bw, coef, g_tables.ac_chroma);
      if (meta) meta->push_back(mm);
    }
  }

  static void emit_ac(RawBits &bw, const int32_t *coef,
                      const HuffTable &ac) {
    int run = 0;
    for (int kk = 1; kk < 64; ++kk) {
      int vv = coef[kZigzag[kk]];
      if (vv == 0) { ++run; continue; }
      while (run > 15) {
        bw.put(ac.code[0xF0], ac.len[0xF0]);
        run -= 16;
      }
      int s = bit_size(vv);
      int sym = (run << 4) | s;
      bw.put(ac.code[sym], ac.len[sym]);
      bw.put(vv < 0 ? vv - 1 : vv, s);
      run = 0;
    }
    if (run) bw.put(ac.code[0x00], ac.len[0x00]);
  }

  // Whole-row encode (entropy bytes, flushed; no RST marker), with raw
  // bits + per-MCU metadata captured for column splicing.
  // `raw_nbits`: the UNPADDED bit count (the raw buffer is byte-padded
  // with 1s afterwards; column splices must not copy the pad).
  void encode_row_full(const uint8_t *img, int mr,
                       std::vector<uint8_t> *stuffed, RawBits *raw_out,
                       std::vector<McuMeta> *meta, uint64_t *raw_nbits) {
    RawBits bw;
    int32_t dc[3] = {0, 0, 0};  // reset at restart by spec
    encode_mcus(img, mr, 0, mcu_w, dc, bw, meta);
    if (raw_nbits) *raw_nbits = bw.nbits();
    bw.pad_to_byte();
    bw.stuff_into(stuffed);
    if (raw_out) *raw_out = std::move(bw);
  }

  // Back-compat wrapper (full encode path).
  void encode_row(const uint8_t *img, int mr, std::vector<uint8_t> *out) {
    encode_row_full(img, mr, out, nullptr, nullptr, nullptr);
  }
};

struct RowCache {
  std::vector<uint8_t> stuffed;  // entropy bytes, byte-stuffed + padded
  RawBits raw;                   // unstuffed bits (padded at the end)
  uint64_t raw_nbits = 0;        // unpadded bit count
  std::vector<McuMeta> mcus;
};

struct Cached {
  Encoder *enc;
  std::vector<RowCache> rows;
};

// Column splice of ONE row: re-encode each dirty MCU interval
// [m0, m1) of `ivs` (sorted, disjoint, separated by >= 1 clean MCU)
// from `img`, recode the bridge MCU after each interval (its three
// chain-entry DC diffs change because its predecessors were
// re-encoded; every later diff is unchanged — the bridge re-syncs the
// absolute DC chain), and bit-copy everything else from the cached raw
// stream.
void splice_row_cols_multi(Encoder &enc, const RowCache &rc,
                           const uint8_t *img, int mr,
                           const std::pair<int, int> *ivs, int nivs,
                           std::vector<uint8_t> *stuffed_out) {
  RawBits out;
  out.bytes.reserve(rc.raw.bytes.size() + 256);
  uint64_t copied = 0;  // cached-bit position copied so far
  int32_t dc[3];
  for (int i = 0; i < nivs; ++i) {
    int m0 = ivs[i].first, m1 = ivs[i].second;
    const McuMeta &first = rc.mcus[(size_t)m0];
    out.append_range(rc.raw, copied, first.start_bit);
    dc[0] = first.dc_y_in;
    dc[1] = first.dc_cb_in;
    dc[2] = first.dc_cr_in;
    enc.encode_mcus(img, mr, m0, m1, dc, out, nullptr);
    if (m1 < enc.mcu_w) {
      const McuMeta &b = rc.mcus[(size_t)m1];
      emit_dc(out, b.dc_y00 - dc[0], g_tables.dc_luma);
      out.append_range(rc.raw, b.y00_dc_end, b.cb_start);
      emit_dc(out, b.dc_cb_v - dc[1], g_tables.dc_chroma);
      out.append_range(rc.raw, b.cb_dc_end, b.cr_start);
      emit_dc(out, b.dc_cr_v - dc[2], g_tables.dc_chroma);
      copied = b.cr_dc_end;
    } else {
      copied = rc.raw_nbits;
    }
  }
  out.append_range(rc.raw, copied, rc.raw_nbits);
  out.pad_to_byte();
  out.stuff_into(stuffed_out);
}

void splice_row_cols(Encoder &enc, const RowCache &rc, const uint8_t *img,
                     int mr, int m0, int m1,
                     std::vector<uint8_t> *stuffed_out) {
  std::pair<int, int> iv(m0, m1);
  splice_row_cols_multi(enc, rc, img, mr, &iv, 1, stuffed_out);
}

std::mutex g_mutex;
std::unordered_map<int64_t, Cached> g_cache;
int64_t g_next_handle = 1;

void assemble(const Encoder &enc,
              const std::vector<std::vector<uint8_t>> &rows,
              std::vector<uint8_t> *out) {
  size_t total = enc.header.size() + 2;
  for (auto &r : rows) total += r.size() + 2;
  out->clear();
  out->reserve(total);
  out->insert(out->end(), enc.header.begin(), enc.header.end());
  for (int mr = 0; mr < enc.mcu_h; ++mr) {
    out->insert(out->end(), rows[mr].begin(), rows[mr].end());
    if (mr != enc.mcu_h - 1) {
      out->push_back(0xFF);
      out->push_back((uint8_t)(0xD0 + (mr & 7)));  // RSTn
    }
  }
  out->push_back(0xFF);
  out->push_back(0xD9);  // EOI
}

}  // namespace

extern "C" {

// Full encode, no caching. Returns number of bytes written, or -needed if
// `cap` was too small, or 0 on bad args.
long msm_jpeg_encode(const uint8_t *bgr, int h, int w, int quality,
                     uint8_t *out, long cap) {
  if (!bgr || h <= 0 || w <= 0) return 0;
  Encoder enc(h, w, quality);
  std::vector<std::vector<uint8_t>> rows((size_t)enc.mcu_h);
  for (int mr = 0; mr < enc.mcu_h; ++mr) enc.encode_row(bgr, mr, &rows[mr]);
  std::vector<uint8_t> buf;
  assemble(enc, rows, &buf);
  if ((long)buf.size() > cap) return -(long)buf.size();
  std::memcpy(out, buf.data(), buf.size());
  return (long)buf.size();
}

// Encode + cache the per-row segments of a SOURCE frame (stuffed bytes
// for row splicing, raw bits + per-MCU metadata for column splicing);
// returns a handle (>0) for msm_jpeg_encode_spliced*, or 0 on error.
int64_t msm_jpeg_prepare(const uint8_t *bgr, int h, int w, int quality) {
  if (!bgr || h <= 0 || w <= 0) return 0;
  auto *enc = new Encoder(h, w, quality);
  Cached c;
  c.enc = enc;
  c.rows.resize((size_t)enc->mcu_h);
  for (int mr = 0; mr < enc->mcu_h; ++mr)
    enc->encode_row_full(bgr, mr, &c.rows[mr].stuffed, &c.rows[mr].raw,
                         &c.rows[mr].mcus, &c.rows[mr].raw_nbits);
  std::lock_guard<std::mutex> lock(g_mutex);
  int64_t hdl = g_next_handle++;
  g_cache.emplace(hdl, std::move(c));
  return hdl;
}

namespace {

// Assemble the output from per-row segments: `dirty[mr]` non-empty means
// a freshly-encoded replacement, otherwise the cached stuffed row.
long emit_rows(Cached *c, const std::vector<std::vector<uint8_t>> &dirty,
               const std::vector<uint8_t> &use_dirty, uint8_t *out,
               long cap) {
  Encoder &enc = *c->enc;
  size_t total = enc.header.size() + 2;
  for (int mr = 0; mr < enc.mcu_h; ++mr)
    total += (use_dirty[mr] ? dirty[mr] : c->rows[mr].stuffed).size() + 2;
  if ((long)total > cap) return -(long)total;
  uint8_t *p = out;
  std::memcpy(p, enc.header.data(), enc.header.size());
  p += enc.header.size();
  for (int mr = 0; mr < enc.mcu_h; ++mr) {
    const std::vector<uint8_t> &seg =
        use_dirty[mr] ? dirty[mr] : c->rows[mr].stuffed;
    std::memcpy(p, seg.data(), seg.size());
    p += seg.size();
    if (mr != enc.mcu_h - 1) {
      *p++ = 0xFF;
      *p++ = (uint8_t)(0xD0 + (mr & 7));
    }
  }
  *p++ = 0xFF;
  *p++ = 0xD9;
  return (long)(p - out);
}

long splice_with(Cached *c, const uint8_t *bgr,
                 const std::vector<uint8_t> &is_dirty, uint8_t *out,
                 long cap) {
  Encoder &enc = *c->enc;
  std::vector<std::vector<uint8_t>> dirty((size_t)enc.mcu_h);
  for (int mr = 0; mr < enc.mcu_h; ++mr)
    if (is_dirty[mr]) enc.encode_row(bgr, mr, &dirty[mr]);
  return emit_rows(c, dirty, is_dirty, out, cap);
}

Cached *lookup(int64_t handle) {
  std::lock_guard<std::mutex> lock(g_mutex);
  auto it = g_cache.find(handle);
  return it == g_cache.end() ? nullptr : &it->second;
}

}  // namespace

// Encode an annotated variant of a prepared frame: rows of 16px bands
// intersecting [y0, y1) are re-encoded from `bgr`, the rest splice from
// the cache. Same return convention as msm_jpeg_encode.
long msm_jpeg_encode_spliced(int64_t handle, const uint8_t *bgr, int y0,
                             int y1, uint8_t *out, long cap) {
  Cached *c = lookup(handle);
  if (!c || !bgr) return 0;
  Encoder &enc = *c->enc;
  int r0 = y0 < 0 ? 0 : y0 / 16;
  int r1 = (y1 + 15) / 16;
  if (r1 > enc.mcu_h) r1 = enc.mcu_h;
  std::vector<uint8_t> is_dirty((size_t)enc.mcu_h, 0);
  for (int mr = r0; mr < r1; ++mr) is_dirty[mr] = 1;
  return splice_with(c, bgr, is_dirty, out, cap);
}

// Bit-granular COLUMN splice: per MCU row r, `x0s[r] >= 0` marks a dirty
// pixel-x range [x0s[r], x1s[r]) — only the 16x16 MCUs intersecting it
// are re-encoded; the rest of the row is bit-copied from the cache with
// the bridge MCU's DC diffs recoded. A dot touches ~2-3 of a 640px
// row's 40 MCUs, so this is ~10x less encode work than a row splice.
long msm_jpeg_encode_spliced_cols(int64_t handle, const uint8_t *bgr,
                                  const int32_t *x0s, const int32_t *x1s,
                                  uint8_t *out, long cap) {
  Cached *c = lookup(handle);
  if (!c || !bgr || !x0s || !x1s) return 0;
  Encoder &enc = *c->enc;
  std::vector<std::vector<uint8_t>> dirty((size_t)enc.mcu_h);
  std::vector<uint8_t> use_dirty((size_t)enc.mcu_h, 0);
  for (int mr = 0; mr < enc.mcu_h; ++mr) {
    if (x0s[mr] < 0) continue;
    int m0 = x0s[mr] / 16;
    if (m0 < 0) m0 = 0;
    int m1 = (x1s[mr] + 15) / 16;
    if (m1 > enc.mcu_w) m1 = enc.mcu_w;
    if (m1 <= m0) m1 = m0 + 1;
    use_dirty[mr] = 1;
    splice_row_cols(enc, c->rows[mr], bgr, mr, m0, m1, &dirty[mr]);
  }
  return emit_rows(c, dirty, use_dirty, out, cap);
}

// Like msm_jpeg_encode_spliced_cols but taking the dirty pixel rects
// directly: `spans` is nspans * (y0, y1, x0, x1) int32. Each MCU row
// keeps the LIST of disjoint dirty MCU intervals the rects induce
// (merged when touching), so two dots far apart on one row re-encode
// ~4-6 MCUs instead of the whole union interval between them — the
// single-interval entry point above re-encoded ~1.3x the necessary
// MCUs on the multi-dot engines.
long msm_jpeg_encode_spliced_spans(int64_t handle, const uint8_t *bgr,
                                   const int32_t *spans, int nspans,
                                   uint8_t *out, long cap) {
  Cached *c = lookup(handle);
  if (!c || !bgr || (!spans && nspans > 0) || nspans < 0) return 0;
  Encoder &enc = *c->enc;
  // gather (row, m0, m1) triples — tiny (<= nspans * rows_per_span)
  std::vector<std::array<int, 3>> tri;
  tri.reserve((size_t)nspans * 4);
  for (int i = 0; i < nspans; ++i) {
    int y0 = spans[4 * i], y1 = spans[4 * i + 1];
    int x0 = spans[4 * i + 2], x1 = spans[4 * i + 3];
    int r0 = (y0 < 0 ? 0 : y0) / 16;
    int r1 = (y1 + 15) / 16;
    if (r1 > enc.mcu_h) r1 = enc.mcu_h;
    int m0 = (x0 < 0 ? 0 : x0) / 16;
    if (m0 >= enc.mcu_w) m0 = enc.mcu_w - 1;
    int m1 = (x1 + 15) / 16;
    if (m1 > enc.mcu_w) m1 = enc.mcu_w;
    if (m1 <= m0) m1 = m0 + 1;
    for (int r = r0; r < r1; ++r) tri.push_back({r, m0, m1});
  }
  std::sort(tri.begin(), tri.end());
  std::vector<std::vector<uint8_t>> dirty((size_t)enc.mcu_h);
  std::vector<uint8_t> use_dirty((size_t)enc.mcu_h, 0);
  std::vector<std::pair<int, int>> ivs;
  size_t i = 0;
  while (i < tri.size()) {
    int mr = tri[i][0];
    ivs.clear();
    for (; i < tri.size() && tri[i][0] == mr; ++i) {
      // merge when the gap leaves no clean bridge MCU between intervals
      if (!ivs.empty() && tri[i][1] <= ivs.back().second) {
        if (tri[i][2] > ivs.back().second) ivs.back().second = tri[i][2];
      } else {
        ivs.emplace_back(tri[i][1], tri[i][2]);
      }
    }
    use_dirty[mr] = 1;
    splice_row_cols_multi(enc, c->rows[(size_t)mr], bgr, mr, ivs.data(),
                          (int)ivs.size(), &dirty[(size_t)mr]);
  }
  return emit_rows(c, dirty, use_dirty, out, cap);
}

void msm_jpeg_release(int64_t handle) {
  std::lock_guard<std::mutex> lock(g_mutex);
  auto it = g_cache.find(handle);
  if (it != g_cache.end()) {
    delete it->second.enc;
    g_cache.erase(it);
  }
}

}  // extern "C"
