// A baseline JPEG codec whose output equals OpenCV's: cv2.imdecode(buf,
// IMREAD_UNCHANGED) and cv2.imencode(".jpg", bgr) at its defaults, both of
// which run libjpeg-turbo with the library's own defaults.
//
// Encoder (jpeg_set_defaults + jpeg_set_quality(q, force_baseline=TRUE),
// 4:2:0, the standard Huffman tables, no restart interval):
//   rgb_ycc_convert's 16-bit fixed-point sums (jccolor.c), the h2v2
//   downsampler with its alternating 1/2 bias and right-edge replication
//   (jcsample.c), bottom replication to the iMCU row (jcprepct.c), the
//   islow forward DCT (jfdctint.c) and the reciprocal quantiser of a
//   16-bit DCTELEM build (jcdctmgr.c compute_reciprocal/quantize), dummy
//   blocks at the right and bottom edges that repeat the previous DC
//   (jccoefct.c), and the marker order of jcmarker.c: SOI, JFIF APP0 1.01,
//   DQT 0, DQT 1, SOF0, DHT DC0 AC0 DC1 AC1, SOS, EOI.
// Decoder (Huffman, 8-bit, sequential; any number of scans):
//   the islow inverse DCT with its wrapping range limit (jidctint.c,
//   jdmaster.c prepare_range_limit_table), fancy upsampling for 4:2:0 and
//   4:2:2 (jdsample.c h2v2/h2v1_fancy_upsample: edge rows and columns
//   repeat, box upsampling where the chroma is two samples wide or less),
//   and ycc_rgb_convert's tables (jdcolor.c); the colour space is guessed
//   as jdapimin.c does. Progressive, arithmetic-coded, lossless and 12-bit
//   input raises with a message naming it.
// Integer arithmetic only. Exported through ctypes (ingest/jpeg.py).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

// zigzag position -> natural index; the 16 extra entries absorb a run that
// a corrupt stream pushes past the block's end (as jpeg_natural_order does)
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// Annex K quantisation tables, natural order
const uint8_t kStdLuma[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kStdChroma[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// Annex K Huffman tables: bits[1..16] (index 0 unused), values
const uint8_t kDcLumaBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
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
const uint8_t kAcChromaBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
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

// islow DCT constants: FIX(x) = round(x * 2^13) (the inverse DCT widens its
// operands to 64 bits; the forward one stays in 32, as 8-bit samples allow)
constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int32_t FIX_0_298631336 = 2446;
constexpr int32_t FIX_0_390180644 = 3196;
constexpr int32_t FIX_0_541196100 = 4433;
constexpr int32_t FIX_0_765366865 = 6270;
constexpr int32_t FIX_0_899976223 = 7373;
constexpr int32_t FIX_1_175875602 = 9633;
constexpr int32_t FIX_1_501321110 = 12299;
constexpr int32_t FIX_1_847759065 = 15137;
constexpr int32_t FIX_1_961570560 = 16069;
constexpr int32_t FIX_2_053119869 = 16819;
constexpr int32_t FIX_2_562915447 = 20995;
constexpr int32_t FIX_3_072711026 = 25172;

// colour conversion: FIX(x) = round(x * 2^16)
constexpr int64_t kScaleBits = 16;
constexpr int64_t kOneHalf = int64_t(1) << (kScaleBits - 1);
constexpr int64_t kCbCrOffset = int64_t(128) << kScaleBits;
constexpr int64_t FIX_0_29900 = 19595, FIX_0_58700 = 38470, FIX_0_11400 = 7471;
constexpr int64_t FIX_0_16874 = 11059, FIX_0_33126 = 21709, FIX_0_50000 = 32768;
constexpr int64_t FIX_0_41869 = 27439, FIX_0_08131 = 5329;
constexpr int64_t FIX_1_40200 = 91881, FIX_1_77200 = 116130;
constexpr int64_t FIX_0_71414 = 46802, FIX_0_34414 = 22554;

inline int64_t descale(int64_t x, int n) {
  return (x + (int64_t(1) << (n - 1))) >> n;
}

void set_error(char *err, int errcap, const std::string &msg) {
  if (err && errcap > 0) std::snprintf(err, (size_t)errcap, "%s", msg.c_str());
}

// ---------------------------------------------------------------------------
// Encoder
// ---------------------------------------------------------------------------

// the most bytes one Huffman-coded block takes: 64 codes of at most 16 +
// 11 bits, each byte possibly stuffed
constexpr size_t kBlockBytes = 2 * (64 * 27 / 8 + 8);

struct HuffCode {
  uint16_t code[256];
  uint8_t size[256];
};

void make_codes(const uint8_t bits[17], const uint8_t *vals, HuffCode *t) {
  std::memset(t->size, 0, sizeof(t->size));
  uint32_t code = 0;
  int k = 0;
  for (int l = 1; l <= 16; ++l) {
    for (int i = 0; i < bits[l]; ++i, ++k, ++code) {
      t->code[vals[k]] = (uint16_t)code;
      t->size[vals[k]] = (uint8_t)l;
    }
    code <<= 1;
  }
}

// jpeg_set_quality(q, TRUE): IJG scaling of the Annex K tables, clamped to
// the baseline range
void quality_table(const uint8_t *basic, int quality, uint16_t *out) {
  if (quality <= 0) quality = 1;
  if (quality > 100) quality = 100;
  const int64_t scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int i = 0; i < 64; ++i) {
    int64_t t = (basic[i] * scale + 50) / 100;
    t = std::min<int64_t>(std::max<int64_t>(t, 1), 255);
    out[i] = (uint16_t)t;
  }
}

// compute_reciprocal for a 16-bit DCTELEM: q = ((|x| + corr) * recip) >> shift
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

Divisor reciprocal(uint32_t divisor) {
  int b = 31 - __builtin_clz(divisor);  // flss(divisor) - 1
  int r = 16 + b;
  uint32_t fq = (uint32_t(1) << r) / divisor;
  uint32_t fr = (uint32_t(1) << r) % divisor;
  uint32_t c = divisor / 2;
  if (fr == 0) {  // a power of two
    fq >>= 1;
    --r;
  } else if (fr <= divisor / 2U) {
    ++c;
  } else {
    ++fq;
  }
  return Divisor{fq, c, r};
}

inline int32_t descale32(int32_t x, int n) {
  return (x + (1 << (n - 1))) >> n;
}

// jpeg_fdct_islow on level-shifted samples, in place (output scaled by 8);
// for 8-bit samples every intermediate fits in 32 bits
void fdct_islow(int32_t *data) {
  for (int row = 0; row < 8; ++row) {
    int32_t *p = data + row * 8;
    int32_t tmp0 = p[0] + p[7], tmp7 = p[0] - p[7];
    int32_t tmp1 = p[1] + p[6], tmp6 = p[1] - p[6];
    int32_t tmp2 = p[2] + p[5], tmp5 = p[2] - p[5];
    int32_t tmp3 = p[3] + p[4], tmp4 = p[3] - p[4];
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = ((tmp10 + tmp11) * (1 << kPass1Bits));
    p[4] = ((tmp10 - tmp11) * (1 << kPass1Bits));
    int32_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    p[2] = descale32(z1 + tmp13 * FIX_0_765366865, kConstBits - kPass1Bits);
    p[6] = descale32(z1 + tmp12 * -FIX_1_847759065, kConstBits - kPass1Bits);
    z1 = tmp4 + tmp7;
    int32_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int32_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    p[7] = descale32(tmp4 + z1 + z3, kConstBits - kPass1Bits);
    p[5] = descale32(tmp5 + z2 + z4, kConstBits - kPass1Bits);
    p[3] = descale32(tmp6 + z2 + z3, kConstBits - kPass1Bits);
    p[1] = descale32(tmp7 + z1 + z4, kConstBits - kPass1Bits);
  }
  for (int col = 0; col < 8; ++col) {
    int32_t *p = data + col;
    int32_t tmp0 = p[0] + p[56], tmp7 = p[0] - p[56];
    int32_t tmp1 = p[8] + p[48], tmp6 = p[8] - p[48];
    int32_t tmp2 = p[16] + p[40], tmp5 = p[16] - p[40];
    int32_t tmp3 = p[24] + p[32], tmp4 = p[24] - p[32];
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = descale32(tmp10 + tmp11, kPass1Bits);
    p[32] = descale32(tmp10 - tmp11, kPass1Bits);
    int32_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    p[16] = descale32(z1 + tmp13 * FIX_0_765366865, kConstBits + kPass1Bits);
    p[48] = descale32(z1 + tmp12 * -FIX_1_847759065, kConstBits + kPass1Bits);
    z1 = tmp4 + tmp7;
    int32_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int32_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    p[56] = descale32(tmp4 + z1 + z3, kConstBits + kPass1Bits);
    p[40] = descale32(tmp5 + z2 + z4, kConstBits + kPass1Bits);
    p[24] = descale32(tmp6 + z2 + z3, kConstBits + kPass1Bits);
    p[8] = descale32(tmp7 + z1 + z4, kConstBits + kPass1Bits);
  }
}

// Bits into `out` from `out.size()` on; `reserve(n)` before a block
// guarantees room for n more bytes (stuffing included).
struct BitWriter {
  std::vector<uint8_t> &out;
  size_t pos;
  uint8_t *data;
  uint64_t buf = 0;
  int nbits = 0;

  explicit BitWriter(std::vector<uint8_t> &o)
      : out(o), pos(o.size()), data(o.data()) {}

  void reserve(size_t n) {
    if (pos + n > out.size()) {
      out.resize(std::max(out.size() * 2, pos + n));
      data = out.data();
    }
  }

  // `size` <= 32 bits of `value`, which holds nothing above them
  void put(uint32_t value, int size) {
    buf = (buf << size) | value;
    nbits += size;
    if (nbits >= 32) emit(32);
  }

  void emit(int whole) {  // the top `whole` bits, a byte at a time
    for (; whole > 0; whole -= 8) {
      const uint8_t c = (uint8_t)(buf >> (nbits - 8));
      data[pos++] = c;
      if (c == 0xFF) data[pos++] = 0;  // byte stuffing
      nbits -= 8;
    }
  }

  void flush() {  // pad the last byte with one-bits (jchuff.c flush_bits)
    reserve(16);
    put(0x7F, 7);
    emit(nbits & ~7);
    buf = 0;
    nbits = 0;
    out.resize(pos);
  }
};

// jchuff.c encode_one_block
void encode_block(BitWriter &bw, const int16_t *coef, int last_dc,
                  const HuffCode &dc, const HuffCode &ac) {
  int temp = coef[0] - last_dc, temp2 = temp;
  if (temp < 0) {
    temp = -temp;
    --temp2;
  }
  int nbits = temp ? 32 - __builtin_clz((uint32_t)temp) : 0;
  bw.put(((uint32_t)dc.code[nbits] << nbits) |
             ((uint32_t)temp2 & ((1u << nbits) - 1)),
         dc.size[nbits] + nbits);
  int r = 0;
  for (int k = 1; k < 64; ++k) {
    temp = coef[kNatural[k]];
    if (temp == 0) {
      ++r;
      continue;
    }
    while (r > 15) {
      bw.put(ac.code[0xF0], ac.size[0xF0]);
      r -= 16;
    }
    temp2 = temp;
    if (temp < 0) {
      temp = -temp;
      --temp2;
    }
    nbits = 32 - __builtin_clz((uint32_t)temp);
    const int sym = (r << 4) + nbits;
    bw.put(((uint32_t)ac.code[sym] << nbits) |
               ((uint32_t)temp2 & ((1u << nbits) - 1)),
           ac.size[sym] + nbits);
    r = 0;
  }
  if (r > 0) bw.put(ac.code[0], ac.size[0]);
}

void put_marker(std::vector<uint8_t> &o, uint8_t m) {
  o.push_back(0xFF);
  o.push_back(m);
}

void put_u16(std::vector<uint8_t> &o, int v) {
  o.push_back((uint8_t)(v >> 8));
  o.push_back((uint8_t)(v & 0xFF));
}

void put_dqt(std::vector<uint8_t> &o, int index, const uint16_t *q) {
  put_marker(o, 0xDB);
  put_u16(o, 67);
  o.push_back((uint8_t)index);
  for (int k = 0; k < 64; ++k) o.push_back((uint8_t)q[kNatural[k]]);
}

void put_dht(std::vector<uint8_t> &o, int index, const uint8_t bits[17],
             const uint8_t *vals) {
  int n = 0;
  for (int l = 1; l <= 16; ++l) n += bits[l];
  put_marker(o, 0xC4);
  put_u16(o, 2 + 1 + 16 + n);
  o.push_back((uint8_t)index);
  for (int l = 1; l <= 16; ++l) o.push_back(bits[l]);
  for (int i = 0; i < n; ++i) o.push_back(vals[i]);
}

// Quantise a forward-DCT output block into natural-order coefficients.
void quantize(const int32_t *ws, const Divisor *div, int16_t *coef) {
  for (int i = 0; i < 64; ++i) {
    int32_t t = ws[i];
    const Divisor &d = div[i];
    if (t < 0) {
      uint32_t q = ((uint32_t)(-t) + d.corr) * d.recip >> d.shift;
      coef[i] = (int16_t)(-(int32_t)q);
    } else {
      uint32_t q = ((uint32_t)t + d.corr) * d.recip >> d.shift;
      coef[i] = (int16_t)q;
    }
  }
}

// A plane of `rows` x `cols` samples, each block at (by, bx) level-shifted,
// transformed and quantised.
void block_coefs(const std::vector<uint8_t> &plane, int cols, int by, int bx,
                 const Divisor *div, int16_t *coef) {
  int32_t ws[64];
  for (int y = 0; y < 8; ++y) {
    const uint8_t *src = plane.data() + (size_t)(by * 8 + y) * cols + bx * 8;
    for (int x = 0; x < 8; ++x) ws[y * 8 + x] = (int32_t)src[x] - 128;
  }
  fdct_islow(ws);
  quantize(ws, div, coef);
}

long encode_bgr(const uint8_t *bgr, int h, int w, int quality,
                std::vector<uint8_t> &o) {
  // component geometry (jcmaster.c initial_setup): Y 2x2, Cb and Cr 1x1
  const int mcux = (w + 15) / 16, mcuy = (h + 15) / 16;
  const int ywb = (w + 7) / 8, yhb = (h + 7) / 8;      // Y blocks
  const int cwb = (w + 15) / 16, chb = (h + 15) / 16;  // chroma blocks
  const int ycols = ywb * 8, yrows = yhb * 8;
  const int ccols = cwb * 8, crows = chb * 8;
  const int hx = 2 * ((h + 1) / 2);  // rows after the conversion buffer pad
  const int wx = ccols * 2;          // columns the downsampler reads

  // colour conversion (rgb_ycc_start's tables) into edge-replicated
  // full-size planes; columns and rows past the image repeat its last
  int32_t tab[8][256];
  for (int i = 0; i < 256; ++i) {
    tab[0][i] = (int32_t)(FIX_0_29900 * i);
    tab[1][i] = (int32_t)(FIX_0_58700 * i);
    tab[2][i] = (int32_t)(FIX_0_11400 * i + kOneHalf);
    tab[3][i] = (int32_t)(-FIX_0_16874 * i);
    tab[4][i] = (int32_t)(-FIX_0_33126 * i);
    tab[5][i] = (int32_t)(FIX_0_50000 * i + kCbCrOffset + kOneHalf - 1);
    tab[6][i] = (int32_t)(-FIX_0_41869 * i);
    tab[7][i] = (int32_t)(-FIX_0_08131 * i);
  }
  std::vector<uint8_t> Y((size_t)yrows * ycols), Cb((size_t)hx * wx),
      Cr((size_t)hx * wx);
  for (int y = 0; y < std::min(h, std::max(yrows, hx)); ++y) {
    const uint8_t *px = bgr + (size_t)y * w * 3;
    uint8_t *yr = y < yrows ? &Y[(size_t)y * ycols] : nullptr;
    uint8_t *cbr = y < hx ? &Cb[(size_t)y * wx] : nullptr;
    uint8_t *crr = y < hx ? &Cr[(size_t)y * wx] : nullptr;
    for (int x = 0; x < w; ++x, px += 3) {
      const int b = px[0], g = px[1], r = px[2];
      if (yr) yr[x] = (uint8_t)((tab[0][r] + tab[1][g] + tab[2][b]) >> 16);
      if (cbr) {
        cbr[x] = (uint8_t)((tab[3][r] + tab[4][g] + tab[5][b]) >> 16);
        crr[x] = (uint8_t)((tab[5][r] + tab[6][g] + tab[7][b]) >> 16);
      }
    }
    if (yr) std::memset(yr + w, yr[w - 1], (size_t)(ycols - w));
    if (cbr) {
      std::memset(cbr + w, cbr[w - 1], (size_t)(wx - w));
      std::memset(crr + w, crr[w - 1], (size_t)(wx - w));
    }
  }
  for (int y = h; y < yrows; ++y)
    std::memcpy(&Y[(size_t)y * ycols], &Y[(size_t)(h - 1) * ycols], ycols);
  for (int y = h; y < hx; ++y) {
    std::memcpy(&Cb[(size_t)y * wx], &Cb[(size_t)(h - 1) * wx], wx);
    std::memcpy(&Cr[(size_t)y * wx], &Cr[(size_t)(h - 1) * wx], wx);
  }
  // h2v2 downsampling (bias 1, 2, 1, 2, ... along each output row), then
  // the last chroma row repeated to the iMCU row
  std::vector<uint8_t> Cbd((size_t)crows * ccols), Crd((size_t)crows * ccols);
  for (int oy = 0; oy < crows; ++oy) {
    const int iy = std::min(oy, hx / 2 - 1) * 2;
    for (int c = 0; c < 2; ++c) {
      const std::vector<uint8_t> &in = c ? Cr : Cb;
      std::vector<uint8_t> &out = c ? Crd : Cbd;
      const uint8_t *r0 = &in[(size_t)iy * wx], *r1 = r0 + wx;
      int bias = 1;
      for (int ox = 0; ox < ccols; ++ox) {
        out[(size_t)oy * ccols + ox] =
            (uint8_t)((r0[2 * ox] + r0[2 * ox + 1] + r1[2 * ox] +
                       r1[2 * ox + 1] + bias) >> 2);
        bias ^= 3;
      }
    }
  }

  uint16_t qluma[64], qchroma[64];
  quality_table(kStdLuma, quality, qluma);
  quality_table(kStdChroma, quality, qchroma);
  Divisor dluma[64], dchroma[64];
  for (int i = 0; i < 64; ++i) {
    dluma[i] = reciprocal((uint32_t)qluma[i] << 3);
    dchroma[i] = reciprocal((uint32_t)qchroma[i] << 3);
  }
  HuffCode dc0, ac0, dc1, ac1;
  make_codes(kDcLumaBits, kDcVals, &dc0);
  make_codes(kAcLumaBits, kAcLumaVals, &ac0);
  make_codes(kDcChromaBits, kDcVals, &dc1);
  make_codes(kAcChromaBits, kAcChromaVals, &ac1);

  // headers (jcmarker.c)
  put_marker(o, 0xD8);
  static const uint8_t kJfif[16] = {0xFF, 0xE0, 0x00, 0x10, 'J', 'F', 'I', 'F',
                                    0x00, 0x01, 0x01, 0x00, 0x00, 0x01, 0x00, 0x01};
  o.insert(o.end(), kJfif, kJfif + 16);
  o.push_back(0);  // no thumbnail
  o.push_back(0);
  put_dqt(o, 0, qluma);
  put_dqt(o, 1, qchroma);
  put_marker(o, 0xC0);
  put_u16(o, 17);
  o.push_back(8);
  put_u16(o, h);
  put_u16(o, w);
  o.push_back(3);
  const uint8_t sof_comps[9] = {1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1};
  o.insert(o.end(), sof_comps, sof_comps + 9);
  put_dht(o, 0x00, kDcLumaBits, kDcVals);
  put_dht(o, 0x10, kAcLumaBits, kAcLumaVals);
  put_dht(o, 0x01, kDcChromaBits, kDcVals);
  put_dht(o, 0x11, kAcChromaBits, kAcChromaVals);
  put_marker(o, 0xDA);
  put_u16(o, 12);
  o.push_back(3);
  const uint8_t sos_comps[6] = {1, 0x00, 2, 0x11, 3, 0x11};
  o.insert(o.end(), sos_comps, sos_comps + 6);
  o.push_back(0);
  o.push_back(63);
  o.push_back(0);

  BitWriter bw(o);
  int last_dc[3] = {0, 0, 0};
  int16_t coef[64];
  for (int my = 0; my < mcuy; ++my) {
    for (int mx = 0; mx < mcux; ++mx) {
      for (int yy = 0; yy < 2; ++yy) {
        for (int xx = 0; xx < 2; ++xx) {
          const int by = my * 2 + yy, bx = mx * 2 + xx;
          if (by < yhb && bx < ywb) {
            block_coefs(Y, ycols, by, bx, dluma, coef);
          } else {
            // a dummy block past the edge: the previous block's DC and no
            // AC (jccoefct.c), so a DC difference of 0 and an EOB
            std::memset(coef, 0, sizeof(coef));
            coef[0] = (int16_t)last_dc[0];
          }
          bw.reserve(kBlockBytes);
          encode_block(bw, coef, last_dc[0], dc0, ac0);
          last_dc[0] = coef[0];
        }
      }
      for (int c = 1; c < 3; ++c) {
        block_coefs(c == 1 ? Cbd : Crd, ccols, my, mx, dchroma, coef);
        bw.reserve(kBlockBytes);
        encode_block(bw, coef, last_dc[c], dc1, ac1);
        last_dc[c] = coef[0];
      }
    }
  }
  bw.flush();
  put_marker(o, 0xD9);
  return (long)o.size();
}

// ---------------------------------------------------------------------------
// Decoder
// ---------------------------------------------------------------------------

struct HuffDecode {
  bool present = false;
  uint8_t vals[256];
  int32_t maxcode[18];
  int32_t valoffset[18];
  // 9-bit lookahead: (size << 8) | value, or 0 where the code is longer
  uint16_t look[512];
};

bool build_decode(const uint8_t bits[17], const uint8_t *vals, int nvals,
                  HuffDecode *t) {
  std::memcpy(t->vals, vals, (size_t)nvals);
  uint8_t sizes[257];
  uint16_t codes[257];
  int p = 0;
  for (int l = 1; l <= 16; ++l)
    for (int i = 0; i < bits[l]; ++i) sizes[p++] = (uint8_t)l;
  sizes[p] = 0;
  uint32_t code = 0;
  int si = sizes[0];
  p = 0;
  while (sizes[p]) {
    while (sizes[p] == si) codes[p++] = (uint16_t)code++;
    if (code >= (uint32_t(1) << si)) return false;  // bad table
    code <<= 1;
    ++si;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (bits[l]) {
      t->valoffset[l] = p - (int32_t)codes[p];
      p += bits[l];
      t->maxcode[l] = codes[p - 1];
    } else {
      t->maxcode[l] = -1;
    }
  }
  t->valoffset[17] = 0;
  t->maxcode[17] = 0x7FFFFFFF;  // ensures the slow loop ends
  std::memset(t->look, 0, sizeof(t->look));
  p = 0;
  for (int l = 1; l <= 9; ++l) {
    for (int i = 0; i < bits[l]; ++i, ++p) {
      const int lookbits = codes[p] << (9 - l);
      for (int ctr = 1 << (9 - l); ctr > 0; --ctr)
        t->look[lookbits + ctr - 1] = (uint16_t)((l << 8) | t->vals[p]);
    }
  }
  t->present = true;
  return true;
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0, td = 0, ta = 0;
  int bw = 0, bh = 0;  // allocated blocks (whole MCUs)
  int dw = 0, dh = 0;  // downsampled width and height (real samples)
  std::vector<int16_t> coef;
  int dc_pred = 0;
};

struct Decoder {
  const uint8_t *p, *end;
  std::string err;
  uint16_t qt[4][64];
  bool qt_ok[4] = {false, false, false, false};
  HuffDecode dc[4], ac[4];
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  Component comp[4];
  bool frame = false, saw_jfif = false, saw_adobe = false;
  int adobe_transform = 0, restart_interval = 0;
  // bit reader over the entropy-coded segment
  uint64_t bitbuf = 0;
  int bitcnt = 0;
  bool hit_marker = false;

  Decoder(const uint8_t *buf, long n) : p(buf), end(buf + n) {}

  bool fail(const std::string &m) {
    if (err.empty()) err = m;
    return false;
  }

  int u8() { return p < end ? *p++ : (p++, 0); }
  int u16() {
    int a = u8();
    return (a << 8) | u8();
  }

  // the next marker code, skipping fill bytes; -1 at the end of data
  int next_marker() {
    while (p < end) {
      if (*p != 0xFF) {
        ++p;  // garbage between segments (libjpeg warns and skips it)
        continue;
      }
      while (p < end && *p == 0xFF) ++p;
      if (p >= end) return -1;
      const int m = *p++;
      if (m != 0) return m;
    }
    return -1;
  }

  bool parse_sof(int marker, int len) {
    if (frame) return fail("more than one frame header");
    const uint8_t *seg_end = p + len - 2;
    const int precision = u8();
    height = u16();
    width = u16();
    ncomp = u8();
    if (marker == 0xC2 || marker == 0xC6 || marker == 0xCA || marker == 0xCE)
      return fail("progressive JPEG (SOF" + std::to_string(marker - 0xC0) +
                  ") is not supported");
    if (marker == 0xC3 || marker == 0xC7 || marker == 0xCB || marker == 0xCF)
      return fail("lossless JPEG (SOF" + std::to_string(marker - 0xC0) +
                  ") is not supported");
    if (marker >= 0xC9)
      return fail("arithmetic-coded JPEG (SOF" +
                  std::to_string(marker - 0xC0) + ") is not supported");
    if (marker == 0xC5)
      return fail("hierarchical JPEG (SOF5) is not supported");
    if (precision != 8)
      return fail(std::to_string(precision) +
                  "-bit JPEG is not supported (8-bit only)");
    if (height <= 0 || width <= 0)
      return fail("image height or width is 0 (DNL is not supported)");
    if (ncomp != 1 && ncomp != 3)
      return fail(std::to_string(ncomp) +
                  "-component JPEG is not supported (1 or 3)");
    if (len != 8 + 3 * ncomp) return fail("bad SOF length");
    for (int c = 0; c < ncomp; ++c) {
      comp[c].id = u8();
      const int hv = u8();
      comp[c].h = hv >> 4;
      comp[c].v = hv & 15;
      comp[c].tq = u8();
      if (comp[c].h < 1 || comp[c].h > 4 || comp[c].v < 1 || comp[c].v > 4 ||
          comp[c].tq > 3)
        return fail("bad component sampling or table");
      hmax = std::max(hmax, comp[c].h);
      vmax = std::max(vmax, comp[c].v);
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    if ((int64_t)width * height > (int64_t)1 << 30)
      return fail("image too large");
    for (int c = 0; c < ncomp; ++c) {
      Component &k = comp[c];
      if (ncomp == 3 && (hmax % k.h || vmax % k.v))
        return fail("unsupported sampling factors");
      k.bw = mcux * k.h;
      k.bh = mcuy * k.v;
      k.dw = (int)(((int64_t)width * k.h + hmax - 1) / hmax);
      k.dh = (int)(((int64_t)height * k.v + vmax - 1) / vmax);
      k.coef.assign((size_t)k.bw * k.bh * 64, 0);
    }
    p = seg_end;
    frame = true;
    return true;
  }

  bool parse_dqt(int len) {
    const uint8_t *seg_end = p + len - 2;
    while (p < seg_end) {
      const int pq = u8();
      const int tq = pq & 15, prec = pq >> 4;
      if (tq > 3 || prec > 1) return fail("bad DQT");
      for (int k = 0; k < 64; ++k)
        qt[tq][kNatural[k]] = (uint16_t)(prec ? u16() : u8());
      qt_ok[tq] = true;
    }
    p = seg_end;
    return true;
  }

  bool parse_dht(int len) {
    const uint8_t *seg_end = p + len - 2;
    while (p < seg_end) {
      const int tc_th = u8();
      const int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) return fail("bad DHT");
      uint8_t bits[17] = {0};
      int n = 0;
      for (int l = 1; l <= 16; ++l) {
        bits[l] = (uint8_t)u8();
        n += bits[l];
      }
      if (n > 256) return fail("bad DHT");
      uint8_t vals[256];
      for (int i = 0; i < n; ++i) {
        vals[i] = (uint8_t)u8();
        if (tc == 0 && vals[i] > 15) return fail("bad DC Huffman table");
      }
      if (!build_decode(bits, vals, n, tc ? &ac[th] : &dc[th]))
        return fail("bad Huffman table");
    }
    p = seg_end;
    return true;
  }

  void parse_app(int marker, int len) {
    const uint8_t *seg_end = p + len - 2;
    const long n = std::min<long>(len - 2, end - p);
    if (marker == 0xE0 && n >= 5 && std::memcmp(p, "JFIF\0", 5) == 0)
      saw_jfif = true;
    if (marker == 0xEE && n >= 12 && std::memcmp(p, "Adobe", 5) == 0) {
      saw_adobe = true;
      adobe_transform = p[11];
    }
    p = seg_end;
  }

  // -- entropy-coded data ------------------------------------------------

  void fill() {
    while (bitcnt <= 56) {
      int byte = 0;
      if (!hit_marker && p < end) {
        if (*p == 0xFF) {
          const int nxt = p + 1 < end ? p[1] : 0xD9;
          if (nxt == 0) {
            byte = 0xFF;
            p += 2;
          } else {
            hit_marker = true;  // zeros from here on (libjpeg's behaviour)
          }
        } else {
          byte = *p++;
        }
      }
      bitbuf |= (uint64_t)byte << (56 - bitcnt);
      bitcnt += 8;
    }
  }

  int get_bits(int n) {
    if (n == 0) return 0;
    if (bitcnt < n) fill();
    const int v = (int)(bitbuf >> (64 - n));
    bitbuf <<= n;
    bitcnt -= n;
    return v;
  }

  int decode_huff(const HuffDecode &t) {
    if (bitcnt < 16) fill();
    const int look = t.look[bitbuf >> (64 - 9)];
    if (look) {
      const int l = look >> 8;
      bitbuf <<= l;
      bitcnt -= l;
      return look & 0xFF;
    }
    int l = 10;
    int32_t code = (int32_t)(bitbuf >> (64 - l));
    while (l <= 16 && code > t.maxcode[l]) {
      ++l;
      code = (int32_t)(bitbuf >> (64 - l));
    }
    if (l > 16) {  // corrupt data: libjpeg warns and returns 0
      bitbuf <<= 16;
      bitcnt -= 16;
      return 0;
    }
    bitbuf <<= l;
    bitcnt -= l;
    return t.vals[(code + t.valoffset[l]) & 0xFF];
  }

  static int extend(int v, int s) {
    return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
  }

  // false where the DC sum leaves int's range (jdhuff.c's JERR_BAD_DCT_COEF)
  bool decode_block(Component &k, int16_t *blk, const HuffDecode &dct,
                    const HuffDecode &act) {
    int s = decode_huff(dct);
    const int diff = s ? extend(get_bits(s), s) : 0;
    if ((int64_t)k.dc_pred + diff > INT32_MAX ||
        (int64_t)k.dc_pred + diff < INT32_MIN)
      return false;
    k.dc_pred += diff;
    blk[0] = (int16_t)k.dc_pred;
    for (int kk = 1; kk < 64; ++kk) {
      const int rs = decode_huff(act);
      const int r = rs >> 4;
      s = rs & 15;
      if (s) {
        kk += r;
        blk[kNatural[kk]] = (int16_t)extend(get_bits(s), s);
      } else {
        if (r != 15) break;
        kk += 15;
      }
    }
    return true;
  }

  bool restart() {
    bitbuf = 0;
    bitcnt = 0;
    hit_marker = false;
    const int m = next_marker();
    if (m < 0xD0 || m > 0xD7) return fail("missing restart marker");
    for (int c = 0; c < ncomp; ++c) comp[c].dc_pred = 0;
    return true;
  }

  bool parse_sos(int len) {
    if (!frame) return fail("scan before the frame header");
    const int ns = u8();
    if (ns < 1 || ns > 4 || len != 6 + 2 * ns) return fail("bad SOS");
    int idx[4];
    for (int i = 0; i < ns; ++i) {
      const int id = u8(), t = u8();
      idx[i] = -1;
      for (int c = 0; c < ncomp; ++c)
        if (comp[c].id == id) idx[i] = c;
      if (idx[i] < 0) return fail("scan names an unknown component");
      comp[idx[i]].td = t >> 4;
      comp[idx[i]].ta = t & 15;
      if (comp[idx[i]].td > 3 || comp[idx[i]].ta > 3) return fail("bad SOS");
      if (!dc[comp[idx[i]].td].present || !ac[comp[idx[i]].ta].present)
        return fail("scan uses an undefined Huffman table");
    }
    const int ss = u8(), se = u8(), ahl = u8();
    if (ss != 0 || se != 63 || ahl != 0) return fail("bad spectral selection");
    for (int c = 0; c < ncomp; ++c) comp[c].dc_pred = 0;
    bitbuf = 0;
    bitcnt = 0;
    hit_marker = false;
    int todo = restart_interval;
    if (ns == 1) {  // non-interleaved: the component's own block grid
      Component &k = comp[idx[0]];
      const int nbx = (k.dw + 7) / 8, nby = (k.dh + 7) / 8;
      for (int by = 0; by < nby; ++by) {
        for (int bx = 0; bx < nbx; ++bx) {
          if (restart_interval && todo == 0) {
            if (!restart()) return false;
            todo = restart_interval;
          }
          if (!decode_block(k, &k.coef[((size_t)by * k.bw + bx) * 64],
                            dc[k.td], ac[k.ta]))
            return fail("bad DC coefficient");
          --todo;
        }
      }
    } else {
      for (int my = 0; my < mcuy; ++my) {
        for (int mx = 0; mx < mcux; ++mx) {
          if (restart_interval && todo == 0) {
            if (!restart()) return false;
            todo = restart_interval;
          }
          for (int i = 0; i < ns; ++i) {
            Component &k = comp[idx[i]];
            for (int yy = 0; yy < k.v; ++yy)
              for (int xx = 0; xx < k.h; ++xx) {
                const int by = my * k.v + yy, bx = mx * k.h + xx;
                if (!decode_block(k, &k.coef[((size_t)by * k.bw + bx) * 64],
                                  dc[k.td], ac[k.ta]))
                  return fail("bad DC coefficient");
              }
          }
          --todo;
        }
      }
    }
    // leave the reader at the marker that ends the scan
    bitbuf = 0;
    bitcnt = 0;
    while (p < end && !(p[0] == 0xFF && p + 1 < end && p[1] != 0 &&
                        !(p[1] >= 0xD0 && p[1] <= 0xD7)))
      ++p;
    return true;
  }

  bool parse() {
    if (end - p < 2 || p[0] != 0xFF || p[1] != 0xD8)
      return fail("not a JPEG (no SOI marker)");
    p += 2;
    bool scanned = false;
    for (;;) {
      const int m = next_marker();
      if (m < 0 || m == 0xD9) break;  // EOI or a truncated file
      if (m >= 0xD0 && m <= 0xD7) continue;
      const int len = u16();
      if (len < 2 || p + len - 2 > end) return fail("truncated JPEG segment");
      if (m == 0xC4) {
        if (!parse_dht(len)) return false;
      } else if (m == 0xCC) {
        return fail("arithmetic-coded JPEG (DAC) is not supported");
      } else if (m >= 0xC0 && m <= 0xCF) {
        if (!parse_sof(m, len)) return false;
      } else if (m == 0xDB) {
        if (!parse_dqt(len)) return false;
      } else if (m == 0xDD) {
        restart_interval = u16();
      } else if (m == 0xDA) {
        if (!parse_sos(len)) return false;
        scanned = true;
      } else if (m >= 0xE0 && m <= 0xEF) {
        parse_app(m, len);
      } else {
        p += len - 2;
      }
    }
    if (!frame) return fail("no frame header");
    if (!scanned) return fail("no scan");
    for (int c = 0; c < ncomp; ++c)
      if (!qt_ok[comp[c].tq]) return fail("undefined quantisation table");
    return true;
  }

  // header only, up to the frame header
  bool parse_header() {
    if (end - p < 2 || p[0] != 0xFF || p[1] != 0xD8)
      return fail("not a JPEG (no SOI marker)");
    p += 2;
    for (;;) {
      const int m = next_marker();
      if (m < 0 || m == 0xD9 || m == 0xDA) return fail("no frame header");
      if (m >= 0xD0 && m <= 0xD7) continue;
      const int len = u16();
      if (len < 2 || p + len - 2 > end) return fail("truncated JPEG segment");
      if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xCC)
        return parse_sof(m, len);
      p += len - 2;
    }
  }
};

inline uint8_t idct_limit(int64_t x) {
  // jdmaster.c's post-IDCT table: index (x & 1023), centred on 128
  const int y = (int)(((x + 512) & 1023) - 512) + 128;
  return (uint8_t)(y < 0 ? 0 : (y > 255 ? 255 : y));
}

// jpeg_idct_islow: dequantise, transform, range-limit into `out` (stride)
void idct_islow(const int16_t *in, const uint16_t *q, uint8_t *out,
                int stride) {
  int64_t ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t *ip = in + c;
    const uint16_t *qp = q + c;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] &&
        !ip[56]) {
      const int64_t dcval = (int64_t)ip[0] * qp[0] * (1 << kPass1Bits);
      for (int r = 0; r < 8; ++r) ws[r * 8 + c] = dcval;
      continue;
    }
    int64_t z2 = (int64_t)ip[16] * qp[16], z3 = (int64_t)ip[48] * qp[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = (int64_t)ip[0] * qp[0];
    z3 = (int64_t)ip[32] * qp[32];
    int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = (int64_t)ip[56] * qp[56];
    tmp1 = (int64_t)ip[40] * qp[40];
    tmp2 = (int64_t)ip[24] * qp[24];
    tmp3 = (int64_t)ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = kConstBits - kPass1Bits;
    ws[0 * 8 + c] = (int32_t)descale(tmp10 + tmp3, n);
    ws[7 * 8 + c] = (int32_t)descale(tmp10 - tmp3, n);
    ws[1 * 8 + c] = (int32_t)descale(tmp11 + tmp2, n);
    ws[6 * 8 + c] = (int32_t)descale(tmp11 - tmp2, n);
    ws[2 * 8 + c] = (int32_t)descale(tmp12 + tmp1, n);
    ws[5 * 8 + c] = (int32_t)descale(tmp12 - tmp1, n);
    ws[3 * 8 + c] = (int32_t)descale(tmp13 + tmp0, n);
    ws[4 * 8 + c] = (int32_t)descale(tmp13 - tmp0, n);
  }
  const int n = kConstBits + kPass1Bits + 3;
  for (int r = 0; r < 8; ++r) {
    const int64_t *w = ws + r * 8;
    uint8_t *o = out + (size_t)r * stride;
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (w[0] + w[4]) * (1 << kConstBits);
    int64_t tmp1 = (w[0] - w[4]) * (1 << kConstBits);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    o[0] = idct_limit(descale(tmp10 + tmp3, n));
    o[7] = idct_limit(descale(tmp10 - tmp3, n));
    o[1] = idct_limit(descale(tmp11 + tmp2, n));
    o[6] = idct_limit(descale(tmp11 - tmp2, n));
    o[2] = idct_limit(descale(tmp12 + tmp1, n));
    o[5] = idct_limit(descale(tmp12 - tmp1, n));
    o[3] = idct_limit(descale(tmp13 + tmp0, n));
    o[4] = idct_limit(descale(tmp13 - tmp0, n));
  }
}

inline uint8_t clamp255(int64_t x) {
  return (uint8_t)(x < 0 ? 0 : (x > 255 ? 255 : x));
}

// One full-width row `y` of component `k` (its plane `pl`, stride `ps`).
void upsample_row(const Component &k, int hmax, int vmax, int width, int y,
                  const uint8_t *pl, int ps, uint8_t *out) {
  const int fh = hmax / k.h, fv = vmax / k.v;
  if (fh == 1 && fv == 1) {
    std::memcpy(out, pl + (size_t)y * ps, (size_t)width);
    return;
  }
  const int dw = k.dw;
  const bool fancy = dw > 2;
  if (fh == 2 && fv == 1) {
    const uint8_t *in = pl + (size_t)y * ps;
    for (int i = 0; i < dw; ++i) {
      int a, b;
      if (fancy) {
        const int s = in[i] * 3;
        a = (s + in[std::max(i - 1, 0)] + 1) >> 2;
        b = (s + in[std::min(i + 1, dw - 1)] + 2) >> 2;
      } else {
        a = b = in[i];
      }
      if (2 * i < width) out[2 * i] = (uint8_t)a;
      if (2 * i + 1 < width) out[2 * i + 1] = (uint8_t)b;
    }
    return;
  }
  // fh == 2 && fv == 2
  const int inrow = y >> 1;
  const uint8_t *in0 = pl + (size_t)inrow * ps;
  if (!fancy) {
    for (int x = 0; x < width; ++x) out[x] = in0[x >> 1];
    return;
  }
  const int far = (y & 1) ? std::min(inrow + 1, k.dh - 1)
                          : std::max(inrow - 1, 0);
  const uint8_t *in1 = pl + (size_t)far * ps;
  auto colsum = [&](int i) { return in0[i] * 3 + in1[i]; };
  for (int i = 0; i < dw; ++i) {
    const int t = colsum(i);
    const int a = (t * 3 + colsum(std::max(i - 1, 0)) + 8) >> 4;
    const int b = (t * 3 + colsum(std::min(i + 1, dw - 1)) + 7) >> 4;
    if (2 * i < width) out[2 * i] = (uint8_t)a;
    if (2 * i + 1 < width) out[2 * i + 1] = (uint8_t)b;
  }
}

bool decode_into(Decoder &d, uint8_t *out, long cap) {
  if (!d.parse()) return false;
  const int w = d.width, h = d.height;
  if (cap < (long)w * h * d.ncomp) return d.fail("output buffer too small");
  if (d.ncomp == 3) {
    for (int c = 0; c < 3; ++c) {
      const int fh = d.hmax / d.comp[c].h, fv = d.vmax / d.comp[c].v;
      if (!((fh == 1 && fv == 1) || (fh == 2 && fv == 1) ||
            (fh == 2 && fv == 2)))
        return d.fail("unsupported sampling factors (4:4:4, 4:2:2 and "
                      "4:2:0 only)");
    }
  }
  std::vector<std::vector<uint8_t>> planes(d.ncomp);
  for (int c = 0; c < d.ncomp; ++c) {
    Component &k = d.comp[c];
    const int ps = k.bw * 8;
    const int nbx = (k.dw + 7) / 8, nby = (k.dh + 7) / 8;
    planes[c].assign((size_t)ps * k.bh * 8, 0);
    for (int by = 0; by < nby; ++by)
      for (int bx = 0; bx < nbx; ++bx)
        idct_islow(&k.coef[((size_t)by * k.bw + bx) * 64], d.qt[k.tq],
                   &planes[c][(size_t)by * 8 * ps + bx * 8], ps);
  }
  if (d.ncomp == 1) {
    const int ps = d.comp[0].bw * 8;
    for (int y = 0; y < h; ++y)
      std::memcpy(out + (size_t)y * w, &planes[0][(size_t)y * ps], (size_t)w);
    return true;
  }
  bool rgb = false;  // jdapimin.c default_decompress_parms
  if (d.saw_jfif) {
    rgb = false;
  } else if (d.saw_adobe) {
    rgb = d.adobe_transform == 0;
  } else {
    rgb = d.comp[0].id == 82 && d.comp[1].id == 71 && d.comp[2].id == 66;
  }
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  for (int i = 0; i < 256; ++i) {
    const int64_t x = i - 128;
    cr_r[i] = (int)((FIX_1_40200 * x + kOneHalf) >> kScaleBits);
    cb_b[i] = (int)((FIX_1_77200 * x + kOneHalf) >> kScaleBits);
    cr_g[i] = -FIX_0_71414 * x;
    cb_g[i] = -FIX_0_34414 * x + kOneHalf;
  }
  std::vector<uint8_t> rows[3];
  for (int c = 0; c < 3; ++c) rows[c].resize((size_t)w + 2);
  for (int y = 0; y < h; ++y) {
    for (int c = 0; c < 3; ++c)
      upsample_row(d.comp[c], d.hmax, d.vmax, w, y, planes[c].data(),
                   d.comp[c].bw * 8, rows[c].data());
    uint8_t *o = out + (size_t)y * w * 3;
    const uint8_t *r0 = rows[0].data(), *r1 = rows[1].data(),
                  *r2 = rows[2].data();
    if (rgb) {
      for (int x = 0; x < w; ++x) {
        o[3 * x] = r2[x];
        o[3 * x + 1] = r1[x];
        o[3 * x + 2] = r0[x];
      }
      continue;
    }
    for (int x = 0; x < w; ++x) {
      const int yy = r0[x], cb = r1[x], cr = r2[x];
      o[3 * x + 2] = clamp255(yy + cr_r[cr]);
      o[3 * x + 1] = clamp255(yy + ((cb_g[cb] + cr_g[cr]) >> kScaleBits));
      o[3 * x] = clamp255(yy + cb_b[cb]);
    }
  }
  return true;
}

}  // namespace

extern "C" {

// Height, width and component count from the frame header. 0 on success.
int msm_codec_info(const uint8_t *buf, long n, int *h, int *w, int *ncomp,
                   char *err, int errcap) {
  Decoder d(buf, n);
  if (!d.parse_header()) {
    set_error(err, errcap, d.err);
    return -1;
  }
  *h = d.height;
  *w = d.width;
  *ncomp = d.ncomp;
  return 0;
}

// Decode into `out` (h*w*3 BGR, or h*w for greyscale). 0 on success.
int msm_codec_decode(const uint8_t *buf, long n, uint8_t *out, long cap,
                     char *err, int errcap) {
  Decoder d(buf, n);
  if (!decode_into(d, out, cap)) {
    set_error(err, errcap, d.err);
    return -1;
  }
  return 0;
}

// Encode a [h, w, 3] BGR image; the byte count, or minus the count needed
// where `cap` is short.
long msm_codec_encode(const uint8_t *bgr, int h, int w, int quality,
                      uint8_t *out, long cap) {
  if (h <= 0 || w <= 0 || h > 65535 || w > 65535) return 0;
  std::vector<uint8_t> o;
  o.reserve((size_t)h * w + 1024);
  const long n = encode_bgr(bgr, h, w, quality, o);
  if (n > cap) return -n;
  std::memcpy(out, o.data(), (size_t)n);
  return n;
}

}  // extern "C"
