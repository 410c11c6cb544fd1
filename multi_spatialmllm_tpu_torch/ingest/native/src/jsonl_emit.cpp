// Columnar JSONL emitter: a tiny per-row template VM.
//
// The QA engines' host-side cost is assembling per-sample JSON records
// (dict building + string formatting + json.dumps in Python, ~40us/row).
// This emitter executes a compiled "program" per row over columnar inputs
// and writes the byte stream directly, at ~1-2us/row single-threaded.
//
// Program encoding: flat int32 array of (opcode, a, b) triples.
//   OP_LIT  (0): append literals[a]                     (pre-JSON-escaped)
//   OP_STR  (1): append string_table[str_indices[a*n + row]]  (pre-escaped)
//   OP_INT  (2): append decimal of int_cols[a*n + row]
//   OP_FLT  (3): append repr-exact shortest float of float_cols[a*n+row]
//   OP_SEL  (4): sel = int_cols[a*n + row]; run subprogram
//                (sub_offsets[b + sel], sub_lengths[b + sel])   [recurses]
// The main program is (main_offset, main_length) in the same array.
// Rows are emitted in row_order (shuffle permutation), one line each.

#include <algorithm>
#include <atomic>
#include <cinttypes>
#include <thread>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include "ryu_tables.h"

namespace {

enum Op { OP_LIT = 0, OP_STR = 1, OP_INT = 2, OP_FLT = 3, OP_SEL = 4 };

// Two-digit pair table + branchy i64toa: ~6x snprintf("%" PRId64) —
// OP_INT runs ~20x per record, so this is on the per-row hot path.
struct DigitPairs {
  char s[200];
  constexpr DigitPairs() : s{} {
    for (int i = 0; i < 100; ++i) {
      s[2 * i] = (char)('0' + i / 10);
      s[2 * i + 1] = (char)('0' + i % 10);
    }
  }
};
constexpr DigitPairs kPairs;

inline int i64toa(int64_t v, char* out) {
  char* w = out;
  uint64_t u = (uint64_t)v;
  if (v < 0) {
    *w++ = '-';
    u = ~u + 1;  // two's complement: correct for INT64_MIN too
  }
  char tmp[20];
  int n = 0;
  while (u >= 100) {
    const unsigned d = (unsigned)(u % 100) * 2;
    u /= 100;
    tmp[n++] = kPairs.s[d + 1];
    tmp[n++] = kPairs.s[d];
  }
  if (u >= 10) {
    const unsigned d = (unsigned)u * 2;
    tmp[n++] = kPairs.s[d + 1];
    tmp[n++] = kPairs.s[d];
  } else {
    tmp[n++] = (char)('0' + (unsigned)u);
  }
  while (n) *w++ = tmp[--n];
  return (int)(w - out);
}

// Whether SOME D-digit decimal round-trips v — not necessarily the
// correctly-rounded one: near asymmetric binary intervals (power-of-2
// mantissas) a D-digit string one ulp-of-last-digit away from the
// nearest can round-trip where the nearest does not. CPython's repr
// (dtoa mode 0) prints the shortest round-tripping string, so the
// oracle must consider the neighbors too. On success writes the
// winning "d.ddd...eSXX"-shaped string into buf.
inline bool any_roundtrips(double v, int D, char* buf, size_t cap) {
  snprintf(buf, cap, "%.*e", D - 1, v);
  double back = strtod(buf, nullptr);
  if (back == v) return true;
  // Try the last-digit neighbor on v's side: digits as an integer +-1.
  char* e = strchr(buf, 'e');
  if (!e) return false;
  uint64_t mant = 0;
  for (char* p = buf; p < e; ++p)
    if (*p >= '0' && *p <= '9') mant = mant * 10 + (uint64_t)(*p - '0');
  const bool up = back < v;
  mant += up ? 1 : (uint64_t)-1;  // toward v
  // Rebuild (a +1 carry past 10^D bumps the exponent; a -1 below
  // 10^(D-1) crosses into the decade below, where the true D-digit
  // neighbor is 10^D-1 at exp10-1 — zero-padding mant back to D digits
  // would test the WRONG value 10^(D-1)-1 * 10 at the same exponent,
  // i.e. a (D-1)-digit string, overstating the shortest digit count on
  // decade-boundary values).
  uint64_t limit = 1;
  for (int i = 0; i < D; ++i) limit *= 10;
  int exp10 = atoi(e + 1);
  if (mant >= limit) {
    mant /= 10;
    ++exp10;
  } else if (!up && mant < limit / 10) {
    mant = limit - 1;
    --exp10;
  }
  char mbuf[24];
  int n = 0;
  while (mant) {
    mbuf[n++] = (char)('0' + (uint32_t)(mant % 10));
    mant /= 10;
  }
  while (n < D) mbuf[n++] = '0';
  char* w = buf;
  *w++ = mbuf[--n];
  if (n) {
    *w++ = '.';
    while (n) *w++ = mbuf[--n];
  }
  w += snprintf(w, 8, "e%+03d", exp10);
  return strtod(buf, nullptr) == v;
}

// Shortest round-trip digits via snprintf probing (~2us/value). Kept as
// the in-process oracle for the Ryu fast path below (the fuzz tests
// compare the two byte-for-byte over >=1e8 values); not on the hot path.
// Returns ndig; *exp10_out = decimal exponent of the FIRST digit.
int probe_digits(double v, char* digits, int* exp10_out) {
  char ebuf[40];
  int D = 17;
  if (any_roundtrips(v, 16, ebuf, sizeof(ebuf))) {
    if (any_roundtrips(v, 15, ebuf, sizeof(ebuf))) {
      int lo = 1, hi = 14;
      D = 15;
      while (lo <= hi) {  // monotone: if D digits round-trip, D+1 do too
        int mid = (lo + hi) / 2;
        if (any_roundtrips(v, mid, ebuf, sizeof(ebuf))) {
          D = mid;
          hi = mid - 1;
        } else {
          lo = mid + 1;
        }
      }
    } else {
      D = 16;
    }
  }
  any_roundtrips(v, D, ebuf, sizeof(ebuf));  // leaves the winner in ebuf

  // Parse d[.ddd]e(+|-)XX into digit string + exponent (v > 0 here).
  const char* s = ebuf;
  int ndig = 0;
  digits[ndig++] = *s++;
  if (*s == '.') {
    ++s;
    while (*s != 'e' && *s != 'E') digits[ndig++] = *s++;
  }
  *exp10_out = atoi(strchr(s, 'e') ? strchr(s, 'e') + 1 : s + 1);
  while (ndig > 1 && digits[ndig - 1] == '0') --ndig;  // shortest digits
  return ndig;
}

// ---- Ryu shortest-float digit generation (Adams, PLDI 2018) --------
//
// ~60ns/value vs the ~2us probing path: the QA engines' record emission
// is float-formatting bound (10+ reals per record), so this is the
// single hottest host-side routine in the data-engine pipeline.
// Produces THE shortest correctly-rounded digit string (identical to
// CPython repr's dtoa mode 0); byte-parity with probe_digits is
// fuzz-asserted over 1e8+ random bit patterns plus structured families
// (tests/test_fast_jsonl.py + scripts/fuzz_ryu.cpp).

inline int pow5bits_i(int e) {           // bitlength of 5^e, 0<=e<=3528
  return (int)(((uint32_t)e * 1217359) >> 19) + 1;
}
inline uint32_t log10Pow2(int e) {       // floor(e*log10 2), 0<=e<=1650
  return ((uint32_t)e * 78913) >> 18;
}
inline uint32_t log10Pow5(int e) {       // floor(e*log10 5), 0<=e<=2620
  return ((uint32_t)e * 732923) >> 20;
}
inline bool multipleOfPow5(uint64_t value, uint32_t p) {
  while (p--) {
    if (value % 5) return false;
    value /= 5;
  }
  return true;
}
inline bool multipleOfPow2(uint64_t value, uint32_t p) {
  return (value & ((1ull << p) - 1)) == 0;
}
// floor(m * mul / 2^j) for the 125-bit table entries; 64 < j < 128.
inline uint64_t mulShift64(uint64_t m, const uint64_t* mul, int j) {
  __uint128_t b0 = (__uint128_t)m * mul[0];
  __uint128_t b2 = (__uint128_t)m * mul[1];
  return (uint64_t)(((b0 >> 64) + b2) >> (j - 64));
}

// Shortest round-trip decimal digits of finite positive non-integral v.
// Returns ndig (<= 17, no trailing zeros); *exp10_out = decimal
// exponent of the FIRST digit (value = d.ddd * 10^exp10).
int ryu_digits(double v, char* digits, int* exp10_out) {
  uint64_t bits;
  memcpy(&bits, &v, 8);
  const uint64_t ieee_m = bits & ((1ull << 52) - 1);
  const uint32_t ieee_e = (uint32_t)(bits >> 52) & 0x7ff;
  uint64_t m2;
  int e2;
  if (ieee_e == 0) {  // subnormal
    m2 = ieee_m;
    e2 = 1 - 1023 - 52 - 2;
  } else {
    m2 = (1ull << 52) | ieee_m;
    e2 = (int)ieee_e - 1023 - 52 - 2;
  }
  const bool accept = (m2 & 1) == 0;  // even mantissa owns the boundary

  // Halfway interval scaled by 4: upper bound mv+2 (half ulp), lower
  // mv-2, or mv-1 at power-of-2 boundaries where the gap below halves.
  const uint64_t mv = 4 * m2;
  const uint32_t mmShift = (ieee_m != 0 || ieee_e <= 1) ? 1 : 0;
  const uint64_t mm = mv - 1 - mmShift;
  const uint64_t mp = mv + 2;

  uint64_t vr, vp, vm;
  int e10;
  bool vmTZ = false, vrTZ = false;
  if (e2 >= 0) {
    // value * 10^-q = m * 2^(e2-q) / 5^q via the rounded-up inverse
    const uint32_t q = log10Pow2(e2) - (e2 > 3);
    e10 = (int)q;
    const int k = RYU_POW5_INV_BITCOUNT + pow5bits_i((int)q) - 1;
    const int j = -e2 + (int)q + k;
    vr = mulShift64(mv, RYU_POW5_INV_SPLIT[q], j);
    vp = mulShift64(mp, RYU_POW5_INV_SPLIT[q], j);
    vm = mulShift64(mm, RYU_POW5_INV_SPLIT[q], j);
    if (q <= 21) {  // 5^22 > 2^53: beyond q=21 nothing divides
      if (mv % 5 == 0) {
        vrTZ = multipleOfPow5(mv, q);
      } else if (accept) {
        vmTZ = multipleOfPow5(mm, q);
      } else {
        vp -= multipleOfPow5(mp, q);  // exact open upper bound excluded
      }
    }
  } else {
    // value * 10^-q-e2 = m * 5^i / 2^q, i = -e2-q (truncated table)
    const uint32_t q = log10Pow5(-e2) - (-e2 > 1);
    e10 = (int)q + e2;
    const int i = -e2 - (int)q;
    const int k = pow5bits_i(i) - RYU_POW5_BITCOUNT;
    const int j = (int)q - k;
    vr = mulShift64(mv, RYU_POW5_SPLIT[i], j);
    vp = mulShift64(mp, RYU_POW5_SPLIT[i], j);
    vm = mulShift64(mm, RYU_POW5_SPLIT[i], j);
    if (q <= 1) {
      vrTZ = true;  // mv = 4*m2 has >= 1 trailing zero bit
      if (accept) {
        vmTZ = mmShift == 1;  // mm = mv-2 even; mv-1 odd
      } else {
        --vp;  // mp = mv+2 is exact: open upper bound excluded
      }
    } else if (q < 63) {
      vrTZ = multipleOfPow2(mv, q);  // 5^i odd: exact iff 2^q | mv
    }
  }

  // Shorten while the whole interval still agrees on the digits.
  int removed = 0;
  uint8_t lastRemoved = 0;
  uint64_t output;
  if (vmTZ || vrTZ) {  // general path: trailing-zero bookkeeping
    for (;;) {
      const uint64_t vpDiv10 = vp / 10, vmDiv10 = vm / 10;
      if (vpDiv10 <= vmDiv10) break;
      const uint32_t vmMod10 = (uint32_t)(vm % 10);
      const uint64_t vrDiv10 = vr / 10;
      const uint32_t vrMod10 = (uint32_t)(vr % 10);
      vmTZ &= vmMod10 == 0;
      vrTZ &= lastRemoved == 0;
      lastRemoved = (uint8_t)vrMod10;
      vr = vrDiv10;
      vp = vpDiv10;
      vm = vmDiv10;
      ++removed;
    }
    if (vmTZ) {  // lower bound exact: may shorten onto it
      for (;;) {
        const uint64_t vmDiv10 = vm / 10;
        if ((uint32_t)(vm % 10) != 0) break;
        const uint64_t vpDiv10 = vp / 10, vrDiv10 = vr / 10;
        const uint32_t vrMod10 = (uint32_t)(vr % 10);
        vrTZ &= lastRemoved == 0;
        lastRemoved = (uint8_t)vrMod10;
        vr = vrDiv10;
        vp = vpDiv10;
        vm = vmDiv10;
        ++removed;
      }
    }
    if (vrTZ && lastRemoved == 5 && vr % 2 == 0) {
      lastRemoved = 4;  // exact tie: round half to even
    }
    output = vr + ((vr == vm && (!accept || !vmTZ)) || lastRemoved >= 5);
  } else {  // common path: no exactness anywhere
    bool roundUp = false;
    for (;;) {
      const uint64_t vpDiv10 = vp / 10, vmDiv10 = vm / 10;
      if (vpDiv10 <= vmDiv10) break;
      roundUp = (vr % 10) >= 5;
      vr /= 10;
      vp = vpDiv10;
      vm = vmDiv10;
      ++removed;
    }
    output = vr + (vr == vm || roundUp);
  }
  const int exp_base = e10 + removed;  // value = output * 10^exp_base

  // Digits of output; strip trailing zeros (a +1 carry can mint a
  // power of 10, and CPython repr never prints trailing zeros).
  char tmp[24];
  int n = 0;
  while (output) {
    tmp[n++] = (char)('0' + (uint32_t)(output % 10));
    output /= 10;
  }
  int strip = 0;
  while (strip < n - 1 && tmp[strip] == '0') ++strip;
  const int ndig = n - strip;
  for (int d = 0; d < ndig; ++d) digits[d] = tmp[n - 1 - d];
  *exp10_out = exp_base + strip + (ndig - 1);
  return ndig;
}

// Format v exactly as CPython repr(float) / json.dumps: the shortest
// decimal digit string that round-trips, fixed notation when the decimal
// point lands in (-4, 16], else exponential with a signed >=2-digit
// exponent. Returns the length written to out (capacity >= 40).
// `probe` routes digit generation through the snprintf oracle instead of
// Ryu (fuzz tests only).
int format_double_pyrepr_impl(double v, char* out, bool probe) {
  if (v != v) return snprintf(out, 8, "NaN");            // json.dumps spelling
  if (v > 1.7976931348623157e308) return snprintf(out, 12, "Infinity");
  if (v < -1.7976931348623157e308) return snprintf(out, 12, "-Infinity");

  // Integral fast path: every exact integral double in (-1e16, 1e16)
  // reprs as "<int>.0" (fixed notation reconstructs the integer from the
  // shortest digit string by zero-padding, so the strings coincide).
  if (v > -1e16 && v < 1e16 && v == (double)(int64_t)v) {
    int64_t iv = (int64_t)v;
    if (iv == 0) {
      const char* z = (1.0 / v < 0) ? "-0.0" : "0.0";  // signed zero
      size_t n = strlen(z);
      memcpy(out, z, n);
      return (int)n;
    }
    int len = i64toa(iv, out);
    out[len++] = '.';
    out[len++] = '0';
    return len;
  }

  const bool neg = v < 0;
  const double a = neg ? -v : v;
  char digits[20];
  int exp10;
  const int ndig = probe ? probe_digits(a, digits, &exp10)
                         : ryu_digits(a, digits, &exp10);

  char* w = out;
  if (neg) *w++ = '-';
  if (exp10 >= -4 && exp10 <= 15) {  // fixed: CPython threshold
    int dp = exp10 + 1;  // decimal point position in the digit string
    if (dp <= 0) {
      *w++ = '0'; *w++ = '.';
      for (int i = 0; i < -dp; ++i) *w++ = '0';
      memcpy(w, digits, ndig); w += ndig;
    } else if (dp >= ndig) {
      memcpy(w, digits, ndig); w += ndig;
      for (int i = 0; i < dp - ndig; ++i) *w++ = '0';
      *w++ = '.'; *w++ = '0';
    } else {
      memcpy(w, digits, dp); w += dp;
      *w++ = '.';
      memcpy(w, digits + dp, ndig - dp); w += ndig - dp;
    }
  } else {  // exponential: 1.5e-05 / 1e+16 style
    *w++ = digits[0];
    if (ndig > 1) {
      *w++ = '.';
      memcpy(w, digits + 1, ndig - 1); w += ndig - 1;
    }
    *w++ = 'e';
    *w++ = exp10 < 0 ? '-' : '+';
    int ae = exp10 < 0 ? -exp10 : exp10;
    char eb[8];
    int el = snprintf(eb, sizeof(eb), "%02d", ae);
    memcpy(w, eb, el); w += el;
  }
  return (int)(w - out);
}

inline int format_double_pyrepr(double v, char* out) {
  return format_double_pyrepr_impl(v, out, /*probe=*/false);
}

struct Ctx {
  const char* const* literals;
  const char* const* string_table;
  const int64_t* str_indices;
  const int64_t* int_cols;
  const double* float_cols;
  const int32_t* program;
  const int64_t* sub_offsets;
  const int64_t* sub_lengths;
  int64_t n_rows;
  // Precomputed lengths: append(const char*) would strlen every
  // literal/table string on EVERY row (init_lengths fills these once).
  std::vector<size_t> lit_len;
  std::vector<size_t> str_len;
};

// Scan the whole flat program (subprograms precede main, so
// main_offset+main_length is the total op count) for the literal ids
// and string columns actually used, then cache every strlen once.
void init_lengths(Ctx* ctx, int64_t main_offset, int64_t main_length) {
  const int64_t prog_end = main_offset + main_length;
  int max_lit = -1;
  std::vector<int> str_cols;
  for (int64_t i = 0; i < prog_end; ++i) {
    const int32_t op = ctx->program[i * 3], a = ctx->program[i * 3 + 1];
    if (op == OP_LIT && a > max_lit) max_lit = a;
    if (op == OP_STR) str_cols.push_back(a);
  }
  ctx->lit_len.resize(max_lit + 1);
  for (int i = 0; i <= max_lit; ++i)
    ctx->lit_len[i] = strlen(ctx->literals[i]);

  std::sort(str_cols.begin(), str_cols.end());
  str_cols.erase(std::unique(str_cols.begin(), str_cols.end()),
                 str_cols.end());
  int64_t max_idx = -1;
  for (int a : str_cols) {
    const int64_t* col = ctx->str_indices + (int64_t)a * ctx->n_rows;
    for (int64_t r = 0; r < ctx->n_rows; ++r)
      if (col[r] > max_idx) max_idx = col[r];
  }
  ctx->str_len.resize(max_idx + 1);
  for (int64_t i = 0; i <= max_idx; ++i)
    ctx->str_len[i] = strlen(ctx->string_table[i]);
}

void run(const Ctx& ctx, int64_t offset, int64_t length, int64_t row,
         std::string* out) {
  const int32_t* ops = ctx.program + offset * 3;
  for (int64_t i = 0; i < length; ++i) {
    int32_t op = ops[i * 3], a = ops[i * 3 + 1], b = ops[i * 3 + 2];
    switch (op) {
      case OP_LIT:
        out->append(ctx.literals[a], ctx.lit_len[a]);
        break;
      case OP_STR: {
        const int64_t idx = ctx.str_indices[(int64_t)a * ctx.n_rows + row];
        out->append(ctx.string_table[idx], ctx.str_len[idx]);
        break;
      }
      case OP_INT: {
        char buf[24];
        int len = i64toa(ctx.int_cols[(int64_t)a * ctx.n_rows + row], buf);
        out->append(buf, len);
        break;
      }
      case OP_FLT: {
        char buf[40];
        double v = ctx.float_cols[(int64_t)a * ctx.n_rows + row];
        int len = format_double_pyrepr(v, buf);
        out->append(buf, len);
        break;
      }
      case OP_SEL: {
        int64_t sel = ctx.int_cols[(int64_t)a * ctx.n_rows + row];
        run(ctx, ctx.sub_offsets[b + sel], ctx.sub_lengths[b + sel], row,
            out);
        break;
      }
      default:
        break;
    }
  }
}

}  // namespace

// Multithreaded emitter: rows render in parallel (they are independent),
// output bytes stay in row_order (each thread fills one slice of a wave;
// waves are written sequentially), so the file is byte-identical to the
// single-threaded path for any thread count. Waves bound buffering to
// n_threads * wave_rows lines.
extern "C" int msm_emit_jsonl_mt(
    const char* out_path, int64_t n_rows, int64_t n_out,
    const char* const* literals,
    const char* const* string_table, const int64_t* str_indices,
    const int64_t* int_cols, const double* float_cols,
    const int32_t* program, const int64_t* sub_offsets,
    const int64_t* sub_lengths, int64_t main_offset, int64_t main_length,
    const int64_t* row_order, int32_t n_threads) {
  if (n_threads < 1) n_threads = 1;
  FILE* f = fopen(out_path, "wb");
  if (!f) return -1;
  std::vector<char> iobuf(1 << 20);
  setvbuf(f, iobuf.data(), _IOFBF, iobuf.size());

  Ctx ctx{literals,  string_table, str_indices, int_cols,
          float_cols, program,     sub_offsets, sub_lengths, n_rows};
  init_lengths(&ctx, main_offset, main_length);
  const int64_t slice = 8192;  // rows per thread per wave
  const int64_t wave = slice * n_threads;
  std::vector<std::string> bufs(n_threads);
  std::atomic<int> bad{0};

  for (int64_t lo = 0; lo < n_out; lo += wave) {
    int64_t hi = lo + wave < n_out ? lo + wave : n_out;
    auto render = [&](int t) {
      int64_t a = lo + (int64_t)t * slice;
      int64_t b = a + slice < hi ? a + slice : hi;
      std::string& out = bufs[t];
      out.clear();
      for (int64_t i = a; i < b; ++i) {
        int64_t row = row_order ? row_order[i] : i;
        if (row < 0 || row >= n_rows) {
          bad.store(1);
          return;
        }
        run(ctx, main_offset, main_length, row, &out);
        out.push_back('\n');
      }
    };
    if (n_threads == 1) {
      render(0);
    } else {
      std::vector<std::thread> threads;
      for (int t = 0; t < n_threads; ++t) threads.emplace_back(render, t);
      for (auto& th : threads) th.join();
    }
    if (bad.load()) {
      fclose(f);
      return -3;
    }
    for (int t = 0; t < n_threads; ++t) {
      if (!bufs[t].empty() &&
          fwrite(bufs[t].data(), 1, bufs[t].size(), f) != bufs[t].size()) {
        fclose(f);
        return -2;
      }
    }
  }
  fclose(f);
  return 0;
}

// n_rows: column stride (rows in the column arrays).
// n_out: number of lines to write; row_order (length n_out, may be a
// subsampled permutation) selects which rows, identity when null.
extern "C" int msm_emit_jsonl(
    const char* out_path, int64_t n_rows, int64_t n_out,
    const char* const* literals,
    const char* const* string_table, const int64_t* str_indices,
    const int64_t* int_cols, const double* float_cols,
    const int32_t* program, const int64_t* sub_offsets,
    const int64_t* sub_lengths, int64_t main_offset, int64_t main_length,
    const int64_t* row_order) {
  FILE* f = fopen(out_path, "wb");
  if (!f) return -1;
  std::vector<char> iobuf(1 << 20);
  setvbuf(f, iobuf.data(), _IOFBF, iobuf.size());

  Ctx ctx{literals,  string_table, str_indices, int_cols,
          float_cols, program,     sub_offsets, sub_lengths, n_rows};
  init_lengths(&ctx, main_offset, main_length);
  std::string line;
  line.reserve(4096);
  for (int64_t i = 0; i < n_out; ++i) {
    int64_t row = row_order ? row_order[i] : i;
    if (row < 0 || row >= n_rows) {
      fclose(f);
      return -3;
    }
    line.clear();
    run(ctx, main_offset, main_length, row, &line);
    line.push_back('\n');
    if (fwrite(line.data(), 1, line.size(), f) != line.size()) {
      fclose(f);
      return -2;
    }
  }
  fclose(f);
  return 0;
}

// Direct float-formatting entry points for the fuzz/parity tests
// (tests/test_fast_jsonl.py): `msm_format_double` is the production Ryu
// path, `msm_format_double_slow` the snprintf-probing oracle. Both
// return the length written (out capacity >= 40).
extern "C" int msm_format_double(double v, char* out) {
  return format_double_pyrepr_impl(v, out, /*probe=*/false);
}

extern "C" int msm_format_double_slow(double v, char* out) {
  return format_double_pyrepr_impl(v, out, /*probe=*/true);
}
