// K22 str_parse: Spark's non-ANSI string -> boolean / integral / double /
// decimal / date / timestamp parse of each row of a string column.
//
// Replaces spark_rapids_tpu/ops/stringcast.py: parse_long (:71),
// parse_double (:180, over _parse_mantissa :106), parse_decimal (:204),
// parse_bool (:236),
// parse_date (:313) and parse_timestamp (:319), with their helpers
// _token_bounds (:34), _parse_uint_field (:249), _find_char (:266) and
// _parse_date_fields (:278). XLA compiles those as whole-matrix passes:
// one pass over every byte column per state variable, an argmax for each
// bound, a cumsum for each separator. Modes:
//   kParseLong       out int64: [+-]?digits, the magnitude accumulated
//                    negative (INT64_MIN parses), null on overflow or
//                    outside [lo, hi] (the target width);
//   kParseDouble     out float64: [+-]?digits[.digits][eE[+-]digits] with
//                    18 significant digits kept, or inf/infinity/nan in
//                    any case; the value is mag * 10^half * 10^(e - half),
//                    half = clip(e, -300, 300), in that order;
//   kParseBool       out uint8: true/t/yes/y/1 or false/f/no/n/0, any case;
//   kParseDate       out int32 days: y{1,7}[-m{1,2}[-d{1,2}]] before the
//                    first ' ' or 'T', year <= 9999, the day of month
//                    round-tripped through the calendar;
//   kParseTimestamp  out int64 wall-clock microseconds: the date, then
//                    h[h]:m[m][:s[s][.f{1,6}]] after the ' ' or 'T';
//   kParseDecimal    out int64, a decimal(p <= 18, s) (s = lo, p = hi): the
//                    double mode's mantissa (18 significant digits) shifted
//                    by 10^(exp + extra - frac + s) in exact int64, up
//                    (overflow -> null) or down with HALF_UP (below 1 ulp
//                    of 10^-18: 0), null where |value| >= 10^p; every
//                    product and quotient wraps and floors as jnp's do.
// Every mode first trims the bytes <= 0x20 at both ends (Spark's
// trimAll). out_valid = validity & the parse succeeded; out is 0 where it
// did not.
//
// Bound on the H100: bytes. Each row's bytes are read once and its value
// and validity written once: for 15M rows of width 16 with lengths,
// validity and an int64 out, about 0.45 GB, 0.13 ms at 3.35 TB/s.
//
// Design: one thread a row. The reference's per-byte state machine runs
// in registers, reading the row 8 bytes a load (RowReader); the token
// bounds, the separators and each field are short walks over the same
// cached words. A row stride of 0 (a string literal broadcast to the
// batch as a view) reads the one row for every output row, never past it.

#include <math_constants.h>

#include "calendar.cuh"
#include "strings.cuh"

namespace srtpu {

enum ParseMode { kParseLong = 0, kParseDouble = 1, kParseBool = 2,
                 kParseDate = 3, kParseTimestamp = 4, kParseDecimal = 5 };

constexpr i64 kI64Min = -9223372036854775807LL - 1;
constexpr i64 kUsPerDay = 86400000000LL;

struct Token {
  int first, last;
  bool nonempty;
};

// bounds of the trimmed token; first = 0, last = -1 when empty
__device__ __forceinline__ Token token_bounds(RowReader& row, int len) {
  Token t{0, -1, false};
  for (int i = 0; i < len; ++i) {
    if (row[i] > 0x20u) {
      t.first = i;
      t.nonempty = true;
      break;
    }
  }
  if (t.nonempty) {
    for (int i = len - 1; i >= t.first; --i) {
      if (row[i] > 0x20u) {
        t.last = i;
        break;
      }
    }
  }
  return t;
}

// the byte at idx clamped into the row, as the reference's _char_at
__device__ __forceinline__ uint32_t char_at(RowReader& row, int idx, int mb) {
  return row[idx < 0 ? 0 : (idx >= mb ? mb - 1 : idx)];
}

__device__ __forceinline__ uint32_t lower(uint32_t c) {
  return (c >= 'A' && c <= 'Z') ? c + 32 : c;
}

// the lowercased token [first, last] equals the word
__device__ __forceinline__ bool matches(RowReader& row, int first, int last,
                                        int mb, const char* word, int n) {
  if (last - first + 1 != n) return false;
  for (int i = 0; i < n; ++i)
    if (lower(char_at(row, first + i, mb)) != (uint32_t)word[i]) return false;
  return true;
}

// the position of the occ-th `b` in [lo, hi], else -1
__device__ __forceinline__ int find_char(RowReader& row, int lo, int hi,
                                         uint32_t b, int occ) {
  int k = 0;
  for (int i = lo < 0 ? 0 : lo; i <= hi; ++i)
    if (row[i] == b && ++k == occ) return i;
  return -1;
}

// a digits-only field [start, end] of 1 to max_digits digits
__device__ __forceinline__ bool parse_uint(RowReader& row, int start, int end,
                                           int max_digits, i64& val) {
  val = 0;
  const int nd = end - start + 1;
  if (nd < 1 || nd > max_digits) return false;
  for (int i = start; i <= end; ++i) {
    const uint32_t c = row[i];
    if (c < '0' || c > '9') return false;
    val = val * 10 + (i64)(c - '0');
  }
  return true;
}

__device__ __forceinline__ bool parse_long(RowReader& row, const Token& t,
                                           int mb, i64 lo, i64 hi, i64& out) {
  const uint32_t c0 = char_at(row, t.first, mb);
  const bool has_sign = c0 == '+' || c0 == '-', neg = c0 == '-';
  const int dstart = t.first + (has_sign ? 1 : 0);
  if (!t.nonempty || t.last - dstart + 1 < 1) return false;
  i64 val = 0;  // the negative magnitude
  for (int i = dstart; i <= t.last; ++i) {
    const uint32_t c = row[i];
    if (c < '0' || c > '9') return false;
    const i64 d = (i64)(c - '0');
    if (val < floordiv(kI64Min + d + 9, 10)) return false;  // overflow
    val = val * 10 - d;
  }
  if (!neg && val == kI64Min) return false;  // +9223372036854775808
  out = neg ? val : -val;
  return out >= lo && out <= hi;
}

// the shared float/decimal scan of the reference's _parse_mantissa
struct Mantissa {
  i64 mant;       // the negative magnitude, at most 18 significant digits
  int extra_int;  // integer digits past the cap
  int frac;       // fraction digits within the cap
  i64 exp;        // the exponent's value, magnitude capped at 100,000
  bool neg, syntax_ok;
  int start;      // the first byte after the sign
};

__device__ __forceinline__ Mantissa scan_mantissa(RowReader& row,
                                                  const Token& t, int mb) {
  const uint32_t c0 = char_at(row, t.first, mb);
  const bool has_sign = c0 == '+' || c0 == '-';
  Mantissa m;
  m.neg = c0 == '-';
  m.start = t.first + (has_sign ? 1 : 0);
  m.mant = 0;
  m.extra_int = 0;
  m.frac = 0;
  int mant_digits = 0;
  i64 exp_val = 0;
  bool exp_neg = false, seen_digit = false, seen_dot = false, in_exp = false,
       exp_digit = false, err = false;
  uint32_t prev = m.start > 0 ? char_at(row, m.start - 1, mb) : 0u;
  for (int i = m.start; i <= t.last; ++i) {
    const uint32_t c = row[i];
    const bool is_d = c >= '0' && c <= '9', is_dot = c == '.',
               is_e = c == 'e' || c == 'E', is_sg = c == '+' || c == '-';
    const i64 d = (i64)c - '0';
    const bool dig_m = is_d && !in_exp;
    const bool grow = dig_m && (mant_digits < 18 || m.mant == 0);
    if (grow) m.mant = m.mant * 10 - d;
    if (grow && (m.mant != 0 || d > 0 || seen_dot)) ++mant_digits;
    if (dig_m && !grow && !seen_dot) ++m.extra_int;
    if (grow && seen_dot) ++m.frac;
    seen_digit |= dig_m;
    err |= is_dot && (seen_dot || in_exp);
    seen_dot |= is_dot && !in_exp;
    err |= is_e && (in_exp || !seen_digit);
    const bool prev_is_e = i > 0 && (prev == 'e' || prev == 'E');
    err |= is_sg && !(in_exp && prev_is_e) && i != t.first;
    if (is_sg && in_exp && prev_is_e) exp_neg = c == '-';
    in_exp |= is_e;
    if (is_d && in_exp) {
      const i64 e = exp_val * 10 + d;
      exp_val = e < 100000 ? e : 100000;
      exp_digit = true;
    }
    err |= !(is_d || is_dot || is_e || is_sg);
    prev = c;
  }
  err |= in_exp && !exp_digit;
  m.syntax_ok = t.nonempty && !err && seen_digit;
  m.exp = exp_neg ? -exp_val : exp_val;
  return m;
}

__device__ __forceinline__ bool parse_double(RowReader& row, const Token& t,
                                             int mb, double& out) {
  const Mantissa m = scan_mantissa(row, t, mb);
  const bool is_inf = matches(row, m.start, t.last, mb, "infinity", 8) ||
                      matches(row, m.start, t.last, mb, "inf", 3);
  const bool is_nan = matches(row, m.start, t.last, mb, "nan", 3);
  const i64 e = m.exp + m.extra_int - m.frac;
  const double mag = (double)(-m.mant), ef = (double)e;
  const double half = fmin(fmax(ef, -300.0), 300.0);
  double v = mag * pow(10.0, half) * pow(10.0, ef - half);
  if (m.neg) v = -v;
  if (is_inf && t.nonempty) v = m.neg ? -CUDART_INF : CUDART_INF;
  if (is_nan && t.nonempty) v = __longlong_as_double(0x7ff8000000000000LL);
  out = v;
  return m.syntax_ok || ((is_inf || is_nan) && t.nonempty);
}

__device__ __forceinline__ i64 pow10_64(i64 k) {
  i64 p = 1;
  for (i64 i = 0; i < k; ++i) p *= 10;
  return p;
}

// the reference's parse_decimal over the mantissa, in its int64 steps
__device__ __forceinline__ bool parse_decimal(RowReader& row, const Token& t,
                                              int mb, int scale,
                                              int precision, i64& out) {
  const Mantissa m = scan_mantissa(row, t, mb);
  const i64 mag = -m.mant;
  const i64 shift = m.exp + m.extra_int - m.frac + scale;
  const i64 limit = pow10_64(precision < 18 ? precision : 18);
  const i64 up = shift < 0 ? 0 : (shift > 18 ? 18 : shift);
  const i64 pow_up = pow10_64(up);
  const i64 grew = wrap_mul(mag, pow_up);
  bool ovf_up = shift > 18 && mag > 0;
  ovf_up |= mag != 0 && floordiv(grew, pow_up) != mag;
  const i64 down = -shift < 0 ? 0 : (-shift > 18 ? 18 : -shift);
  const i64 pow_dn = pow10_64(down);
  i64 q = floordiv(grew, pow_dn);
  const i64 rem = wrap_add(grew, -wrap_mul(q, pow_dn));
  q += wrap_mul(2, rem) >= pow_dn ? 1 : 0;
  if (-shift > 18) q = 0;
  const i64 scaled = shift >= 0 ? grew : q;
  const i64 value = m.neg ? wrap_mul(scaled, -1) : scaled;
  const i64 mag_out = scaled < 0 ? wrap_mul(scaled, -1) : scaled;
  out = value;
  return m.syntax_ok && !ovf_up && mag_out < limit;
}

__device__ __forceinline__ bool parse_bool(RowReader& row, const Token& t,
                                           int mb, bool& out) {
  const bool is_t = matches(row, t.first, t.last, mb, "true", 4) ||
                    matches(row, t.first, t.last, mb, "t", 1) ||
                    matches(row, t.first, t.last, mb, "yes", 3) ||
                    matches(row, t.first, t.last, mb, "y", 1) ||
                    matches(row, t.first, t.last, mb, "1", 1);
  const bool is_f = matches(row, t.first, t.last, mb, "false", 5) ||
                    matches(row, t.first, t.last, mb, "f", 1) ||
                    matches(row, t.first, t.last, mb, "no", 2) ||
                    matches(row, t.first, t.last, mb, "n", 1) ||
                    matches(row, t.first, t.last, mb, "0", 1);
  out = is_t;
  return t.nonempty && (is_t || is_f);
}

// the date part of a row (before the first ' ' or 'T'): its days and
// whether it parsed; date_end is the date part's last byte
__device__ __forceinline__ bool parse_date(RowReader& row, const Token& t,
                                           int& days, int& date_end) {
  const int sp = find_char(row, t.first, t.last, ' ', 1);
  const int tt = find_char(row, t.first, t.last, 'T', 1);
  const int cut = (sp >= 0 && (tt < 0 || sp < tt)) ? sp : tt;
  date_end = cut >= 0 ? cut - 1 : t.last;
  days = 0;
  if (!t.nonempty) return false;
  const int d1 = find_char(row, t.first, date_end, '-', 1);
  const int d2 = d1 >= 0 ? find_char(row, t.first, date_end, '-', 2) : -1;
  i64 y, m = 1, d = 1;
  if (!parse_uint(row, t.first, d1 >= 0 ? d1 - 1 : date_end, 7, y))
    return false;
  if (d1 >= 0 &&
      !parse_uint(row, d1 + 1, d2 >= 0 ? d2 - 1 : date_end, 2, m))
    return false;
  if (d2 >= 0 && !parse_uint(row, d2 + 1, date_end, 2, d)) return false;
  if (m < 1 || m > 12 || d < 1 || d > 31 || y > 9999) return false;
  days = days_from_civil(y, m, d);
  int ry, rm, rd;  // the day of month must round-trip (leap years etc.)
  civil_from_days(days, ry, rm, rd);
  return ry == y && rm == m && rd == d;
}

__device__ __forceinline__ bool parse_timestamp(RowReader& row,
                                                const Token& t, i64& out) {
  int days, date_end;
  if (!parse_date(row, t, days, date_end)) return false;
  i64 micros = (i64)days * kUsPerDay;
  if (date_end < t.last) {  // a time follows the ' ' or 'T'
    const int t_start = date_end + 2;
    const int c1 = find_char(row, t_start, t.last, ':', 1);
    const int c2 = c1 >= 0 ? find_char(row, t_start, t.last, ':', 2) : -1;
    const int dot = find_char(row, t_start, t.last, '.', 1);
    i64 h, mi = 0, s = 0, f = 0;
    if (!parse_uint(row, t_start, c1 >= 0 ? c1 - 1 : t.last, 2, h))
      return false;
    if (c1 >= 0 &&
        !parse_uint(row, c1 + 1, c2 >= 0 ? c2 - 1 : t.last, 2, mi))
      return false;
    if (c2 >= 0 &&
        !parse_uint(row, c2 + 1, dot >= 0 ? dot - 1 : t.last, 2, s))
      return false;
    if (dot >= 0) {
      if (c2 < 0 || !parse_uint(row, dot + 1, t.last, 6, f)) return false;
      for (int k = t.last - dot; k < 6; ++k) f *= 10;
    }
    if (h > 23 || mi > 59 || s > 59) return false;
    micros += h * 3600000000LL + mi * 60000000LL + s * 1000000LL + f;
  }
  out = micros;
  return true;
}

__global__ void __launch_bounds__(kStrThreads)
str_parse_kernel(int mode, const uint8_t* __restrict__ data, i64 stride,
                 const int* __restrict__ lengths,
                 const uint8_t* __restrict__ validity, i64 n, int mb, i64 lo,
                 i64 hi, void* __restrict__ out,
                 uint8_t* __restrict__ out_valid) {
  const bool aligned = ((reinterpret_cast<uintptr_t>(data) | stride) & 7) == 0;
  for (i64 r = (i64)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += (i64)gridDim.x * blockDim.x) {
    RowReader row(data + r * stride, 0, mb);
    row.words = row.words && aligned;
    const Token t = token_bounds(row, row_len(lengths, r, mb));
    bool ok = validity[r] != 0;
    if (mode == kParseLong) {
      i64 v = 0;
      ok = ok && parse_long(row, t, mb, lo, hi, v);
      static_cast<i64*>(out)[r] = ok ? v : 0;
    } else if (mode == kParseDouble) {
      double v = 0.0;
      ok = ok && parse_double(row, t, mb, v);
      static_cast<double*>(out)[r] = ok ? v : 0.0;
    } else if (mode == kParseBool) {
      bool v = false;
      ok = ok && parse_bool(row, t, mb, v);
      static_cast<uint8_t*>(out)[r] = ok && v;
    } else if (mode == kParseDecimal) {
      i64 v = 0;
      ok = ok && parse_decimal(row, t, mb, (int)lo, (int)hi, v);
      static_cast<i64*>(out)[r] = ok ? v : 0;
    } else if (mode == kParseDate) {
      int days = 0, date_end;
      ok = ok && parse_date(row, t, days, date_end);
      static_cast<int*>(out)[r] = ok ? days : 0;
    } else {
      i64 v = 0;
      ok = ok && parse_timestamp(row, t, v);
      static_cast<i64*>(out)[r] = ok ? v : 0;
    }
    out_valid[r] = ok;
  }
}

}  // namespace srtpu

using namespace srtpu;

// data: n rows of mb bytes, row r at data + r * stride (stride 0: one row
// for all); lengths: [n] int32; validity: [n] bool; [lo, hi]: the
// integral mode's target range, or the decimal mode's (scale, precision);
// out: [n] of the mode's type; out_valid: [n] bool.
extern "C" int srtpu_str_parse(int mode, const void* data, long long stride,
                               const void* lengths, const void* validity,
                               long long n, int mb, long long lo,
                               long long hi, void* out, void* out_valid,
                               int sm_count, void* stream) {
  if (n < 1 || mb < 1 || stride < 0 || mode < kParseLong ||
      mode > kParseDecimal || lo > hi ||
      (mode == kParseDecimal && (lo < 0 || hi > 18)))
    return (int)cudaErrorInvalidValue;
  str_parse_kernel<<<str_blocks(n, sm_count), kStrThreads, 0,
                     (cudaStream_t)stream>>>(
      mode, (const uint8_t*)data, stride, (const int*)lengths,
      (const uint8_t*)validity, n, mb, lo, hi, out, (uint8_t*)out_valid);
  return (int)cudaGetLastError();
}
