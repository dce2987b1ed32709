// K24 str_format: the text of an integral, date, timestamp or decimal
// column into a zero-padded byte matrix plus lengths, and Hex's text of a
// long.
//
// Replaces spark_rapids_tpu/expr/cast.py _int_to_string (:284),
// _date_to_string (:323) and _timestamp_to_string (:349), and the
// emission of spark_rapids_tpu/expr/datetimes.py DateFormat.eval
// (:633-671, which FromUnixtime :674 reuses): XLA compiles each as one
// pass per output byte column (a digit's // and % of a field, or a
// gather from a 20-digit matrix), and spark_rapids_tpu/expr/mathexpr.py
// Hex.eval (:457: 16 shifted nibble columns, an argmax for the first
// nonzero one and a gather), and the decimal text of
// spark_rapids_tpu/expr/cast.py _decimal_to_string (:407) and
// spark_rapids_tpu/ops/decimal128.py decimal_string (:257: five 128-step
// divisions by 10^9, then 45 passes a digit over the [n, 48] matrix).
// Modes:
//   kFmtInt        int64 -> decimal text, INT64_MIN included; width 32;
//   kFmtDate       int32 days -> 'YYYY-MM-DD'; width 16, length 10;
//   kFmtTimestamp  int64 local microseconds -> 'YYYY-MM-DD HH:MM:SS' and,
//                  where the fraction is not 0, '.' and its 6 digits with
//                  the trailing zeros trimmed; width 32;
//   kFmtPattern    int32 days or int64 local microseconds -> DateFormat's
//                  token list, given as one int32 code an output byte: the
//                  byte itself (>= 0), or -(1 + field * 8 + place) for the
//                  digit of 10^place of field year, month, day, hour,
//                  minute, second or millisecond (0-6); the width is the
//                  caller's (max(8, the next power of two of the length));
//   kFmtHex        int64 -> its two's complement bits as uppercase hex
//                  digits from the first nonzero nibble ("0" for 0, 16
//                  digits for a negative); width 16;
//   kFmtDecimal    a decimal(<= 18)'s int64 at scale s = ncodes > 0 ->
//                  the reference's whole = sign(x) * (|x| // 10^s) as
//                  kFmtInt prints it ('-' first when whole is 0 and x < 0),
//                  '.', then the s digits of |x| % 10^s; |x|, // and %
//                  wrap and floor as jnp's do; width 48;
//   kFmtDecimal128 a [n, 2] limb row at scale s = ncodes in [0, 18] ->
//                  '-' for a negative, the digits of |x| // 10^s (at least
//                  one), and for s > 0 '.' and the s digits of |x| % 10^s;
//                  width 48.
// The calendar fields come from calendar.cuh, flooring as the reference
// does; each digit is floor(x / 10^p) mod 10, flooring too, so a year
// outside 0-9,999 prints as the reference's digit() prints it (4 digits
// of its floor, e.g. -1 as 9999), not as Spark would.
//
// Bound on the H100: bytes. Each value is read once and each row's
// bytes and length written once: 'yyyy-MM' over 15M dates (int32 in, 8
// bytes and a length out) is 240 MB, 0.07 ms at 3.35 TB/s; cast(date as
// string) 360 MB, 0.11 ms; hex of 15M longs (8 bytes in, 16 bytes and a
// length out) 420 MB, 0.13 ms.
//
// Design: one thread a row; the fields are computed in registers and the
// row written 8 bytes a store (RowWriter), its tail zeroed.

#include "calendar.cuh"
#include "decimal128.cuh"
#include "strings.cuh"

namespace srtpu {

enum FormatMode { kFmtInt = 0, kFmtDate = 1, kFmtTimestamp = 2,
                  kFmtPattern = 3, kFmtHex = 4, kFmtDecimal = 5,
                  kFmtDecimal128 = 6 };

constexpr i64 kDayUs = 86400000000LL;

__device__ __forceinline__ uint32_t digit_at(i64 x, int place) {
  i64 p = 1;
  for (int k = 0; k < place; ++k) p *= 10;
  return (uint32_t)(floormod(floordiv(x, p), 10) + '0');
}

__device__ __forceinline__ void put_field(RowWriter& w, i64 x, int digits) {
  for (int p = digits - 1; p >= 0; --p) w.put(digit_at(x, p));
}

// an int64 in decimal, INT64_MIN included
__device__ __forceinline__ void put_int(RowWriter& w, i64 v) {
  const bool neg = v < 0;
  unsigned long long u = neg ? (unsigned long long)(-(v + 1)) + 1ULL
                             : (unsigned long long)v;
  char buf[20];
  int nd = 0;
  do {
    buf[nd++] = (char)('0' + u % 10);
    u /= 10;
  } while (u != 0);
  if (neg) w.put('-');
  while (nd > 0) w.put((uint32_t)buf[--nd]);
}

// a [n, 2] limb value at scale s <= 18: sign, whole digits, '.', fraction
__device__ __forceinline__ void put_decimal128(RowWriter& w, u128 x, int s) {
  bool neg;
  u128 a = abs_dec(x, neg);
  char buf[45];  // five chunks of 9 digits, least significant first
  int sig = 1;
  for (int c = 0; c < 5; ++c) {
    u64_t rem;
    a = divmod_u128(a, 1000000000ull, rem);
    for (int k = 0; k < 9; ++k) {
      const int d = (int)(rem % 10);
      rem /= 10;
      buf[c * 9 + k] = (char)('0' + d);
      if (d != 0) sig = c * 9 + k + 1;
    }
  }
  const int ndig = sig > s + 1 ? sig : s + 1;
  if (neg) w.put('-');
  for (int i = ndig - 1; i >= 0; --i) {
    w.put((uint32_t)buf[i]);
    if (i == s && s > 0) w.put('.');
  }
}

// days -> 'YYYY-MM-DD'
__device__ __forceinline__ void put_date(RowWriter& w, i64 days) {
  int y, m, d;
  civil_from_days(days, y, m, d);
  put_field(w, y, 4);
  w.put('-');
  put_field(w, m, 2);
  w.put('-');
  put_field(w, d, 2);
}

// (floor days, microseconds into the day) of an instant; wraps as the
// reference's int64 arithmetic does at the ends of the range
__device__ __forceinline__ i64 split_day(i64 us, i64& in_day) {
  const i64 days = floordiv(us, kDayUs);
  in_day = wrap_add(us, -wrap_mul(days, kDayUs));
  return days;
}

__global__ void __launch_bounds__(kStrThreads)
str_format_kernel(int mode, const void* __restrict__ in, int days_input,
                  i64 n, const int* __restrict__ codes, int ncodes,
                  uint8_t* __restrict__ out, int mb,
                  int* __restrict__ lengths) {
  for (i64 r = (i64)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += (i64)gridDim.x * blockDim.x) {
    RowWriter w(out, r, mb);
    if (mode == kFmtDecimal128) {
      put_decimal128(w, load_dec(static_cast<const i64*>(in), true, r),
                     ncodes);
      lengths[r] = w.finish();
      continue;
    }
    const i64 v = days_input ? (i64) static_cast<const int*>(in)[r]
                             : static_cast<const i64*>(in)[r];
    if (mode == kFmtInt) {
      put_int(w, v);
    } else if (mode == kFmtDecimal) {
      i64 f = 1;
      for (int k = 0; k < ncodes; ++k) f *= 10;
      const i64 mag = v < 0 ? wrap_mul(v, -1) : v;  // jnp.abs wraps
      const i64 sgn = v > 0 ? 1 : (v < 0 ? -1 : 0);
      const i64 whole = wrap_mul(sgn, floordiv(mag, f));
      const i64 frac = floormod(mag, f);
      if (whole == 0 && v < 0) w.put('-');
      put_int(w, whole);
      w.put('.');
      put_field(w, frac, ncodes);
    } else if (mode == kFmtHex) {
      const unsigned long long u = (unsigned long long)v;
      const int nd = u == 0 ? 1 : (67 - __clzll((long long)u)) >> 2;
      for (int p = nd - 1; p >= 0; --p) {
        const uint32_t d = (uint32_t)(u >> (4 * p)) & 0xFu;
        w.put(d < 10 ? '0' + d : 'A' + (d - 10));
      }
    } else if (mode == kFmtDate) {
      put_date(w, v);
    } else if (mode == kFmtTimestamp) {
      i64 in_day;
      put_date(w, split_day(v, in_day));
      w.put(' ');
      put_field(w, in_day / 3600000000LL, 2);
      w.put(':');
      put_field(w, (in_day / 60000000LL) % 60, 2);
      w.put(':');
      put_field(w, (in_day / 1000000LL) % 60, 2);
      i64 frac = in_day % 1000000LL;
      if (frac > 0) {
        int nd = 6;
        while (frac % 10 == 0) {
          frac /= 10;
          --nd;
        }
        w.put('.');
        put_field(w, frac, nd);
      }
    } else {
      i64 in_day;
      const i64 us = days_input ? wrap_mul(v, kDayUs) : v;
      int y, m, d;
      civil_from_days(split_day(us, in_day), y, m, d);
      const i64 fields[7] = {y, m, d, in_day / 3600000000LL,
                             (in_day / 60000000LL) % 60,
                             (in_day / 1000000LL) % 60,
                             (in_day / 1000LL) % 1000};
      for (int k = 0; k < ncodes; ++k) {
        const int c = __ldg(codes + k);
        if (c >= 0) {
          w.put((uint32_t)c);
        } else {
          const int f = (-c - 1) >> 3, place = (-c - 1) & 7;
          w.put(digit_at(fields[f], place));
        }
      }
    }
    lengths[r] = w.finish();
  }
}

}  // namespace srtpu

using namespace srtpu;

// in: [n] int32 days (days_input), [n] int64, or [n, 2] int64 limbs
// (kFmtDecimal128); codes: [ncodes] int32 on the device (kFmtPattern
// only), and for the decimal modes codes is null and ncodes the scale;
// out: [n, mb] uint8; lengths: [n] int32.
extern "C" int srtpu_str_format(int mode, const void* in, int days_input,
                                long long n, const void* codes, int ncodes,
                                void* out, int mb, void* lengths,
                                int sm_count, void* stream) {
  const bool dec = mode == kFmtDecimal || mode == kFmtDecimal128;
  if (n < 1 || mb < 1 || mode < kFmtInt || mode > kFmtDecimal128 ||
      (mode == kFmtDate && !days_input) ||
      ((mode == kFmtInt || mode == kFmtTimestamp || mode == kFmtHex || dec) &&
       days_input) ||
      (mode == kFmtHex && mb < 16) ||
      (dec && (codes != nullptr || mb < 48 || ncodes > 18 ||
               ncodes < (mode == kFmtDecimal ? 1 : 0))) ||
      (mode == kFmtPattern && (codes == nullptr || ncodes < 1 ||
                               ncodes > mb)))
    return (int)cudaErrorInvalidValue;
  str_format_kernel<<<str_blocks(n, sm_count), kStrThreads, 0,
                      (cudaStream_t)stream>>>(
      mode, in, days_input, n, (const int*)codes, ncodes, (uint8_t*)out, mb,
      (int*)lengths);
  return (int)cudaGetLastError();
}
