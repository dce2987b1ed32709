// 128-bit decimal arithmetic shared by K31 (decimal128.cu), K24's decimal
// modes (str_format.cu) and K32 (seg_sum128.cu): a decimal's unscaled
// value as an unsigned __int128 in two's complement, so every add,
// negate and multiply wraps mod 2^128 as the reference's limb code
// (spark_rapids_tpu/ops/decimal128.py) does, and no signed overflow is
// ever undefined.
//
// The 128 / 64 division of the reference's divmod_u128_u64 (:120, a
// 128-step restoring loop) is divmod_u128 here: the high word by the
// hardware's 64-bit division, then the remainder and the low word in two
// 32-bit steps when the divisor is below 2^32 (the powers 10^k, k <= 9,
// and every count below 2^32), else in 64 steps of a shift-subtract loop.
// Quotient and remainder are unique, so any exact method gives the
// reference's for every divisor in (0, 2^63) it allows.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace srtpu {

typedef unsigned __int128 u128;
typedef unsigned long long u64_t;

// a [n, 2] limb row (hi, lo) or a sign-extended int64
__device__ __forceinline__ u128 load_dec(const i64* p, bool wide, i64 r) {
  if (wide) {
    const u64_t hi = (u64_t)p[2 * r], lo = (u64_t)p[2 * r + 1];
    return ((u128)hi << 64) | (u128)lo;
  }
  return (u128)(__int128)p[r];
}

__device__ __forceinline__ void store_dec(i64* p, i64 r, u128 x) {
  p[2 * r] = (i64)(u64_t)(x >> 64);
  p[2 * r + 1] = (i64)(u64_t)x;
}

__device__ __forceinline__ i64 hi_of(u128 x) { return (i64)(u64_t)(x >> 64); }
__device__ __forceinline__ i64 lo_of(u128 x) { return (i64)(u64_t)x; }
__device__ __forceinline__ bool is_neg(u128 x) { return hi_of(x) < 0; }

// |x| as an unsigned value (-2^127 stays 2^127), and its sign
__device__ __forceinline__ u128 abs_dec(u128 x, bool& neg) {
  neg = is_neg(x);
  return neg ? (u128)0 - x : x;
}

__device__ __forceinline__ u128 pow10_128(int k) {
  u128 p = 1;
  for (int i = 0; i < k; ++i) p *= 10;
  return p;
}

// x / d and x % d for a divisor d in (0, 2^63)
__device__ __forceinline__ u128 divmod_u128(u128 x, u64_t d, u64_t& rem) {
  const u64_t hi = (u64_t)(x >> 64), lo = (u64_t)x;
  const u64_t qh = hi / d;
  u64_t r = hi % d, ql = 0;
  if (d <= 0xFFFFFFFFull) {
    const u64_t n1 = (r << 32) | (lo >> 32);
    const u64_t q1 = n1 / d;
    r = n1 % d;
    const u64_t n0 = (r << 32) | (lo & 0xFFFFFFFFull);
    ql = (q1 << 32) | (n0 / d);
    r = n0 % d;
  } else {
    for (int i = 63; i >= 0; --i) {  // r < d < 2^63: r << 1 never wraps
      r = (r << 1) | ((lo >> i) & 1ull);
      ql <<= 1;
      if (r >= d) {
        r -= d;
        ql |= 1ull;
      }
    }
  }
  rem = r;
  return ((u128)qh << 64) | (u128)ql;
}

// the reference's HALF_UP step: 2 * rem >= d in int64 (it wraps as the
// reference's does)
__device__ __forceinline__ bool half_up(u64_t rem, u64_t d) {
  return (i64)(2ull * rem) >= (i64)d;
}

// rescale (the reference's :161): times 10^delta mod 2^128 for delta > 0;
// for delta < 0 |x| divided by 10^18 while more than 18 digits remain,
// then by the rest with HALF_UP, and the sign put back
__device__ __forceinline__ u128 rescale_dec(u128 x, int delta) {
  if (delta == 0) return x;
  if (delta > 0) return x * pow10_128(delta);
  int d = -delta;
  bool neg;
  u128 a = abs_dec(x, neg);
  u64_t rem;
  while (d > 18) {
    a = divmod_u128(a, 1000000000000000000ull, rem);
    d -= 18;
  }
  const u64_t p = (u64_t)pow10_128(d);
  a = divmod_u128(a, p, rem);
  a += half_up(rem, p) ? 1 : 0;
  return neg ? (u128)0 - a : a;
}

// |x| < 10^precision (the reference's fits_precision, :193)
__device__ __forceinline__ bool fits_dec(u128 x, u128 limit) {
  bool neg;
  return abs_dec(x, neg) < limit;
}

// the value fits a signed int64 (fits_i64, :202)
__device__ __forceinline__ bool fits_i64_dec(u128 x) {
  return hi_of(x) == (lo_of(x) >> 63);
}

}  // namespace srtpu
