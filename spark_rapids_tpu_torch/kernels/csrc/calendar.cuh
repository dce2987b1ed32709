// Calendar arithmetic of K22 (str_parse) and K24 (str_format): Howard
// Hinnant's civil-from-days and days-from-civil exactly as
// spark_rapids_tpu/expr/datetimes.py:47 and :63 compute them, with every
// division and remainder flooring as jnp's // and % do (C++'s truncate),
// including the reference's floor of the already-shifted era for days
// before 0000-03-01, and its int32 results.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace srtpu {

__device__ __forceinline__ i64 floordiv(i64 a, i64 b) {
  const i64 q = a / b;
  return ((a % b) != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __forceinline__ i64 floormod(i64 a, i64 b) {
  const i64 r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}

// two's-complement wrap-around, as XLA's and torch's int64 arithmetic
__device__ __forceinline__ i64 wrap_mul(i64 a, i64 b) {
  return (i64)((unsigned long long)a * (unsigned long long)b);
}

__device__ __forceinline__ i64 wrap_add(i64 a, i64 b) {
  return (i64)((unsigned long long)a + (unsigned long long)b);
}

// days since 1970-01-01 -> (year, month, day), each cast to int32
__device__ __forceinline__ void civil_from_days(i64 days, int& year,
                                                int& month, int& day) {
  const i64 z = days + 719468;
  const i64 era = floordiv(z >= 0 ? z : z - 146096, 146097);
  const i64 doe = z - era * 146097;
  const i64 yoe = floordiv(doe - floordiv(doe, 1460) + floordiv(doe, 36524) -
                               floordiv(doe, 146096),
                           365);
  i64 y = yoe + era * 400;
  const i64 doy = doe - (365 * yoe + floordiv(yoe, 4) - floordiv(yoe, 100));
  const i64 mp = floordiv(5 * doy + 2, 153);
  const i64 d = doy - floordiv(153 * mp + 2, 5) + 1;
  const i64 m = mp < 10 ? mp + 3 : mp - 9;
  if (m <= 2) ++y;
  year = (int)y;
  month = (int)m;
  day = (int)d;
}

// (year, month, day) -> days since 1970-01-01, cast to int32
__device__ __forceinline__ int days_from_civil(i64 y, i64 m, i64 d) {
  y -= m <= 2 ? 1 : 0;
  const i64 era = floordiv(y >= 0 ? y : y - 399, 400);
  const i64 yoe = y - era * 400;
  const i64 mp = m > 2 ? m - 3 : m + 9;
  const i64 doy = floordiv(153 * mp + 2, 5) + d - 1;
  const i64 doe = yoe * 365 + floordiv(yoe, 4) - floordiv(yoe, 100) + doy;
  return (int)(era * 146097 + doe - 719468);
}

}  // namespace srtpu
