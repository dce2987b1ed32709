// K31 decimal128: 128-bit decimal arithmetic, one thread a row.
//
// Replaces spark_rapids_tpu/ops/decimal128.py: add128 (:54), neg128 (:61),
// abs128 (:68), mul_i64_i64 (:74), mul128_small (:93), cmp_unsigned
// (:102), divmod_u128_u64 (:120), div128_round_half_up (:146), rescale
// (:161), fits_precision (:193), fits_i64 (:202), to_f64 (:207),
// orderable_limbs (:238, for comparisons) and widen_column (:245). XLA
// compiles each as a chain of elementwise passes over int64 limbs, and
// the division as a 128-step fori_loop of about 15 passes. A value is a
// [n, 2] int64 limb row (hi signed, lo the low 64 bits), or a narrow
// decimal's int64 sign-extended. Modes:
//   kAdd, kSub    out [n, 2] = rescale(a, a_shift) +/- rescale(b, b_shift);
//   kMul          out [n, 2] = a * b, a and b int64 (64 x 64 -> 128);
//   kRescale      out = rescale(a, a_shift): [n, 2], or with out_wide 0 the
//                 low limb, valid only where it fits an int64;
//   kAvg          out = rescale(a, a_shift) / max(count, 1), HALF_UP on
//                 |value| and the sign put back (an average's evaluate),
//                 valid where count > 0; [n, 2] or int64 as kRescale;
//   kNeg, kAbs    out [n, 2];
//   kCmp          out int8: -1, 0 or 1, the signed 128-bit order of a and b;
//   kToF64        out float64 = (hi * 2^64 + (double)(uint64)lo) / 10^a_shift,
//                 each step one IEEE operation as the reference's to_f64
//                 and its division by 10.0 ** scale;
//   kToI64        out int64: |a| truncated by 10^a_shift (two steps past
//                 10^18), the sign put back, the low limb (the reference's
//                 wide decimal -> integral cast).
// Where out_valid is given it is valid (all rows when null) & the
// precision test |out| < 10^precision (none when precision is 0).
// Arithmetic is unsigned __int128 (decimal128.cuh): it wraps mod 2^128
// as the reference's limb arithmetic does.
//
// Bound on the H100: bytes. Each mode reads its operands and validity
// once and writes its output and validity once: q1's product of 59,986,052
// price and discount pairs (two int64 and a validity in, [n, 2] and a
// validity out) is about 1.98 GB, 0.59 ms at 3.35 TB/s. The division of
// an average runs over groups, not rows.
//
// Design: grid-stride, one thread a row, every 10^k of the launch
// computed once a thread; a division by a divisor below 2^32 (every 10^k
// with k <= 9, every count below 2^32) takes two hardware 64-bit
// divisions where the reference loops 128 times.

#include "decimal128.cuh"

namespace srtpu {

enum D128Mode { kAdd = 0, kSub, kMul, kRescale, kAvg, kNeg, kAbs, kCmp,
                kToF64, kToI64 };

__device__ const double kPow10d[39] = {
    1e0,  1e1,  1e2,  1e3,  1e4,  1e5,  1e6,  1e7,  1e8,  1e9,
    1e10, 1e11, 1e12, 1e13, 1e14, 1e15, 1e16, 1e17, 1e18, 1e19,
    1e20, 1e21, 1e22, 1e23, 1e24, 1e25, 1e26, 1e27, 1e28, 1e29,
    1e30, 1e31, 1e32, 1e33, 1e34, 1e35, 1e36, 1e37, 1e38};

__global__ void __launch_bounds__(kThreads)
decimal128_kernel(int mode, const i64* __restrict__ a, int a_wide,
                  int a_shift, const i64* __restrict__ b, int b_wide,
                  int b_shift, const uint8_t* __restrict__ valid,
                  const i64* __restrict__ count, i64 n, int precision,
                  int out_wide, void* __restrict__ out,
                  uint8_t* __restrict__ out_valid) {
  const u128 limit = pow10_128(precision);
  for (i64 r = (i64)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += (i64)gridDim.x * blockDim.x) {
    bool ok = valid == nullptr || valid[r] != 0;
    u128 x = load_dec(a, a_wide, r);
    switch (mode) {
      case kAdd:
      case kSub: {
        u128 y = rescale_dec(load_dec(b, b_wide, r), b_shift);
        if (mode == kSub) y = (u128)0 - y;
        x = rescale_dec(x, a_shift) + y;
        break;
      }
      case kMul:
        x = (u128)((__int128)a[r] * (__int128)b[r]);
        break;
      case kRescale:
        x = rescale_dec(x, a_shift);
        break;
      case kAvg: {
        const i64 c = count[r];
        const u64_t d = (u64_t)(c > 1 ? c : 1);
        ok = ok && c > 0;
        bool neg;
        u128 q = abs_dec(rescale_dec(x, a_shift), neg);
        u64_t rem;
        q = divmod_u128(q, d, rem);
        q += half_up(rem, d) ? 1 : 0;
        x = neg ? (u128)0 - q : q;
        break;
      }
      case kNeg:
        x = (u128)0 - x;
        break;
      case kAbs: {
        bool neg;
        x = abs_dec(x, neg);
        break;
      }
      case kCmp: {
        const __int128 sx = (__int128)x;
        const __int128 sy = (__int128)load_dec(b, b_wide, r);
        static_cast<int8_t*>(out)[r] = sx < sy ? -1 : (sx > sy ? 1 : 0);
        continue;
      }
      case kToF64: {
        const double v = (double)hi_of(x) * 18446744073709551616.0 +
                         (double)(u64_t)x;
        static_cast<double*>(out)[r] = v / kPow10d[a_shift];
        continue;
      }
      default: {  // kToI64
        if (a_shift > 0) {
          bool neg;
          u128 q = abs_dec(x, neg);
          u64_t rem;
          q = divmod_u128(q, (u64_t)pow10_128(a_shift < 18 ? a_shift : 18),
                          rem);
          if (a_shift > 18)
            q = divmod_u128(q, (u64_t)pow10_128(a_shift - 18), rem);
          x = neg ? (u128)0 - q : q;
        }
        static_cast<i64*>(out)[r] = lo_of(x);
        continue;
      }
    }
    if (precision > 0) ok = ok && fits_dec(x, limit);
    if (out_wide) {
      store_dec(static_cast<i64*>(out), r, x);
    } else {
      ok = ok && fits_i64_dec(x);
      static_cast<i64*>(out)[r] = lo_of(x);
    }
    if (out_valid != nullptr) out_valid[r] = ok;
  }
}

inline int d128_grid(i64 n, int sm_count) {
  const i64 blocks = (n + kThreads - 1) / kThreads;
  const i64 cap = 16LL * sm_count;
  return (int)(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

}  // namespace srtpu

using namespace srtpu;

// a, b: [n] int64 or [n, 2] int64 limbs (a_wide, b_wide); b is read by
// kAdd, kSub, kMul and kCmp only; valid: [n] bool or null; count: [n]
// int64 (kAvg only); out: [n, 2] int64, [n] int64, [n] int8 (kCmp) or [n]
// float64 (kToF64); out_valid: [n] bool or null. Shifts and precision lie
// in [-38, 38] and [0, 38].
extern "C" int srtpu_decimal128(int mode, const void* a, int a_wide,
                                int a_shift, const void* b, int b_wide,
                                int b_shift, const void* valid,
                                const void* count, long long n,
                                int precision, int out_wide, void* out,
                                void* out_valid, int sm_count, void* stream) {
  const bool two = mode == kAdd || mode == kSub || mode == kMul ||
                   mode == kCmp;
  if (n < 1 || mode < kAdd || mode > kToI64 || a == nullptr ||
      out == nullptr || (two && b == nullptr) ||
      (mode == kAvg && count == nullptr) || precision < 0 ||
      precision > 38 || a_shift < -38 || a_shift > 38 || b_shift < -38 ||
      b_shift > 38 || (mode == kMul && (a_wide || b_wide)) ||
      ((mode == kToF64 || mode == kToI64) && a_shift < 0) ||
      (mode == kToI64 && a_shift > 36))
    return (int)cudaErrorInvalidValue;
  decimal128_kernel<<<d128_grid(n, sm_count), kThreads, 0,
                      (cudaStream_t)stream>>>(
      mode, (const i64*)a, a_wide, a_shift, (const i64*)b, b_wide, b_shift,
      (const uint8_t*)valid, (const i64*)count, n, precision, out_wide, out,
      (uint8_t*)out_valid);
  return (int)cudaGetLastError();
}
