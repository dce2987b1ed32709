// K15 range_bounds: the bounds of RANGE BETWEEN value-offset frames.
//
// Replaces spark_rapids_tpu/ops/windowops.py:142 _lower_bound and :167
// range_frame_bounds (a vectorised binary search that XLA compiles). Over
// one ascending numeric ORDER BY key in the window's sorted order, with
// perm[j] the input row at sorted position j:
//   val[j] = live_s[j] && valid[perm[j]] ? widen(data[perm[j]])
//            : live_s[j] ? null sentinel : +sentinel
// where widen is int64 for an integer key with integer offsets, and
// float64 otherwise (a float key, or fractional offsets over an integer
// key); the sentinels are int64 min / 2 and max / 2, or -inf and +inf, and
// a live null takes the one of the side it sorted to (nulls first: the
// low one). Then for each sorted row j with a valid order value
//   start = first p with val[p] >= val[j] + lower, at least seg_start
//   end   = (first p with val[p] > val[j] + upper) - 1, at most seg_end
// and a row whose order value is null frames its null peer run
// (peer_start, peer_end). An unbounded side is seg_start / seg_end and a
// zero offset peer_start / peer_end; those need no search, and the
// caller passes only the offset sides here.
//
// Each search is the reference's: a lower bound over all n sorted rows by
// (segment, value), the segment being each row's seg_start, then clipped
// to the row's segment. A search inside the segment alone would be
// shorter, but it is not the same function: a NaN value (above +inf in
// the sort) and the +inf sentinels of trailing nulls and dead rows make
// the predicate non-monotone for a target of +inf, and the reference's
// answer there depends on the positions its search visits.
//
// Bound on the H100: bytes. It reads perm, live_s, the key and its
// validity once a row and writes each requested side's int32 bound: at
// 37,748,736 rows of an int64 key with both sides, 4 + 1 + 8 + 1 + 8 bytes
// a row, 0.25 ms at 3.35 TB/s. The searches' 26 probes a side re-read
// seg_start and val; the first probes of every row are the same few
// positions, held in L1 and L2.
//
// Design: two launches. The first writes val (one read through perm a
// row), so the searches' probes read a contiguous array instead of two
// random reads each; the second does one thread a sorted row, both sides.

#include <limits.h>
#include <math.h>

#include "window_frame.cuh"

namespace srtpu {

enum RangeKeyType { kRkI16 = 0, kRkI32 = 1, kRkI64 = 2, kRkF32 = 3,
                    kRkF64 = 4, kRkI8 = 5 };

template <typename V>
__device__ __forceinline__ V widen(const void* data, int type, i64 i) {
  switch (type) {
    case kRkI16: return (V)((const short*)data)[i];
    case kRkI32: return (V)((const int*)data)[i];
    case kRkI64: return (V)((const long long*)data)[i];
    case kRkF32: return (V)((const float*)data)[i];
    case kRkI8: return (V)((const signed char*)data)[i];
    default: return (V)((const double*)data)[i];
  }
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
range_values_kernel(const void* __restrict__ data, int type,
                    const uint8_t* __restrict__ valid,
                    const uint8_t* __restrict__ live_s,
                    const int* __restrict__ perm, i64 n, V null_sentinel,
                    V pos_sentinel, V* __restrict__ val) {
  for (i64 j = (i64)blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += (i64)gridDim.x * blockDim.x) {
    const i64 src = perm != nullptr ? (i64)perm[j] : j;
    V v = pos_sentinel;
    if (live_s[j]) v = valid[src] ? widen<V>(data, type, src) : null_sentinel;
    val[j] = v;
  }
}

// the reference's _lower_bound: first p in [0, n) with (gid[p], val[p])
// >= (gid, t), > when strict
template <typename V>
__device__ __forceinline__ i64 search(const V* __restrict__ val,
                                      const int* __restrict__ gid_s, i64 n,
                                      i64 gid, V t, bool strict) {
  i64 lo = 0, hi = n;
  while (lo < hi) {
    const i64 mid = (lo + hi) >> 1;
    const i64 mg = gid_s[mid];
    const V m = val[mid];
    const bool less = mg < gid || (mg == gid && (strict ? m <= t : m < t));
    if (less)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
range_search_kernel(const V* __restrict__ val,
                    const uint8_t* __restrict__ valid,
                    const int* __restrict__ perm, i64 n, SegBounds b,
                    V lower, V upper, int* __restrict__ start,
                    int* __restrict__ end) {
  for (i64 j = (i64)blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += (i64)gridDim.x * blockDim.x) {
    const i64 src = perm != nullptr ? (i64)perm[j] : j;
    const bool is_null = !valid[src];
    const i64 ss = b.seg_start[j], se = b.seg_end[j];
    const V v = val[j];
    if (start != nullptr) {
      i64 s;
      if (is_null) {
        s = b.peer_start[j];
      } else {
        s = search(val, b.seg_start, n, ss, (V)(v + lower), false);
        if (s < ss) s = ss;
      }
      start[j] = (int)s;
    }
    if (end != nullptr) {
      i64 e;
      if (is_null) {
        e = b.peer_end[j];
      } else {
        e = search(val, b.seg_start, n, ss, (V)(v + upper), true) - 1;
        if (e > se) e = se;
      }
      end[j] = (int)e;
    }
  }
}

template <typename V>
int range_bounds(const void* data, int type, const uint8_t* valid,
                 const uint8_t* live_s, const int* perm, i64 n,
                 int nulls_first, V neg_inf, V pos_inf, V lower, V upper,
                 const SegBounds& b, int* start, int* end, V* val,
                 int sm_count, cudaStream_t s) {
  const unsigned blocks = row_blocks(n, sm_count);
  range_values_kernel<V><<<blocks, kThreads, 0, s>>>(
      data, type, valid, live_s, perm, n, nulls_first ? neg_inf : pos_inf,
      pos_inf, val);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  range_search_kernel<V><<<blocks, kThreads, 0, s>>>(
      val, valid, perm, n, b, lower, upper, start, end);
  return (int)cudaGetLastError();
}

}  // namespace srtpu

using namespace srtpu;

// type: RangeKeyType of data; as_float: search in float64 (a float key, or
// fractional offsets), else int64 (an integer key); data, valid: [>= rows
// perm names] key and its validity; live_s: [n] bool, sorted order; perm:
// [n] int32 or null (key already sorted); lower_*, upper_*: the offsets
// (the float or the int one is read); start, end: [n] int32 out, sorted
// order, null for a side without an offset; scratch: n * 8 bytes.
extern "C" int srtpu_range_bounds(int type, int as_float, const void* data,
                                  const void* valid, const void* live_s,
                                  const void* perm, long long n,
                                  int nulls_first, long long lower_i,
                                  long long upper_i, double lower_f,
                                  double upper_f, const void* seg_start,
                                  const void* seg_end,
                                  const void* peer_start,
                                  const void* peer_end, void* start,
                                  void* end, void* scratch, int sm_count,
                                  void* stream) {
  if (n < 1 || type < kRkI16 || type > kRkI8 ||
      (!as_float && (type == kRkF32 || type == kRkF64)))
    return (int)cudaErrorInvalidValue;
  const SegBounds b = {(const int*)seg_start, (const int*)seg_end,
                       (const int*)peer_start, (const int*)peer_end};
  cudaStream_t s = (cudaStream_t)stream;
  if (as_float)
    return range_bounds<double>(
        data, type, (const uint8_t*)valid, (const uint8_t*)live_s,
        (const int*)perm, n, nulls_first, -HUGE_VAL, HUGE_VAL, lower_f, upper_f, b, (int*)start, (int*)end,
        (double*)scratch, sm_count, s);
  return range_bounds<long long>(
      data, type, (const uint8_t*)valid, (const uint8_t*)live_s,
      (const int*)perm, n, nulls_first, LLONG_MIN / 2, LLONG_MAX / 2,
      lower_i, upper_i, b, (int*)start, (int*)end, (long long*)scratch,
      sm_count, s);
}
