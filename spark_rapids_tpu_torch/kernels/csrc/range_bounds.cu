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
// key); the sentinels S_lo, S_hi are int64 min / 2 and max / 2, or -inf
// and +inf, and a live null takes the one of the side it sorted to (nulls
// first: S_lo). Then for each sorted row j with a valid order value
//   start = first p with val[p] >= val[j] + lower, at least seg_start
//   end   = (first p with val[p] > val[j] + upper) - 1, at most seg_end
// and a row whose order value is null frames its null peer run
// (peer_start, peer_end). An unbounded side is seg_start / seg_end and a
// zero offset peer_start / peer_end; those need no search, and the
// caller passes only the offset sides here. Targets t = val[j] + offset
// wrap in int64 as the plain version's do.
//
// Where a search of the row's own partition gives the reference's answer.
// The reference searches all n rows for the first p where
//   less(p) = gid[p] < g || (gid[p] == g && val[p] < t)
// (<= t on the end side, "strict") is false; g = seg_start[j] and gid is
// seg_start. Over the sorted rows gid never falls: later partitions start
// later, and dead rows trail the last partition and carry its seg_start.
// So less is true before position g and false past the block of rows
// whose gid is g, and inside that block the values run
//   [S_lo: nulls first] [the key's values ascending, NaN last]
//   [S_hi: nulls last] [S_hi: dead rows, last partition only].
// val < t (<= t) is true and then false over the key's values: they
// ascend, and NaN compares false. less is therefore monotone over all n
// rows, and every binary search returns its one boundary, except where
//  (a) less(S_lo) is false while a value after the S_lo rows is less:
//      t <= S_lo (t < S_lo strict), nulls first, and a value below t;
//      only an int64 key below int64 min / 2 can be;
//  (b) less(S_hi) is true while a row before the S_hi rows is not:
//      float, strict, t = +inf and a NaN value; int64, t > S_hi (t >= S_hi
//      strict) and a value of at least t (above t) over int64 max / 2.
// There the answer depends on the positions the search visits. Besides,
// where less(S_hi) holds, the boundary may lie among the dead rows past
// seg_end, where the start side is not clipped; and when every row is
// dead the block is the whole array (seg_start = n > seg_end).
// So a row searches locally when its target is in class M:
//   less(S_lo) && !less(S_hi) && seg_start <= seg_end,
// S_lo < t <= S_hi (S_lo <= t < S_hi strict; a NaN target is in neither).
// Then less is monotone, its boundary lies in [seg_start, seg_end + 1]
// (past seg_end: a later partition or a dead S_hi row, both not less),
// and the first p in [seg_start, seg_end] with val[p] not less, or
// seg_end + 1, is the reference's answer. Every other row (a +inf strict
// or -inf non-strict target, a NaN one, an int64 one beyond the
// sentinels, every row dead) keeps the reference's search of all n rows.
//
// Bound on the H100: bytes. It reads perm, live_s, the key and its
// validity once a row and writes each requested side's int32 bound: at
// 37,748,736 rows of an int64 key, one side, 4 + 1 + 8 + 1 + 4 bytes a
// row, 0.20 ms at 3.35 TB/s. The key and its validity are read through
// the random perm: a 32-byte sector for each, about 2.4 GB at that shape,
// which is the floor of the first launch and of the whole.
//
// Design: two launches.
// 1. Values: each thread gathers the key and its validity through perm
//    for four sorted rows a step, all loads issued before any is used,
//    and writes val and a null byte in sorted order. This is the one
//    random gather; the search launch reads neither perm nor valid.
// 2. Search: a block owns a tile of 2,048 sorted rows and stages, with
//    coalesced loads, val over the tile and 512 rows on either side
//    (16-byte loads), and the tile's seg_start, seg_end and null bytes in
//    shared memory. A thread takes 8 consecutive rows. A row in class M
//    gallops inside [seg_start, seg_end]: steps of 1, 2, 4, ... rows from
//    a guess toward its target, then a binary search inside the last
//    step, so an answer d rows from the guess costs about 2 log2(d + 1)
//    probes. The guess is the thread's previous row's answer in the same
//    partition (targets ascend with the rows, and so do the answers: the
//    next row's is mostly the same or one peer run on), else the row
//    itself. A probe outside the staged values reads device memory. The
//    bounds go back through shared memory and leave coalesced. Indices
//    are int32 (n < 2^31, as the int32 outputs require).

#include <limits.h>
#include <math.h>

#include "search.cuh"
#include "window_frame.cuh"

namespace srtpu {

enum RangeKeyType { kRkI16 = 0, kRkI32 = 1, kRkI64 = 2, kRkF32 = 3,
                    kRkF64 = 4, kRkI8 = 5 };

constexpr int kSearchRows = 8;                       // consecutive, a thread
constexpr int kSearchTile = kThreads * kSearchRows;  // 2,048 rows a block
constexpr int kHalo = 512;                           // staged on each side
constexpr int kWindow = kSearchTile + 2 * kHalo;     // 24 KB of values
constexpr int kSkewed = kSearchTile + kSearchTile / 32;

// a tile row's slot in the skewed shared arrays: one word of padding a
// 32, so a warp's lanes (8 rows apart) hit 32 different banks
__device__ __forceinline__ int skew(int i) { return i + (i >> 5); }

// the target: int64 wraps as torch's does (no signed overflow here)
__device__ __forceinline__ long long add_offset(long long v, long long o) {
  return (long long)((unsigned long long)v + (unsigned long long)o);
}
__device__ __forceinline__ double add_offset(double v, double o) {
  return v + o;
}

template <typename V>
__device__ __forceinline__ bool below(V m, V t, bool strict) {
  return strict ? m <= t : m < t;
}

// kValueRows rows a thread a step, every load issued before any is used
// (the key's load does not wait on its validity). Everything but the
// validity streams through the L2 (evict-first loads and stores), so the
// validity bytes, a 32-byte sector of them read by 32 rows, stay there
constexpr int kValueRows = 4;

template <typename T, typename V>
__global__ void __launch_bounds__(kThreads)
range_values_kernel(const T* __restrict__ data,
                    const uint8_t* __restrict__ valid,
                    const uint8_t* __restrict__ live_s,
                    const int* __restrict__ perm, i64 n, V null_sentinel,
                    V pos_sentinel, V* __restrict__ val,
                    uint8_t* __restrict__ nul) {
  const i64 step = (i64)gridDim.x * blockDim.x;
  for (i64 j0 = (i64)blockIdx.x * blockDim.x + threadIdx.x; j0 < n;
       j0 += kValueRows * step) {
    i64 src[kValueRows];
#pragma unroll
    for (int k = 0; k < kValueRows; ++k) {
      const i64 j = j0 + k * step;
      src[k] = j < n ? (perm != nullptr ? (i64)__ldcs(perm + j) : j) : 0;
    }
    T x[kValueRows];
    bool ok[kValueRows], live[kValueRows];
#pragma unroll
    for (int k = 0; k < kValueRows; ++k) {
      const i64 j = j0 + k * step;
      if (j < n) {
        x[k] = __ldcs(data + src[k]);
        ok[k] = valid[src[k]];
        live[k] = __ldcs(live_s + j);
      }
    }
#pragma unroll
    for (int k = 0; k < kValueRows; ++k) {
      const i64 j = j0 + k * step;
      if (j < n) {
        __stcs(val + j,
               live[k] ? (ok[k] ? (V)x[k] : null_sentinel) : pos_sentinel);
        __stcs(nul + j, (uint8_t)!ok[k]);
      }
    }
  }
}

template <typename V>
void launch_values(int type, const void* data, const uint8_t* valid,
                   const uint8_t* live_s, const int* perm, i64 n,
                   V null_sentinel, V pos_sentinel, V* val, uint8_t* nul,
                   unsigned blocks, cudaStream_t s) {
#define SRTPU_VALUES(T)                                                  \
  range_values_kernel<T, V><<<blocks, kThreads, 0, s>>>(                 \
      (const T*)data, valid, live_s, perm, n, null_sentinel, pos_sentinel, \
      val, nul)
  switch (type) {
    case kRkI16: SRTPU_VALUES(short); break;
    case kRkI32: SRTPU_VALUES(int); break;
    case kRkI64: SRTPU_VALUES(long long); break;
    case kRkF32: SRTPU_VALUES(float); break;
    case kRkI8: SRTPU_VALUES(signed char); break;
    default: SRTPU_VALUES(double);
  }
#undef SRTPU_VALUES
}

// the reference's _lower_bound: first p in [0, n) with (gid[p], val[p])
// >= (gid, t), > when strict
template <typename V>
__device__ __forceinline__ i64 search_all(const V* __restrict__ val,
                                          const int* __restrict__ gid_s,
                                          i64 n, i64 gid, V t, bool strict) {
  i64 lo = 0, hi = n;
  while (lo < hi) {
    const i64 mid = (lo + hi) >> 1;
    const i64 mg = gid_s[mid];
    const V m = val[mid];
    const bool less = mg < gid || (mg == gid && below(m, t, strict));
    if (less)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// sorted values [w0, w1) staged in shared memory, the rest in device memory
template <typename V>
struct Staged {
  const V* s;
  const V* g;
  int w0, w1;
  __device__ __forceinline__ V operator()(int p) const {
    return p >= w0 && p < w1 ? s[p - w0] : g[p];
  }
};

// one side's bound of a sorted row: start (not strict) or end (strict);
// a local search gallops from `from`
template <typename V>
__device__ __forceinline__ int side_bound(const Staged<V>& at,
                                          const V* __restrict__ val,
                                          const int* __restrict__ gid_s,
                                          int n, int from, int ss, int se,
                                          V t, bool strict, V s_lo,
                                          V s_hi) {
  i64 p;
  if (ss <= se && below(s_lo, t, strict) && !below(s_hi, t, strict))
    p = gallop(ss, se + 1, from,
               [&](int q) { return below(at(q), t, strict); });
  else
    p = search_all(val, gid_s, n, ss, t, strict);
  if (strict) return (int)(p - 1 > se ? se : p - 1);
  return (int)(p < ss ? ss : p);
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
range_search_kernel(const V* __restrict__ val,
                    const uint8_t* __restrict__ nul, int n, SegBounds b,
                    V lower, V upper, V s_lo, V s_hi,
                    int* __restrict__ start, int* __restrict__ end) {
  __shared__ __align__(16) V win[kWindow];
  // each tile row's seg_start and seg_end, then its start and end
  __shared__ int first[kSkewed], last[kSkewed];
  __shared__ uint8_t null_row[kSearchTile];
  const int base = blockIdx.x * kSearchTile;
  const int rows = n - base < kSearchTile ? n - base : kSearchTile;
  const int w0 = base > kHalo ? base - kHalo : 0;
  const int w1 = n - base > kSearchTile + kHalo ? base + kSearchTile + kHalo
                                                : n;
  // w0 is even and val 16-byte aligned: whole pairs with 16-byte loads
  const int pairs = (w1 - w0) >> 1;
  const longlong2* src2 = reinterpret_cast<const longlong2*>(val + w0);
  longlong2* dst2 = reinterpret_cast<longlong2*>(win);
  for (int i = threadIdx.x; i < pairs; i += kThreads) dst2[i] = src2[i];
  if (((w1 - w0) & 1) && threadIdx.x == 0) win[w1 - w0 - 1] = val[w1 - 1];
  for (int i = threadIdx.x; i < rows; i += kThreads) {
    first[skew(i)] = b.seg_start[base + i];
    last[skew(i)] = b.seg_end[base + i];
    null_row[i] = nul[base + i];
  }
  __syncthreads();
  const Staged<V> at{win, val, w0, w1};
  // a row's answer is at or past the previous row's in its partition:
  // each gallop starts there
  int seg = -1, from_s = 0, from_e = 0;
#pragma unroll 1
  for (int k = 0; k < kSearchRows; ++k) {
    const int i = threadIdx.x * kSearchRows + k;
    if (i >= rows) break;
    const int j = base + i;
    const int ss = first[skew(i)], se = last[skew(i)];
    if (ss != seg) {
      seg = ss;
      from_s = from_e = j;
    }
    int s_out = 0, e_out = 0;
    if (null_row[i]) {
      if (start != nullptr) s_out = b.peer_start[j];
      if (end != nullptr) e_out = b.peer_end[j];
    } else {
      const V v = win[j - w0];
      if (start != nullptr) {
        s_out = side_bound(at, val, b.seg_start, n, from_s, ss, se,
                           add_offset(v, lower), false, s_lo, s_hi);
        from_s = s_out;
      }
      if (end != nullptr) {
        e_out = side_bound(at, val, b.seg_start, n, from_e, ss, se,
                           add_offset(v, upper), true, s_lo, s_hi);
        from_e = e_out + 1;
      }
    }
    first[skew(i)] = s_out;
    last[skew(i)] = e_out;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows; i += kThreads) {
    if (start != nullptr) start[base + i] = first[skew(i)];
    if (end != nullptr) end[base + i] = last[skew(i)];
  }
}

template <typename V>
int range_bounds(const void* data, int type, const uint8_t* valid,
                 const uint8_t* live_s, const int* perm, int n,
                 int nulls_first, V s_lo, V s_hi, V lower, V upper,
                 const SegBounds& b, int* start, int* end, V* val,
                 uint8_t* nul, int sm_count, cudaStream_t s) {
  launch_values<V>(type, data, valid, live_s, perm, n,
                   nulls_first ? s_lo : s_hi, s_hi, val, nul,
                   row_blocks(n, sm_count), s);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int tiles = (n + kSearchTile - 1) / kSearchTile;
  range_search_kernel<V><<<tiles, kThreads, 0, s>>>(
      val, nul, n, b, lower, upper, s_lo, s_hi, start, end);
  return (int)cudaGetLastError();
}

}  // namespace srtpu

using namespace srtpu;

// type: RangeKeyType of data; as_float: search in float64 (a float key, or
// fractional offsets), else int64 (an integer key); data, valid: [>= rows
// perm names] key and its validity; live_s: [n] bool, sorted order; perm:
// [n] int32 or null (key already sorted); lower_*, upper_*: the offsets
// (the float or the int one is read); start, end: [n] int32 out, sorted
// order, null for a side without an offset; scratch: n * 9 bytes, 16-byte
// aligned (the sorted values, then the null bytes).
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
  if (n < 1 || n > INT_MAX || type < kRkI16 || type > kRkI8 ||
      (!as_float && (type == kRkF32 || type == kRkF64)) ||
      (reinterpret_cast<uintptr_t>(scratch) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const SegBounds b = {(const int*)seg_start, (const int*)seg_end,
                       (const int*)peer_start, (const int*)peer_end};
  cudaStream_t s = (cudaStream_t)stream;
  uint8_t* nul = (uint8_t*)scratch + n * 8;
  if (as_float)
    return range_bounds<double>(
        data, type, (const uint8_t*)valid, (const uint8_t*)live_s,
        (const int*)perm, (int)n, nulls_first, -HUGE_VAL, HUGE_VAL, lower_f,
        upper_f, b, (int*)start, (int*)end, (double*)scratch, nul, sm_count,
        s);
  return range_bounds<long long>(
      data, type, (const uint8_t*)valid, (const uint8_t*)live_s,
      (const int*)perm, (int)n, nulls_first, LLONG_MIN / 2, LLONG_MAX / 2,
      lower_i, upper_i, b, (int*)start, (int*)end, (long long*)scratch, nul,
      sm_count, s);
}
