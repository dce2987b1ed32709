// K16 frame_minmax: MIN and MAX over arbitrary window frames.
//
// Replaces spark_rapids_tpu/ops/windowops.py:256 _sparse_table and :271
// frame_minmax (a [log2(cap), cap] doubling table and two lookups a row,
// which XLA compiles). For each sorted row j with frame [start, end]:
//   out = ident                        where end < start (empty frame)
//   out = min (max) over the frame's live rows of
//         (valid ? value : ident)      otherwise
// with Spark's float order as the reference computes it: a NaN in the
// frame makes MAX NaN, MIN is NaN when no valid non-NaN value is in the
// frame (so also when none is valid), every NaN is written as the
// canonical quiet NaN, and -0.0 orders below 0.0 (jnp.minimum(-0.0, 0.0)
// is -0.0 in both argument orders on the CPU backend, maximum +0.0); ident
// is +inf (-inf) for floats, the type's largest (smallest) value for
// integers, and 1 (0) for booleans, which the reference takes as int32.
// The validity is the frame's count of valid live rows > 0, from K14's
// count prefix. Results land at input rows through inv (K14's inverse
// permutation), as K14 writes its own.
//
// Every value maps to an int64 key whose signed order is that order (the
// integer itself; for floats the IEEE total-order bit trick after NaN is
// made canonical, so NaN is above +inf). A row that is null or dead takes
// the key of the integer identity, or for floats INT64_MIN (MAX) / INT64_MAX
// (MIN): above NaN for MIN, so a frame whose least key is NaN or above has
// no valid non-NaN value and its MIN is NaN.
//
// Bound on the H100: bytes. The memory the reference's table needs is the
// problem: 26 levels x 8 bytes x 37.7M rows is 7.9 GB a column. Here the
// rows are cut into tiles of 32 (a warp): each row keeps its key and its
// tile's prefix and suffix extremum (24 bytes a row), and a sparse table
// spans the tiles' extrema (log2(cap / 32) levels of cap / 32): 0.9 GB +
// 0.2 GB at 37.7M rows, freed after the call. A frame inside one tile is a
// loop over at most 32 keys; any other frame is suf[start], pre[end] and
// two table entries for the whole tiles between. The function moves perm,
// live_s, the value and its validity (through perm) in and the result and
// its validity out; the build writes and the query re-reads the 24 bytes a
// row of the structure.
//
// Launches: one builds keys, prefixes, suffixes and the tiles' extrema (a
// warp a tile, shuffles), one per further table level, one evaluates
// every output row.

#include <limits.h>

#include "window_frame.cuh"

namespace srtpu {

enum MmType { kMmI16 = 0, kMmI32 = 1, kMmI64 = 2, kMmF32 = 3, kMmF64 = 4,
              kMmBool = 5, kMmI8 = 6 };

constexpr int kMmTileShift = 5;  // 32-row tiles

__device__ __forceinline__ long long ext(long long a, long long b,
                                         bool is_max) {
  return is_max ? (a > b ? a : b) : (a < b ? a : b);
}

__device__ __forceinline__ long long f64_key(double v) {
  long long bits = v != v ? 0x7FF8000000000000LL : __double_as_longlong(v);
  return bits ^ ((bits >> 63) & LLONG_MAX);
}

__device__ __forceinline__ long long f32_key(float v) {
  int bits = v != v ? 0x7FC00000 : __float_as_int(v);
  return (long long)(bits ^ ((bits >> 31) & 0x7FFFFFFF));
}

// the key of a row: its value's, or the key a null or dead row takes
__device__ __forceinline__ long long mm_key(const void* vals, int type,
                                            i64 i, bool use, bool is_max) {
  switch (type) {
    case kMmI8:
      return use ? (long long)((const signed char*)vals)[i]
                 : (is_max ? SCHAR_MIN : SCHAR_MAX);
    case kMmI16:
      return use ? (long long)((const short*)vals)[i]
                 : (is_max ? SHRT_MIN : SHRT_MAX);
    case kMmI32:
      return use ? (long long)((const int*)vals)[i]
                 : (is_max ? INT_MIN : INT_MAX);
    case kMmI64:
      return use ? ((const long long*)vals)[i]
                 : (is_max ? LLONG_MIN : LLONG_MAX);
    case kMmBool:
      return use ? (long long)(((const uint8_t*)vals)[i] != 0)
                 : (is_max ? 0 : 1);
    case kMmF32:
      return use ? f32_key(((const float*)vals)[i])
                 : (is_max ? LLONG_MIN : LLONG_MAX);
    default:
      return use ? f64_key(((const double*)vals)[i])
                 : (is_max ? LLONG_MIN : LLONG_MAX);
  }
}

// write the result of key k (empty: the frame has no row) at out[i]
__device__ __forceinline__ void mm_store(void* out, int type, i64 i,
                                         long long k, bool empty,
                                         bool is_max) {
  switch (type) {
    case kMmI8:
      ((signed char*)out)[i] =
          empty ? (is_max ? SCHAR_MIN : SCHAR_MAX) : (signed char)k;
      return;
    case kMmI16:
      ((short*)out)[i] = empty ? (is_max ? SHRT_MIN : SHRT_MAX) : (short)k;
      return;
    case kMmI32:
      ((int*)out)[i] = empty ? (is_max ? INT_MIN : INT_MAX) : (int)k;
      return;
    case kMmI64:
      ((long long*)out)[i] = empty ? (is_max ? LLONG_MIN : LLONG_MAX) : k;
      return;
    case kMmBool:
      ((uint8_t*)out)[i] = empty ? (is_max ? 0 : 1) : (uint8_t)(k != 0);
      return;
    case kMmF32: {
      // empty: the identity; no valid row under MAX: -inf; a NaN key or
      // above: the canonical NaN
      int bits;
      if (empty)
        bits = is_max ? (int)0xFF800000u : 0x7F800000;
      else if (k == LLONG_MIN)
        bits = (int)0xFF800000u;
      else if (k >= 0x7FC00000LL)
        bits = 0x7FC00000;
      else
        bits = (int)k ^ (((int)k >> 31) & 0x7FFFFFFF);
      ((float*)out)[i] = __int_as_float(bits);
      return;
    }
    default: {
      long long bits;
      if (empty)
        bits = is_max ? (long long)0xFFF0000000000000ULL
                      : 0x7FF0000000000000LL;
      else if (k == LLONG_MIN)
        bits = (long long)0xFFF0000000000000ULL;
      else if (k >= 0x7FF8000000000000LL)
        bits = 0x7FF8000000000000LL;
      else
        bits = k ^ ((k >> 63) & LLONG_MAX);
      ((double*)out)[i] = __longlong_as_double(bits);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
mm_build_kernel(const void* __restrict__ vals, int type,
                const uint8_t* __restrict__ valid,
                const uint8_t* __restrict__ live_s,
                const int* __restrict__ perm, i64 n, int is_max,
                long long* __restrict__ keys, long long* __restrict__ pre,
                long long* __restrict__ suf, long long* __restrict__ tiles,
                i64 ntiles) {
  const int lane = threadIdx.x & 31;
  const long long neutral = is_max ? LLONG_MIN : LLONG_MAX;
  for (i64 t = ((i64)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       t < ntiles; t += ((i64)gridDim.x * blockDim.x) >> 5) {
    const i64 j = (t << kMmTileShift) + lane;
    long long k = neutral;
    if (j < n) {
      bool use = live_s[j];
      i64 src = j;
      if (use) {
        src = perm != nullptr ? (i64)perm[j] : j;
        use = valid == nullptr || valid[src];
      }
      k = mm_key(vals, type, src, use, is_max);
      keys[j] = k;
    }
    long long p = k, q = k;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const long long up = __shfl_up_sync(kFull, p, off);
      const long long down = __shfl_down_sync(kFull, q, off);
      if (lane >= off) p = ext(p, up, is_max);
      if (lane + off < 32) q = ext(q, down, is_max);
    }
    if (j < n) {
      pre[j] = p;
      suf[j] = q;
    }
    if (lane == 31) tiles[t] = p;
  }
}

// level l of the tiles' sparse table from level l - 1: over [t, t + 2^l)
__global__ void __launch_bounds__(kThreads)
mm_level_kernel(const long long* __restrict__ prev, long long* __restrict__ cur,
                i64 ntiles, i64 half, int is_max) {
  for (i64 t = (i64)blockIdx.x * blockDim.x + threadIdx.x; t < ntiles;
       t += (i64)gridDim.x * blockDim.x) {
    const long long a = prev[t];
    cur[t] = t + half < ntiles ? ext(a, prev[t + half], is_max) : a;
  }
}

__global__ void __launch_bounds__(kThreads)
mm_query_kernel(int type, int is_max, i64 n, WinFrame f, SegBounds b,
                const long long* __restrict__ keys,
                const long long* __restrict__ pre,
                const long long* __restrict__ suf,
                const long long* __restrict__ table, i64 ntiles,
                const long long* __restrict__ pcnt,
                const int* __restrict__ inv, void* __restrict__ out,
                uint8_t* __restrict__ out_valid) {
  for (i64 dst = (i64)blockIdx.x * blockDim.x + threadIdx.x; dst < n;
       dst += (i64)gridDim.x * blockDim.x) {
    const i64 j = inv != nullptr ? (i64)inv[dst] : dst;
    i64 start, end;
    frame_bounds(f, b, j, start, end);
    const bool empty = end < start;
    long long r = 0;
    if (!empty) {
      const i64 s = clip(start, 0, n - 1), e = clip(end, 0, n - 1);
      const i64 ts = s >> kMmTileShift, te = e >> kMmTileShift;
      if (ts == te) {
        r = keys[s];
        for (i64 p = s + 1; p <= e; ++p) r = ext(r, keys[p], is_max);
      } else {
        r = ext(suf[s], pre[e], is_max);
        if (te - ts > 1) {
          const i64 a = ts + 1, len = te - ts - 1;
          const int lvl = 63 - __clzll((unsigned long long)len);
          const long long* row = table + (i64)lvl * ntiles;
          r = ext(r, ext(row[a], row[te - 1 - (1LL << lvl) + 1], is_max),
                  is_max);
        }
      }
    }
    mm_store(out, type, dst, r, empty, is_max);
    if (out_valid != nullptr) {
      const long long cnt =
          empty ? 0 : pcnt[clip(end + 1, 0, n)] - pcnt[clip(start, 0, n)];
      out_valid[dst] = cnt > 0;
    }
  }
}

}  // namespace srtpu

using namespace srtpu;

// Table levels over n rows' tiles: floor(log2(tiles)) + 1, the bit
// length of tiles (the wrapper sizes the scratch by it).
static int mm_levels(long long n) {
  const long long tiles = (n + 31) >> kMmTileShift;
  int lv = 1;
  while ((2LL << (lv - 1)) <= tiles) ++lv;
  return lv;
}

// type: MmType; vals, valid: [>= rows perm names] values and validity (or
// null: every row valid), live_s: [n] bool sorted; perm: [n] int32 or null
// (values already sorted); frame: host WinFrame; the bounds: [n] int32,
// sorted; pcnt: [n + 1] int64 count prefix (K14) or null without
// out_valid; inv: [n] int32 or null (results in sorted order); out: [n] of
// the values' type; scratch: (3 * n + levels * tiles) int64.
extern "C" int srtpu_frame_minmax(int type, int is_max, const void* vals,
                                  const void* valid, const void* live_s,
                                  const void* perm, long long n,
                                  const WinFrame* frame,
                                  const void* seg_start, const void* seg_end,
                                  const void* peer_start,
                                  const void* peer_end, const void* pcnt,
                                  const void* inv, void* out,
                                  void* out_valid, void* scratch,
                                  int sm_count, void* stream) {
  if (n < 1 || type < kMmI16 || type > kMmI8 ||
      (out_valid != nullptr && pcnt == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const i64 ntiles = (n + 31) >> kMmTileShift;
  const int levels = mm_levels(n);
  long long* keys = (long long*)scratch;
  long long* pre = keys + n;
  long long* suf = pre + n;
  long long* table = suf + n;
  long long warps = ntiles;
  long long blocks = (warps * 32 + kThreads - 1) / kThreads;
  if (blocks > 16LL * sm_count) blocks = 16LL * sm_count;
  mm_build_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
      vals, type, (const uint8_t*)valid, (const uint8_t*)live_s,
      (const int*)perm, n, is_max, keys, pre, suf, table, ntiles);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  for (int l = 1; l < levels; ++l) {
    mm_level_kernel<<<row_blocks(ntiles, sm_count), kThreads, 0, s>>>(
        table + (i64)(l - 1) * ntiles, table + (i64)l * ntiles, ntiles,
        1LL << (l - 1), is_max);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const SegBounds b = {(const int*)seg_start, (const int*)seg_end,
                       (const int*)peer_start, (const int*)peer_end};
  mm_query_kernel<<<row_blocks(n, sm_count), kThreads, 0, s>>>(
      type, is_max, n, *frame, b, keys, pre, suf, table, ntiles,
      (const long long*)pcnt, (const int*)inv, out, (uint8_t*)out_valid);
  return (int)cudaGetLastError();
}
