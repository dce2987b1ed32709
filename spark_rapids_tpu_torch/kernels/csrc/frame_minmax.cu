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
// count prefix. Results land at input rows (perm[j]), as K14 writes its
// own.
//
// Every value maps to an int64 key whose signed order is that order (the
// integer itself; for floats the IEEE total-order bit trick after NaN is
// made canonical, so NaN is above +inf). A row that is null or dead takes
// the key of the integer identity, or for floats INT64_MIN (MAX) / INT64_MAX
// (MIN): above NaN for MIN, so a frame whose least key is NaN or above has
// no valid non-NaN value and its MIN is NaN.
//
// Bound on the H100: bytes. The function moves perm, live_s, the value and
// its validity (through perm) in and the result and its validity out, plus
// the frame's bounds and two count-prefix reads a row: 0.62 ms at range's
// 37,748,736 rows. The value is read through the random perm (a 32-byte
// sector for 8 bytes) and the result lands through it, so the floor is
// K15's random gather plus K14's scattered writes, about 3 ms.
//
// Design: every structure is read in sorted order, and what is reused
// stays small enough for shared memory or the L2.
// 1. Keys: a block a 1,024-row block gathers its rows' values through
//    perm (all loads of a thread issued together) and writes the keys in
//    sorted order, each 32-row subtile's extremum (a warp's shuffles) and
//    the block's (the table's level 0). With perm and the count prefix
//    (which counts the live rows where valid[perm[j]] holds), the keys
//    take "valid and live" from the prefix, read in order, instead of a
//    second random gather.
// 2. Table: a sparse table over the blocks' extrema (37K entries of 16
//    levels at 37.7M rows: 4.7 MB, in the L2), a launch a level (15
//    launches of 1-2 us at 37.7M rows: 0.023 ms in all; building levels
//    1-12 in one launch through shared memory saved 0.003 ms of device
//    time, tools/parent_ab.py, and was not kept).
// 3. Query, in sorted order: a block owns a 1,024-row tile and stages the
//    keys of the tile and of 512 rows on either side in shared memory,
//    with each 32-row subtile's prefix and suffix extremum and a sparse
//    table over the staged subtiles. A frame inside the staged rows is
//    answered there (a suffix, a prefix and two table entries, or a loop
//    of at most 32 keys inside one subtile) and touches nothing else; a
//    longer one adds, for each end outside the staged rows, at most 31
//    keys and 31 subtile extrema of its block from device memory (over a
//    running frame every lane reads the same ones) and two entries of the
//    blocks' table. Bounds, keys and the count prefix are read in order.
// 4. Results: the query writes each row's result bits and validity as one
//    16-byte pair in sorted order, and a last launch reads the pairs
//    through inv (K14's inverse, which the caller has) and writes both
//    outputs in input order: one random 16-byte read a row. Writing both
//    through perm from the query instead (two scattered writes a row)
//    took 2.7 ms more at range's shape (tools/parent_ab.py, 7.30 against
//    4.58 ms without the count-prefix promise).
// Scratch: keys (8 B a row), subtile extrema (n / 4 B), the table and the
// pairs (16 B a row): 0.92 GB at 37.7M rows, freed after the call.

#include <limits.h>

#include "window_frame.cuh"

namespace srtpu {

enum MmType { kMmI16 = 0, kMmI32 = 1, kMmI64 = 2, kMmF32 = 3, kMmF64 = 4,
              kMmBool = 5, kMmI8 = 6 };

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


constexpr int kMmSubShift = 5;        // 32-row subtiles (a warp)
constexpr int kMmBlockShift = 10;     // 1,024-row blocks and query tiles
constexpr int kMmBlockRows = 1 << kMmBlockShift;
constexpr int kMmRows = kMmBlockRows / kThreads;  // rows a thread
constexpr int kMmHalo = 512;          // staged rows on either side
constexpr int kMmWinRows = kMmBlockRows + 2 * kMmHalo;
constexpr int kMmWinSubs = kMmWinRows >> kMmSubShift;  // 64
constexpr int kMmWinLevels = 7;       // spans of 1-64 subtiles
constexpr size_t kMmQuerySmem =
    (3 * kMmWinRows + kMmWinLevels * kMmWinSubs) * sizeof(long long);

// the bits of the result of key k (empty: the frame has no row), in the
// low bytes for the narrower types
__device__ __forceinline__ long long mm_bits(int type, long long k,
                                             bool empty, bool is_max) {
  switch (type) {
    case kMmI8:
      return empty ? (is_max ? SCHAR_MIN : SCHAR_MAX) : k;
    case kMmI16:
      return empty ? (is_max ? SHRT_MIN : SHRT_MAX) : k;
    case kMmI32:
      return empty ? (is_max ? INT_MIN : INT_MAX) : k;
    case kMmI64:
      return empty ? (is_max ? LLONG_MIN : LLONG_MAX) : k;
    case kMmBool:
      return empty ? (is_max ? 0 : 1) : (long long)(k != 0);
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
      return bits;
    }
    default: {
      if (empty)
        return is_max ? (long long)0xFFF0000000000000ULL
                      : 0x7FF0000000000000LL;
      if (k == LLONG_MIN) return (long long)0xFFF0000000000000ULL;
      if (k >= 0x7FF8000000000000LL) return 0x7FF8000000000000LL;
      return k ^ ((k >> 63) & LLONG_MAX);
    }
  }
}

// store result bits at out[i] as the output's type
__device__ __forceinline__ void mm_put(void* out, int type, i64 i,
                                       long long bits) {
  switch (type) {
    case kMmI8:
      ((signed char*)out)[i] = (signed char)bits;
      return;
    case kMmI16:
      ((short*)out)[i] = (short)bits;
      return;
    case kMmI32:
    case kMmF32:
      ((int*)out)[i] = (int)bits;
      return;
    case kMmBool:
      ((uint8_t*)out)[i] = (uint8_t)bits;
      return;
    default:
      ((long long*)out)[i] = bits;
  }
}

__device__ __forceinline__ long long neutral_key(bool is_max) {
  return is_max ? LLONG_MIN : LLONG_MAX;
}

__device__ __forceinline__ long long warp_ext(long long x, bool is_max) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = ext(x, __shfl_xor_sync(kFull, x, off), is_max);
  return x;
}

// Launch 1. Block b owns sorted rows [1,024 b, 1,024 (b + 1)); step i of
// warp w is the subtile of rows 1,024 b + 256 i + 32 w.
__global__ void __launch_bounds__(kThreads)
mm_keys_kernel(const void* __restrict__ vals, int type,
               const uint8_t* __restrict__ valid,
               const uint8_t* __restrict__ live_s,
               const int* __restrict__ perm,
               const long long* __restrict__ pcnt_use, i64 n, int is_max,
               long long* __restrict__ keys, long long* __restrict__ sub,
               long long* __restrict__ blk) {
  __shared__ long long warp_ext_s[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long neutral = neutral_key(is_max);
  const i64 j0 = (i64)blockIdx.x << kMmBlockShift;
  i64 src[kMmRows];
  bool use[kMmRows];
#pragma unroll
  for (int i = 0; i < kMmRows; ++i) {
    const i64 j = j0 + i * kThreads + threadIdx.x;
    src[i] = j;
    use[i] = false;
    if (j < n) {
      use[i] = pcnt_use != nullptr
                   ? __ldcs(pcnt_use + j + 1) != __ldcs(pcnt_use + j)
                   : __ldcs(live_s + j) != 0;
      if (perm != nullptr) src[i] = __ldcs(perm + j);
    }
  }
  if (pcnt_use == nullptr && valid != nullptr) {
#pragma unroll
    for (int i = 0; i < kMmRows; ++i)
      if (use[i]) use[i] = valid[src[i]] != 0;
  }
  long long k[kMmRows];
#pragma unroll
  for (int i = 0; i < kMmRows; ++i) {
    const i64 j = j0 + i * kThreads + threadIdx.x;
    k[i] = j < n ? mm_key(vals, type, src[i], use[i], is_max) : neutral;
  }
  long long e = neutral;
#pragma unroll
  for (int i = 0; i < kMmRows; ++i) {
    const i64 j = j0 + i * kThreads + threadIdx.x;
    if (j < n) keys[j] = k[i];
    const long long t = warp_ext(k[i], is_max);
    const i64 first = j - lane;
    if (lane == 0 && first < n) sub[first >> kMmSubShift] = t;
    e = ext(e, t, is_max);
  }
  if (lane == 0) warp_ext_s[warp] = e;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long r = warp_ext_s[0];
    for (int w = 1; w < kWarps; ++w) r = ext(r, warp_ext_s[w], is_max);
    blk[blockIdx.x] = r;
  }
}

// Launch 2+: level l of the blocks' table from level l - 1: level l at t
// is the extremum of blocks [t, t + 2^l); past nb everything is neutral.
__global__ void __launch_bounds__(kThreads)
mm_level_kernel(const long long* __restrict__ prev, long long* __restrict__ cur,
                i64 nb, i64 half, int is_max) {
  for (i64 t = (i64)blockIdx.x * blockDim.x + threadIdx.x; t < nb;
       t += (i64)gridDim.x * blockDim.x) {
    const long long a = prev[t];
    cur[t] = t + half < nb ? ext(a, prev[t + half], is_max) : a;
  }
}

// the staged window of a query block: rows [w0, w1) of the sorted keys
struct MmWin {
  const long long* key;  // [kMmWinRows]
  const long long* pre;  // extremum from the row's subtile start
  const long long* suf;  // extremum to the row's subtile end
  const long long* tab;  // [kMmWinLevels][kMmWinSubs] over subtiles
  i64 w0, w1;
};

// extremum of staged rows [a, b] (window offsets, a <= b)
__device__ __forceinline__ long long win_range(const MmWin& w, int a, int b,
                                               bool is_max) {
  const int qa = a >> kMmSubShift, qb = b >> kMmSubShift;
  if (qa == qb) {
    if ((a & 31) == 0) return w.pre[b];
    if ((b & 31) == 31) return w.suf[a];
    long long r = w.key[a];
    for (int p = a + 1; p <= b; ++p) r = ext(r, w.key[p], is_max);
    return r;
  }
  long long r = ext(w.suf[a], w.pre[b], is_max);
  if (qb - qa > 1) {
    const int len = qb - qa - 1;
    const int lvl = 31 - __clz(len);
    const long long* row = w.tab + lvl * kMmWinSubs;
    r = ext(r, ext(row[qa + 1], row[qb - (1 << lvl)], is_max), is_max);
  }
  return r;
}

// extremum of rows [s, e] inside one 1,024-row block: from the window
// where it holds them, else from the keys and subtile extrema
__device__ __forceinline__ long long block_part(
    const MmWin& w, const long long* __restrict__ keys,
    const long long* __restrict__ sub, i64 s, i64 e, bool is_max) {
  if (s >= w.w0 && e < w.w1)
    return win_range(w, (int)(s - w.w0), (int)(e - w.w0), is_max);
  const i64 qs = s >> kMmSubShift, qe = e >> kMmSubShift;
  long long r = keys[s];
  if (qs == qe) {
    for (i64 p = s + 1; p <= e; ++p) r = ext(r, keys[p], is_max);
    return r;
  }
  for (i64 p = s + 1; p < ((qs + 1) << kMmSubShift); ++p)
    r = ext(r, keys[p], is_max);
  for (i64 q = qs + 1; q < qe; ++q) r = ext(r, sub[q], is_max);
  for (i64 p = qe << kMmSubShift; p <= e; ++p) r = ext(r, keys[p], is_max);
  return r;
}

// extremum of rows [s, e], s <= e
__device__ __forceinline__ long long range_ext(
    const MmWin& w, const long long* __restrict__ keys,
    const long long* __restrict__ sub, const long long* __restrict__ table,
    i64 nb, i64 s, i64 e, bool is_max) {
  if (s >= w.w0 && e < w.w1)
    return win_range(w, (int)(s - w.w0), (int)(e - w.w0), is_max);
  const i64 bs = s >> kMmBlockShift, be = e >> kMmBlockShift;
  if (bs == be) return block_part(w, keys, sub, s, e, is_max);
  long long r =
      ext(block_part(w, keys, sub, s, ((bs + 1) << kMmBlockShift) - 1,
                     is_max),
          block_part(w, keys, sub, be << kMmBlockShift, e, is_max), is_max);
  if (be - bs > 1) {
    const i64 a = bs + 1, len = be - bs - 1;
    const int lvl = 63 - __clzll((unsigned long long)len);
    const long long* row = table + (i64)lvl * nb;
    r = ext(r, ext(row[a], row[be - (1LL << lvl)], is_max), is_max);
  }
  return r;
}

// Launch 3: a block a 1,024-row tile in sorted order. The results go to
// pairs, or straight to out and out_valid when the values were sorted.
__global__ void __launch_bounds__(kThreads)
mm_query_kernel(int type, int is_max, i64 n, WinFrame f, SegBounds b,
                const long long* __restrict__ keys,
                const long long* __restrict__ sub,
                const long long* __restrict__ table, i64 nb,
                const long long* __restrict__ pcnt, void* __restrict__ out,
                uint8_t* __restrict__ out_valid,
                longlong2* __restrict__ pairs) {
  extern __shared__ long long smem[];
  long long* skey = smem;
  long long* spre = skey + kMmWinRows;
  long long* ssuf = spre + kMmWinRows;
  long long* stab = ssuf + kMmWinRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long neutral = neutral_key(is_max);
  const i64 j0 = (i64)blockIdx.x << kMmBlockShift;
  MmWin w;
  w.w0 = j0 >= kMmHalo ? j0 - kMmHalo : 0;
  w.w1 = j0 + kMmBlockRows + kMmHalo < n ? j0 + kMmBlockRows + kMmHalo : n;
  w.key = skey;
  w.pre = spre;
  w.suf = ssuf;
  w.tab = stab;
  const int wlen = (int)(w.w1 - w.w0);
  for (int q = warp; q < kMmWinSubs; q += kWarps) {
    const int i = (q << kMmSubShift) + lane;
    const long long k = i < wlen ? keys[w.w0 + i] : neutral;
    long long p = k, s = k;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const long long up = __shfl_up_sync(kFull, p, off);
      const long long down = __shfl_down_sync(kFull, s, off);
      if (lane >= off) p = ext(p, up, is_max);
      if (lane + off < 32) s = ext(s, down, is_max);
    }
    skey[i] = k;
    spre[i] = p;
    ssuf[i] = s;
    if (lane == 0) stab[q] = s;
  }
  __syncthreads();
  for (int l = 1; l < kMmWinLevels; ++l) {
    const int half = 1 << (l - 1), q = threadIdx.x;
    if (q < kMmWinSubs) {
      const long long* prev = stab + (l - 1) * kMmWinSubs;
      stab[l * kMmWinSubs + q] =
          q + half < kMmWinSubs ? ext(prev[q], prev[q + half], is_max)
                                : prev[q];
    }
    __syncthreads();
  }
#pragma unroll
  for (int it = 0; it < kMmRows; ++it) {
    const i64 j = j0 + it * kThreads + threadIdx.x;
    if (j >= n) break;
    i64 start, end;
    frame_bounds(f, b, j, start, end);
    const bool empty = end < start;
    long long r = 0;
    if (!empty)
      r = range_ext(w, keys, sub, table, nb, clip(start, 0, n - 1),
                    clip(end, 0, n - 1), is_max);
    const long long bits = mm_bits(type, r, empty, is_max);
    bool ok = false;
    if (out_valid != nullptr && !empty)
      ok = pcnt[clip(end + 1, 0, n)] - pcnt[clip(start, 0, n)] > 0;
    if (pairs != nullptr) {
      pairs[j] = make_longlong2(bits, ok);
    } else {
      mm_put(out, type, j, bits);
      if (out_valid != nullptr) out_valid[j] = ok;
    }
  }
}

// Launch 4 (with perm): out[d] and out_valid[d] from pairs[inv[d]], four
// rows a thread with their loads issued together.
__global__ void __launch_bounds__(kThreads)
mm_gather_kernel(int type, i64 n, const longlong2* __restrict__ pairs,
                 const int* __restrict__ inv, void* __restrict__ out,
                 uint8_t* __restrict__ out_valid) {
  const i64 step = (i64)gridDim.x * kThreads * 4;
  for (i64 base = (i64)blockIdx.x * kThreads * 4 + threadIdx.x; base < n;
       base += step) {
    longlong2 p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const i64 d = base + i * kThreads;
      if (d < n) p[i] = pairs[__ldcs(inv + d)];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const i64 d = base + i * kThreads;
      if (d >= n) continue;
      mm_put(out, type, d, p[i].x);
      if (out_valid != nullptr) out_valid[d] = (uint8_t)p[i].y;
    }
  }
}

}  // namespace srtpu

using namespace srtpu;

// Levels of the blocks' table over n rows: the bit length of the number
// of 1,024-row blocks (ops/windowops.py minmax_plan sizes the scratch by
// it).
static int mm_levels(long long nb) {
  int lv = 1;
  while ((2LL << (lv - 1)) <= nb) ++lv;
  return lv;
}

// type: MmType; vals, valid: [>= rows perm names] values and validity (or
// null: every row valid), live_s: [n] bool sorted; perm: [n] int32 or null
// (values already sorted); frame: host WinFrame; the bounds: [n] int32,
// sorted; pcnt: [n + 1] int64 count prefix (K14) or null without
// out_valid, counting the live rows where valid[perm[j]] holds (with
// perm the keys read "valid and live" from it); inv: [n] int32 perm's inverse (null without perm); out: [n] of the
// values' type; scratch: the int64 words ops/windowops.py minmax_plan
// gives.
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
      (out_valid != nullptr && pcnt == nullptr) ||
      (perm != nullptr) != (inv != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const i64 nsub = (n + 31) >> kMmSubShift;
  const i64 nb = (n + kMmBlockRows - 1) >> kMmBlockShift;
  const int levels = mm_levels(nb);
  long long* keys = (long long*)scratch;
  long long* sub = keys + n;
  long long* table = sub + nsub;
  // the pairs start 16-byte aligned (an even word)
  longlong2* pairs =
      (longlong2*)(keys + ((n + nsub + (i64)levels * nb + 1) & ~1LL));
  mm_keys_kernel<<<(unsigned)nb, kThreads, 0, s>>>(
      vals, type, (const uint8_t*)valid, (const uint8_t*)live_s,
      (const int*)perm, perm != nullptr ? (const long long*)pcnt : nullptr,
      n, is_max, keys, sub, table);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  for (int l = 1; l < levels; ++l) {
    mm_level_kernel<<<row_blocks(nb, sm_count), kThreads, 0, s>>>(
        table + (i64)(l - 1) * nb, table + (i64)l * nb, nb, 1LL << (l - 1),
        is_max);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  // set on every call: the attribute holds for the current device only
  e = cudaFuncSetAttribute(mm_query_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kMmQuerySmem);
  if (e != cudaSuccess) return (int)e;
  const bool gather = perm != nullptr;
  const SegBounds b = {(const int*)seg_start, (const int*)seg_end,
                       (const int*)peer_start, (const int*)peer_end};
  mm_query_kernel<<<(unsigned)nb, kThreads, kMmQuerySmem, s>>>(
      type, is_max, n, *frame, b, keys, sub, table, nb,
      (const long long*)pcnt, out, (uint8_t*)out_valid,
      gather ? pairs : nullptr);
  e = cudaGetLastError();
  if (e != cudaSuccess || !gather) return (int)e;
  mm_gather_kernel<<<row_blocks((n + 3) / 4, sm_count), kThreads, 0, s>>>(
      type, n, pairs, (const int*)inv, out, (uint8_t*)out_valid);
  return (int)cudaGetLastError();
}
