// K14 window_frames: window frame sums and counts, the rank family, and
// the write-back of every result to its input row.
//
// Replaces spark_rapids_tpu/ops/windowops.py:227 _prefix, :234 frame_count,
// :245 frame_sum, :397-433 row_number / rank / dense_rank / percent_rank /
// cume_dist / ntile, and the inverse permutation of sort_for_window (:113)
// with the takes through it that exec/operators.py's TpuWindowExec._run
// does (`to_original`), all of which XLA compiles. Rows are in the
// window's sorted order; perm[j] is the input row at sorted position j.
//
// 1. srtpu_window_prefix: the inclusive prefix p[0] = 0,
//    p[j + 1] = p[j] + c[j] of one contribution vector over the sorted
//    rows, c[j] = live_s[j] and valid[perm[j]] ? vals[perm[j]] : 0 (int64
//    or float64; a count takes 1 for vals), read through perm so the input
//    column needs no gather first; with seg_start (float64 sums) the
//    prefix restarts at each partition, p[j + 1] = c[seg_start[j]] + ... +
//    c[j]. The reference keeps one whole-batch prefix, and a frame's sum,
//    a difference of two prefixes, then loses up to the prefix's rounding
//    (2e-7 relative for a store's first small amount at 37.7M rows).
// 2. srtpu_window_inverse: inv[perm[j]] = j, the reference's `inv`, in
//    passes over destination windows (below).
// 3. srtpu_window_eval: per sorted row j and per requested output, one of
//      row_number   = j - seg_start + 1
//      rank         = peer_start - seg_start + 1
//      dense_rank   = pid[j] - pid[seg_start] + 1   (pid: the peer-run id,
//                     which is the reference's cumsum of new peer runs - 1)
//      percent_rank = len > 1 ? (rank - 1) / max(len - 1, 1) : 0
//      cume_dist    = (peer_end - seg_start + 1) / len
//      ntile(k)     = the reference's integer arithmetic over
//                     idx = j - seg_start, q = len / k, r = len % k (floor
//                     division, as jnp's //, also where len <= 0)
//      frame sum / count / average over [start, end]:
//                   p[clip(end + 1, 0, n)] - p[clip(start, 0, n)] (a
//                   restarted float64 prefix takes 0 for the second term
//                   where start is the partition's first row), or 0
//                   where end < start, with validity count > 0 (sum,
//                   average) or always (count)
//    with len = seg_end - seg_start + 1 and the frame's sides as
//    window_frame.cuh resolves them; with inv each result lands at its
//    input row (out[i] is sorted row inv[i]'s), else at j: the reference's
//    scatter of the positions into its inverse permutation followed by a
//    take.
//
// Bound on the H100: bytes. For the window query over 37.7M rows
// (row_number, rank, dense_rank and a running sum of a double) the
// evaluation reads inv, seg_start, peer_start, peer_end, pid and both
// prefixes and writes three int32 and one float64 column with their
// validity: 60 bytes a row, 0.68 ms at 3.35 TB/s.
//
// Design: the prefix is K1's three-launch tile scan (tile sums, which also
// park c[j] in p[j + 1]; one block scans the tile sums; each tile scans its
// parked values in place), in a fixed order, so it is deterministic; the
// restarted prefix scans (restart flag, value) pairs the same way, a tile
// carrying out its sum from its last partition start. The inverse
// permutation is scattered once per window (K15-K17 read it too). The
// evaluation takes two launches with inv, one without. Launch 1, in
// sorted order: a thread a sorted row j reads its bounds coalesced, its
// prefix entries near j and pid[seg_start] (shared by the partition's
// rows, so cached), evaluates up to eight outputs (their descriptors in
// parameter space) and, without inv, writes them at j; with inv it packs
// them into one 32-byte record a row (16 where they fit; more records
// where they pass 32 bytes), each value at the slot ops/windowops.py
// record_layout gives it and the validity bits in a word of the last
// record, and writes each record whole, one sector. Launch 2, in input
// order: a thread an input row i reads inv[i] coalesced and the records
// of sorted row inv[i], one random sector each, and writes every output
// and validity at i coalesced. So the random traffic is one sector a row
// and record. Reading the bounds and prefixes through inv, one thread an
// input row (the design before this one), took 8-10 random sectors a row,
// 8.35 ms at 37.7M rows for the window query's four outputs; writing every
// output through perm (four data and four validity writes a row, each a
// read-modify-write of a 32-byte sector), 20.6 ms.
//
// The inverse alone is bound by bytes too: perm read once, inv written
// once, 8 bytes a row (0.0902 ms at 37,748,736 rows). Its stores land on
// random 4-byte slots of inv; at 37.7M rows inv is 151 MB, three times
// the 50 MB L2, so in one pass a 32-byte sector leaves the L2 long before
// its neighbours arrive and nearly every store becomes its own partial
// sector write to device memory: one pass took 0.069 ns a row at
// 37,748,736 rows (2.35-2.61 ms) and 0.0585 at 2^24, against 0.0165 at
// 2^22, whose 16 MiB of inv stay in the L2 (H100 80GB HBM3, 700.00 W;
// tools/parent_ab.py). So the inverse runs in passes (one launch each):
// pass p reads all of perm with evict-first loads and stores only the j
// whose perm[j] lies in destination window p, with an L2 evict-last
// hint, so the window's lines stay in the L2 until they are whole and
// then go to device memory once. A window is INVERSE_WINDOW_ROWS rows of
// ops/windowops.py (32 MiB; its sweep is beside it); at most one window,
// one pass. 37,748,736 rows take 5 passes: 1.03 ms over a random
// permutation, 0.99 over range_query's (argsort(perm) 1.92). What is
// left is the L2's rate of scattered 4-byte stores (~40-60 G/s), which
// no window size changes: 2^24 rows take 0.40-0.47 ms in 2 to 8 passes.
// Plain stores lost the windows' lines past 24 MiB (1.15 ms at 32 MiB).

#include "window_frame.cuh"

namespace srtpu {

enum WinKind {
  kRowNumber = 0, kRank = 1, kDenseRank = 2, kSumF64 = 3, kSumI64 = 4,
  kCount = 5, kAvg = 6, kPercentRank = 7, kCumeDist = 8, kNtile = 9
};

struct WinOut {
  int kind;           // WinKind
  int start_kind;     // WinBound: seg_start, peer_start, j + lower, given
  int end_kind;       // WinBound: seg_end, peer_end, j + upper, given
  int slot;           // byte of its value in the row's records (with inv)
  long long lower;    // offsets of kOffset bounds; ntile's bucket count
  long long upper;
  const int* start;   // given bounds (kGiven)
  const int* end;
  const void* psum;   // [n + 1] float64 or int64 prefix (sums, averages)
  const long long* pcnt;  // [n + 1] int64 count prefix (counts, averages;
                          // a sum's validity, none without it)
  void* out;          // [n] int32 (ranks, ntile), float64 or int64
  uint8_t* out_valid;  // [n] bool, or null
};

constexpr int kMaxWinOuts = 8;

struct WinOuts {
  WinOut o[kMaxWinOuts];
};

template <typename T>
__device__ __forceinline__ T block_inclusive_scan(T v, T* warp_tot,
                                                  T& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T inc = warp_inclusive_scan(v);
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  T before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const T t = warp_tot[w];
    if (w < warp) before += t;
    total += t;
  }
  return before + inc;
}

// launch 1: park c[j] in p[j + 1], sum every tile
template <typename T>
__global__ void __launch_bounds__(kThreads)
prefix_park_kernel(const T* __restrict__ vals,
                   const uint8_t* __restrict__ valid,
                   const uint8_t* __restrict__ live_s,
                   const int* __restrict__ perm, i64 n, T* __restrict__ p,
                   T* __restrict__ sums) {
  __shared__ T warp_tot[kWarps];
  const i64 base = (i64)blockIdx.x * kTile;
  T s = 0;
  for (int r = 0; r < kItems; ++r) {
    const i64 j = base + r * kThreads + threadIdx.x;
    if (j >= n) break;
    T c = 0;
    if (live_s[j]) {
      const i64 src = perm != nullptr ? (i64)perm[j] : j;
      if (valid == nullptr || valid[src]) c = vals != nullptr ? vals[src] : T(1);
    }
    p[j + 1] = c;
    s += c;
  }
  s = warp_sum(s);
  if ((threadIdx.x & 31) == 0) warp_tot[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    T t = 0;
    for (int w = 0; w < kWarps; ++w) t += warp_tot[w];
    sums[blockIdx.x] = t;
  }
}

// launch 3: each tile turns its parked values into the inclusive prefix
template <typename T>
__global__ void __launch_bounds__(kThreads)
prefix_scan_kernel(i64 n, const T* __restrict__ offsets, T* __restrict__ p) {
  __shared__ T warp_tot[2][kWarps];
  const i64 base = (i64)blockIdx.x * kTile;
  T carry = offsets[blockIdx.x];
  if (blockIdx.x == 0 && threadIdx.x == 0) p[0] = 0;
  for (int r = 0; r < kItems; ++r) {
    const i64 j = base + r * kThreads + threadIdx.x;
    if (base + r * kThreads >= n) break;  // uniform across the block
    const T c = j < n ? p[j + 1] : T(0);
    T tot;
    const T inc = block_inclusive_scan(c, warp_tot[r & 1], tot);
    if (j < n) p[j + 1] = carry + inc;
    carry += tot;
  }
}

// Inclusive scan of (flag, value) pairs in thread order over a block of
// NW warps, where a flag restarts the sum at its row: returns the row's
// sum since the last flag at or before it (or since the block's first
// row), with `f` set when there was one; tot_f / tot_v: the block's pair.
// As block_exclusive_scan, successive calls alternate between two pairs
// of warp buffers.
template <typename T, int NW>
__device__ __forceinline__ T block_seg_scan(int& f, T v, int* warp_f,
                                            T* warp_v, int& tot_f,
                                            T& tot_v) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const T vo = __shfl_up_sync(kFull, v, off);
    const int fo = __shfl_up_sync(kFull, f, off);
    if (lane >= off) {
      if (!f) v = vo + v;
      f |= fo;
    }
  }
  if (lane == 31) {
    warp_f[warp] = f;
    warp_v[warp] = v;
  }
  __syncthreads();
  int pf = 0;
  T pv = 0;
  tot_f = 0;
  tot_v = 0;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    const int wf = warp_f[w];
    const T wv = warp_v[w];
    if (w < warp) {
      pv = wf ? wv : pv + wv;
      pf |= wf;
    }
    tot_v = wf ? wv : tot_v + wv;
    tot_f |= wf;
  }
  const T out = f ? v : pv + v;
  f |= pf;
  return out;
}

// Partition-restarted prefix (seg_start given), launch 1: park c[j] in
// p[j + 1]; per tile the sum from its last partition start on (the whole
// tile without one) and whether it holds a start.
template <typename T>
__global__ void __launch_bounds__(kThreads)
prefix_park_seg_kernel(const T* __restrict__ vals,
                       const uint8_t* __restrict__ valid,
                       const uint8_t* __restrict__ live_s,
                       const int* __restrict__ perm,
                       const int* __restrict__ seg_start, i64 n,
                       T* __restrict__ p, T* __restrict__ sums,
                       uint8_t* __restrict__ flags) {
  __shared__ T warp_tot[kWarps];
  __shared__ long long warp_last[kWarps];
  const i64 base = (i64)blockIdx.x * kTile;
  T cl[kItems];
  long long last = -1;
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const i64 j = base + r * kThreads + threadIdx.x;
    T c = 0;
    if (j < n) {
      if (live_s[j]) {
        const i64 src = perm != nullptr ? (i64)perm[j] : j;
        if (valid == nullptr || valid[src])
          c = vals != nullptr ? vals[src] : T(1);
      }
      p[j + 1] = c;
      if (seg_start[j] == j) last = j;
    }
    cl[r] = c;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const long long o = __shfl_down_sync(kFull, last, off);
    if (o > last) last = o;
  }
  if ((threadIdx.x & 31) == 0) warp_last[threadIdx.x >> 5] = last;
  __syncthreads();
  long long tile_last = -1;
  for (int w = 0; w < kWarps; ++w)
    if (warp_last[w] > tile_last) tile_last = warp_last[w];
  T s = 0;
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const i64 j = base + r * kThreads + threadIdx.x;
    if (j >= tile_last) s += cl[r];
  }
  s = warp_sum(s);
  if ((threadIdx.x & 31) == 0) warp_tot[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    T t = 0;
    for (int w = 0; w < kWarps; ++w) t += warp_tot[w];
    sums[blockIdx.x] = t;
    flags[blockIdx.x] = tile_last >= 0;
  }
}

// launch 2, in ONE block: after[t] = the sum carried out of tile t
// (restarted at the tile's last start, if it holds one)
template <typename T>
__global__ void __launch_bounds__(kScanThreads)
seg_scan_tiles_kernel(const T* __restrict__ sums,
                      const uint8_t* __restrict__ flags, int tiles,
                      T* __restrict__ after) {
  __shared__ int warp_f[2][kScanThreads / 32];
  __shared__ T warp_v[2][kScanThreads / 32];
  T carry = 0;
  int round = 0;
  for (int base = 0; base < tiles; base += kScanThreads, ++round) {
    const int i = base + threadIdx.x;
    int f = i < tiles ? flags[i] : 0;
    const T v = i < tiles ? sums[i] : T(0);
    int tf;
    T tv;
    const T inc = block_seg_scan<T, kScanThreads / 32>(
        f, v, warp_f[round & 1], warp_v[round & 1], tf, tv);
    if (i < tiles) after[i] = f ? inc : carry + inc;
    carry = tf ? tv : carry + tv;
  }
}

// launch 3: each tile turns its parked values into the prefix restarted
// at each partition start, carrying in the tile before's sum
template <typename T>
__global__ void __launch_bounds__(kThreads)
prefix_seg_scan_kernel(i64 n, const int* __restrict__ seg_start,
                       const T* __restrict__ after, T* __restrict__ p) {
  __shared__ int warp_f[2][kWarps];
  __shared__ T warp_v[2][kWarps];
  const i64 base = (i64)blockIdx.x * kTile;
  T carry = blockIdx.x == 0 ? T(0) : after[blockIdx.x - 1];
  if (blockIdx.x == 0 && threadIdx.x == 0) p[0] = 0;
  for (int r = 0; r < kItems; ++r) {
    const i64 j = base + r * kThreads + threadIdx.x;
    if (base + r * kThreads >= n) break;  // uniform across the block
    int f = j < n && seg_start[j] == j;
    const T c = j < n ? p[j + 1] : T(0);
    int tf;
    T tv;
    const T inc = block_seg_scan<T, kWarps>(f, c, warp_f[r & 1],
                                            warp_v[r & 1], tf, tv);
    if (j < n) p[j + 1] = f ? inc : carry + inc;
    carry = tf ? tv : carry + tv;
  }
}

template <typename T>
int window_prefix(const T* vals, const uint8_t* valid,
                  const uint8_t* live_s, const int* perm,
                  const int* seg_start, i64 n, T* p, T* scratch,
                  uint8_t* flags, cudaStream_t s) {
  const int tiles = num_tiles(n);
  T* sums = scratch;
  T* offsets = scratch + tiles;
  T* total = scratch + 2 * tiles;
  cudaError_t e;
  if (seg_start != nullptr) {
    prefix_park_seg_kernel<T><<<tiles, kThreads, 0, s>>>(
        vals, valid, live_s, perm, seg_start, n, p, sums, flags);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    seg_scan_tiles_kernel<T><<<1, kScanThreads, 0, s>>>(sums, flags, tiles,
                                                        offsets);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    prefix_seg_scan_kernel<T><<<tiles, kThreads, 0, s>>>(n, seg_start,
                                                         offsets, p);
    return (int)cudaGetLastError();
  }
  prefix_park_kernel<T><<<tiles, kThreads, 0, s>>>(vals, valid, live_s,
                                                   perm, n, p, sums);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scan_tiles_kernel<T><<<1, kScanThreads, 0, s>>>(sums, tiles, offsets,
                                                  total);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  prefix_scan_kernel<T><<<tiles, kThreads, 0, s>>>(n, offsets, p);
  return (int)cudaGetLastError();
}

__device__ __forceinline__ i64 floordiv(i64 a, i64 b) {
  const i64 q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// inv[d] = j with an L2 evict-last hint (policy from createpolicy)
__device__ __forceinline__ void store_evict_last(int* p, int v,
                                                 unsigned long long policy) {
  asm volatile("st.global.L2::cache_hint.b32 [%0], %1, %2;"
               :: "l"(p), "r"(v), "l"(policy) : "memory");
}

// One pass of the inverse: inv[perm[j]] = j for the j whose perm[j] lies
// in the destination window [lo, lo + span). perm is read with evict-first
// loads, four rows a thread where it is 16-byte aligned, and inv written
// with evict-last stores, so the window's lines of inv stay in the L2
// until they are whole.
__global__ void __launch_bounds__(kThreads)
inverse_pass_kernel(const int* __restrict__ perm, i64 n, int lo,
                    unsigned span, int* __restrict__ inv) {
  const i64 stride = (i64)gridDim.x * blockDim.x;
  const i64 t = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  unsigned long long keep;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
               : "=l"(keep));
  i64 head = 0;  // rows before it were read four at a time
  if ((reinterpret_cast<uintptr_t>(perm) & 15) == 0) {
    const i64 quads = n >> 2;
    const int4* p4 = reinterpret_cast<const int4*>(perm);
    for (i64 q = t; q < quads; q += stride) {
      const int4 d = __ldcs(p4 + q);
      const int j = (int)(q << 2);
      if ((unsigned)(d.x - lo) < span) store_evict_last(inv + d.x, j, keep);
      if ((unsigned)(d.y - lo) < span)
        store_evict_last(inv + d.y, j + 1, keep);
      if ((unsigned)(d.z - lo) < span)
        store_evict_last(inv + d.z, j + 2, keep);
      if ((unsigned)(d.w - lo) < span)
        store_evict_last(inv + d.w, j + 3, keep);
    }
    head = quads << 2;
  }
  for (i64 j = head + t; j < n; j += stride) {
    const int d = __ldcs(perm + j);
    if ((unsigned)(d - lo) < span) store_evict_last(inv + d, (int)j, keep);
  }
}

// the value of output o at sorted row j (an int32 in the low word, a
// float64 or an int64 as its bits) and, in ok, its validity: the
// reference's formulas (file comment, 3.)
__device__ __forceinline__ unsigned long long eval_one(
    const WinOut& o, i64 j, i64 ss, i64 n, const SegBounds& b,
    const int* __restrict__ pid, bool& ok) {
  ok = true;
  if (o.kind <= kDenseRank || o.kind == kNtile) {
    int v;
    if (o.kind == kRowNumber) {
      v = (int)(j - ss + 1);
    } else if (o.kind == kRank) {
      v = (int)(b.peer_start[j] - ss + 1);
    } else if (o.kind == kDenseRank) {
      v = pid[j] - pid[clip(ss, 0, n - 1)] + 1;
    } else {
      const i64 len = b.seg_end[j] - ss + 1, idx = j - ss;
      const i64 q = floordiv(len, o.lower), r = len - q * o.lower;
      const i64 threshold = r * (q + 1);
      v = (int)((idx < threshold
                     ? floordiv(idx, q + 1 > 1 ? q + 1 : 1)
                     : r + floordiv(idx - threshold, q > 1 ? q : 1)) +
                1);
    }
    return (unsigned)v;
  }
  if (o.kind == kPercentRank || o.kind == kCumeDist) {
    const i64 len = b.seg_end[j] - ss + 1;
    double v;
    if (o.kind == kPercentRank)
      v = len > 1 ? (double)(b.peer_start[j] - ss) / (double)(len - 1)
                  : 0.0;
    else
      v = (double)(b.peer_end[j] - ss + 1) / (double)len;
    return (unsigned long long)__double_as_longlong(v);
  }
  i64 start, end;
  frame_bounds(o.start_kind, o.end_kind, o.lower, o.upper, o.start, o.end,
               b, j, start, end);
  const bool any = end >= start;
  const i64 hi = clip(end + 1, 0, n), lo = clip(start, 0, n);
  const long long cnt =
      any && o.pcnt != nullptr ? o.pcnt[hi] - o.pcnt[lo] : 0;
  ok = cnt > 0;
  // a float64 prefix restarts at the partition: below its start, 0
  if (o.kind == kSumF64) {
    const double* ps = (const double*)o.psum;
    return (unsigned long long)__double_as_longlong(
        any ? ps[hi] - (lo == ss ? 0.0 : ps[lo]) : 0.0);
  }
  if (o.kind == kSumI64) {
    const long long* ps = (const long long*)o.psum;
    return (unsigned long long)(any ? ps[hi] - ps[lo] : 0);
  }
  if (o.kind == kCount) {
    ok = true;
    return (unsigned long long)cnt;
  }
  const double* ps = (const double*)o.psum;  // kAvg
  const double sum = any ? ps[hi] - (lo == ss ? 0.0 : ps[lo]) : 0.0;
  return (unsigned long long)__double_as_longlong(
      sum / (double)(cnt > 1 ? cnt : 1));
}

__device__ __forceinline__ bool wide_out(int kind) {
  return !(kind <= kDenseRank || kind == kNtile);
}

__device__ __forceinline__ void store_out(const WinOut& o, i64 dst,
                                          unsigned long long bits,
                                          bool ok) {
  if (wide_out(o.kind))
    ((unsigned long long*)o.out)[dst] = bits;
  else
    ((int*)o.out)[dst] = (int)(unsigned)bits;
  if (o.out_valid != nullptr) o.out_valid[dst] = ok;
}

// w[q] = v for the one q == at, w kept in registers
__device__ __forceinline__ void put_word(uint32_t (&w)[8], int at,
                                         uint32_t v) {
#pragma unroll
  for (int q = 0; q < 8; ++q)
    if (q == at) w[q] = v;
}

__device__ __forceinline__ uint32_t get_word(const uint32_t (&w)[8],
                                             int at) {
  uint32_t v = 0;
#pragma unroll
  for (int q = 0; q < 8; ++q)
    if (q == at) v = w[q];
  return v;
}

// Launch 1, sorted order: one thread a sorted row j evaluates every
// output; without records it writes them at j, with records it packs them
// into the row's records (each output's value at its slot, the validity
// bits in the last record's valid word) and writes each record whole.
__global__ void __launch_bounds__(kThreads)
window_eval_sorted(WinOuts outs, int nouts, i64 n, SegBounds b,
                   const int* __restrict__ pid, uint32_t* __restrict__ rec,
                   int rec_words, int nrec, int valid_slot) {
  for (i64 j = (i64)blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += (i64)gridDim.x * blockDim.x) {
    const i64 ss = b.seg_start[j];
    if (rec == nullptr) {
      for (int k = 0; k < nouts; ++k) {
        bool ok;
        const unsigned long long v = eval_one(outs.o[k], j, ss, n, b, pid,
                                              ok);
        store_out(outs.o[k], j, v, ok);
      }
      continue;
    }
    uint32_t vbits = 0;
    for (int r = 0; r < nrec; ++r) {
      uint32_t w[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      for (int k = 0; k < nouts; ++k) {
        const WinOut& o = outs.o[k];
        if ((o.slot >> 5) != r) continue;
        bool ok;
        const unsigned long long v = eval_one(o, j, ss, n, b, pid, ok);
        vbits |= (uint32_t)ok << k;
        const int at = (o.slot & 31) >> 2;
        put_word(w, at, (uint32_t)v);
        if (wide_out(o.kind)) put_word(w, at + 1, (uint32_t)(v >> 32));
      }
      if (valid_slot >= 0 && (valid_slot >> 5) == r)
        put_word(w, (valid_slot & 31) >> 2, vbits);
      uint4* dst = reinterpret_cast<uint4*>(rec + ((i64)r * n + j) *
                                                      rec_words);
      dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
      if (rec_words == 8) dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
    }
  }
}

// Launch 2, input order: one thread an input row i reads inv[i] and the
// records of sorted row inv[i], last record (the valid word) first, and
// writes every output at i.
__global__ void __launch_bounds__(kThreads)
window_eval_gather(WinOuts outs, int nouts, i64 n,
                   const int* __restrict__ inv,
                   const uint32_t* __restrict__ rec, int rec_words,
                   int nrec, int valid_slot) {
  for (i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (i64)gridDim.x * blockDim.x) {
    const i64 j = __ldcs(inv + i);
    uint32_t vbits = 0xFFu;
    for (int r = nrec - 1; r >= 0; --r) {
      const uint4* src =
          reinterpret_cast<const uint4*>(rec + ((i64)r * n + j) * rec_words);
      const uint4 a = __ldcs(src);
      const uint4 c = rec_words == 8 ? __ldcs(src + 1)
                                     : make_uint4(0, 0, 0, 0);
      const uint32_t w[8] = {a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w};
      if (valid_slot >= 0 && (valid_slot >> 5) == r)
        vbits = get_word(w, (valid_slot & 31) >> 2);
      for (int k = 0; k < nouts; ++k) {
        const WinOut& o = outs.o[k];
        if ((o.slot >> 5) != r) continue;
        const int at = (o.slot & 31) >> 2;
        unsigned long long v = get_word(w, at);
        if (wide_out(o.kind))
          v |= (unsigned long long)get_word(w, at + 1) << 32;
        store_out(o, i, v, (vbits >> k) & 1u);
      }
    }
  }
}

}  // namespace srtpu

using namespace srtpu;

// is_f64: float64 values and prefix, else int64; vals: [>= rows perm
// names] or null (a count: c = 1); valid: [same] bool or null; live_s: [n]
// bool, sorted order; perm: [n] int32 or null (values already sorted);
// seg_start: [n] int32 or null (the prefix restarts at each row j with
// seg_start[j] == j); p: [n + 1]; scratch: 2 * ceil(n / 4096) + 1 values
// of the prefix's type; flags: ceil(n / 4096) bytes (with seg_start).
extern "C" int srtpu_window_prefix(int is_f64, const void* vals,
                                   const void* valid, const void* live_s,
                                   const void* perm, const void* seg_start,
                                   long long n, void* p, void* scratch,
                                   void* flags, void* stream) {
  if (n < 1 || (seg_start != nullptr && flags == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_f64)
    return window_prefix<double>(
        (const double*)vals, (const uint8_t*)valid, (const uint8_t*)live_s,
        (const int*)perm, (const int*)seg_start, n, (double*)p,
        (double*)scratch, (uint8_t*)flags, s);
  return window_prefix<long long>(
      (const long long*)vals, (const uint8_t*)valid, (const uint8_t*)live_s,
      (const int*)perm, (const int*)seg_start, n, (long long*)p,
      (long long*)scratch, (uint8_t*)flags, s);
}

// perm: [n] int32, a permutation of [0, n); inv: [n] int32 out. One pass:
// inv[perm[j]] = j for each j with lo <= perm[j] < hi (the wrapper runs
// one pass a window of windowops.inverse_windows, which cover [0, n)).
extern "C" int srtpu_window_inverse(const void* perm, long long n, void* inv,
                                    long long lo, long long hi, int sm_count,
                                    void* stream) {
  if (n < 1 || n > 0x7fffffffLL || lo < 0 || hi <= lo || hi > n)
    return (int)cudaErrorInvalidValue;
  inverse_pass_kernel<<<row_blocks((n + 3) / 4, sm_count), kThreads, 0,
                        (cudaStream_t)stream>>>(
      (const int*)perm, n, (int)lo, (unsigned)(hi - lo), (int*)inv);
  return (int)cudaGetLastError();
}

// outs: host array of nouts WinOut (at most 8); the bounds and pid: [n]
// int32, sorted order; inv: [n] int32 (srtpu_window_inverse's), or null
// (results in sorted order, one launch). With inv, rec: nrec * n records
// of rec_words (4 or 8) uint32 scratch, each output's value at byte
// WinOut.slot of its row's records (slot / 32: the record) and, where
// valid_slot >= 0, bit k of the word at valid_slot (in the last record)
// output k's validity (ops/windowops.py record_layout).
extern "C" int srtpu_window_eval(const WinOut* outs, int nouts, long long n,
                                 const void* seg_start, const void* seg_end,
                                 const void* peer_start, const void* peer_end,
                                 const void* pid, const void* inv, void* rec,
                                 int rec_words, int nrec, int valid_slot,
                                 int sm_count, void* stream) {
  if (nouts < 1 || nouts > kMaxWinOuts || n < 1 ||
      (inv != nullptr &&
       (rec == nullptr || nrec < 1 || (rec_words != 4 && rec_words != 8) ||
        (valid_slot >= 0 && (valid_slot >> 5) != nrec - 1) ||
        (rec_words == 4 && nrec != 1))))
    return (int)cudaErrorInvalidValue;
  WinOuts t = {};
  for (int k = 0; k < nouts; ++k) {
    t.o[k] = outs[k];
    if (outs[k].kind == kNtile && outs[k].lower < 1)
      return (int)cudaErrorInvalidValue;
    if (inv != nullptr &&
        (outs[k].slot < 0 || outs[k].slot >= nrec * 32 ||
         (outs[k].slot & 31) + (outs[k].kind <= kDenseRank ||
                                        outs[k].kind == kNtile
                                    ? 4
                                    : 8) > 4 * rec_words))
      return (int)cudaErrorInvalidValue;
  }
  const SegBounds b = {(const int*)seg_start, (const int*)seg_end,
                       (const int*)peer_start, (const int*)peer_end};
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned blocks = row_blocks(n, sm_count);
  window_eval_sorted<<<blocks, kThreads, 0, s>>>(
      t, nouts, n, b, (const int*)pid,
      inv != nullptr ? (uint32_t*)rec : nullptr, rec_words, nrec,
      valid_slot);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || inv == nullptr) return (int)err;
  window_eval_gather<<<blocks, kThreads, 0, s>>>(
      t, nouts, n, (const int*)inv, (const uint32_t*)rec, rec_words, nrec,
      valid_slot);
  return (int)cudaGetLastError();
}
