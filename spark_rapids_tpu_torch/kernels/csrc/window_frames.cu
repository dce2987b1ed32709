// K14 window_frames: window frame sums and counts, the rank family, and
// the write-back of every result to its input row.
//
// Replaces spark_rapids_tpu/ops/windowops.py:227 _prefix, :234 frame_count,
// :245 frame_sum, :397-411 row_number / rank / dense_rank, and the inverse
// permutation of sort_for_window (:113) with the takes through it that
// exec/operators.py's TpuWindowExec._run does (`to_original`), all of
// which XLA compiles. Rows are in the window's sorted order; perm[j] is
// the input row at sorted position j.
//
// 1. srtpu_window_prefix: the inclusive prefix p[0] = 0,
//    p[j + 1] = p[j] + c[j] of one contribution vector over the sorted
//    rows, c[j] = live_s[j] and valid[perm[j]] ? vals[perm[j]] : 0 (int64
//    or float64; a count takes 1 for vals), read through perm so the input
//    column needs no gather first.
// 2. srtpu_window_eval: per sorted row j and per requested output, one of
//      row_number = j - seg_start + 1
//      rank       = peer_start - seg_start + 1
//      dense_rank = pid[j] - pid[seg_start] + 1   (pid: the peer-run id,
//                   which is the reference's cumsum of new peer runs - 1)
//      frame sum / count / average over [start, end]:
//                   p[clip(end + 1, 0, n)] - p[clip(start, 0, n)], or 0
//                   where end < start, with validity count > 0 (sum,
//                   average) or always (count)
//    where start is seg_start, peer_start, max(j + lower, seg_start) or a
//    given array, and end is seg_end, peer_end, min(j + upper, seg_end) or
//    a given array; with perm each result lands at its input row perm[j]
//    (else at j): the reference's scatter of the positions into its
//    inverse permutation followed by a take.
//
// Bound on the H100: bytes. For the window query over 36M rows (row_number,
// rank, dense_rank and a running sum of a double) the function reads perm,
// the live mask, seg_start, peer_start, peer_end, pid and the summed column
// with its validity, and writes three int32 and one float64 column with
// their validity: about 54 bytes a row, 0.58 ms at 3.35 TB/s.
//
// Design: the prefix is K1's three-launch tile scan (tile sums, which also
// park c[j] in p[j + 1]; one block scans the tile sums; each tile scans its
// parked values in place), in a fixed order, so it is deterministic. The
// evaluation writes in input order: one launch scatters the inverse
// permutation (inv[perm[j]] = j, the reference's `inv`), then one thread an
// input row i evaluates sorted row inv[i] for up to eight outputs (their
// descriptors in parameter space) and writes out[i]. So the random access
// is one 4-byte write and a few reads a row; writing every output through
// perm (four data and four validity writes a row, each a read-modify-write
// of a 32-byte sector) took 20.6 ms at 37.7M rows on the H100, 30x its
// bound.

#include "common.cuh"

namespace srtpu {

enum WinKind {
  kRowNumber = 0, kRank = 1, kDenseRank = 2, kSumF64 = 3, kSumI64 = 4,
  kCount = 5, kAvg = 6
};
enum WinBound { kSeg = 0, kPeer = 1, kOffset = 2, kGiven = 3 };

struct WinOut {
  int kind;           // WinKind
  int start_kind;     // WinBound: seg_start, peer_start, j + lower, given
  int end_kind;       // WinBound: seg_end, peer_end, j + upper, given
  int pad;
  long long lower;    // offsets of kOffset bounds
  long long upper;
  const int* start;   // given bounds (kGiven)
  const int* end;
  const void* psum;   // [n + 1] float64 or int64 prefix (sums, averages)
  const long long* pcnt;  // [n + 1] int64 count prefix (counts, averages;
                          // a sum's validity, none without it)
  void* out;          // [n] int32 (ranks), float64 or int64
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

template <typename T>
int window_prefix(const T* vals, const uint8_t* valid,
                  const uint8_t* live_s, const int* perm, i64 n, T* p,
                  T* scratch, cudaStream_t s) {
  const int tiles = num_tiles(n);
  T* sums = scratch;
  T* offsets = scratch + tiles;
  T* total = scratch + 2 * tiles;
  prefix_park_kernel<T><<<tiles, kThreads, 0, s>>>(vals, valid, live_s,
                                                   perm, n, p, sums);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scan_tiles_kernel<T><<<1, kScanThreads, 0, s>>>(sums, tiles, offsets,
                                                  total);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  prefix_scan_kernel<T><<<tiles, kThreads, 0, s>>>(n, offsets, p);
  return (int)cudaGetLastError();
}

__device__ __forceinline__ i64 clip(i64 v, i64 lo, i64 hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void __launch_bounds__(kThreads)
inverse_kernel(const int* __restrict__ perm, i64 n, int* __restrict__ inv) {
  for (i64 j = (i64)blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += (i64)gridDim.x * blockDim.x)
    inv[perm[j]] = (int)j;
}

__global__ void __launch_bounds__(kThreads)
window_eval_kernel(WinOuts outs, int nouts, i64 n,
                   const int* __restrict__ seg_start,
                   const int* __restrict__ seg_end,
                   const int* __restrict__ peer_start,
                   const int* __restrict__ peer_end,
                   const int* __restrict__ pid,
                   const int* __restrict__ inv) {
  for (i64 dst = (i64)blockIdx.x * blockDim.x + threadIdx.x; dst < n;
       dst += (i64)gridDim.x * blockDim.x) {
    const i64 j = inv != nullptr ? (i64)inv[dst] : dst;
    const i64 ss = seg_start[j];
    for (int k = 0; k < nouts; ++k) {
      const WinOut& o = outs.o[k];
      if (o.kind <= kDenseRank) {
        int v;
        if (o.kind == kRowNumber)
          v = (int)(j - ss + 1);
        else if (o.kind == kRank)
          v = (int)(peer_start[j] - ss + 1);
        else
          v = pid[j] - pid[clip(ss, 0, n - 1)] + 1;
        ((int*)o.out)[dst] = v;
        if (o.out_valid != nullptr) o.out_valid[dst] = 1;
        continue;
      }
      i64 start, end;
      switch (o.start_kind) {
        case kSeg: start = ss; break;
        case kPeer: start = peer_start[j]; break;
        case kOffset: start = j + o.lower > ss ? j + o.lower : ss; break;
        default: start = o.start[j];
      }
      switch (o.end_kind) {
        case kSeg: end = seg_end[j]; break;
        case kPeer: end = peer_end[j]; break;
        case kOffset: {
          const i64 se = seg_end[j];
          end = j + o.upper < se ? j + o.upper : se;
          break;
        }
        default: end = o.end[j];
      }
      const bool any = end >= start;
      const i64 hi = clip(end + 1, 0, n), lo = clip(start, 0, n);
      const long long cnt =
          any && o.pcnt != nullptr ? o.pcnt[hi] - o.pcnt[lo] : 0;
      bool ok = cnt > 0;
      if (o.kind == kSumF64) {
        const double* ps = (const double*)o.psum;
        ((double*)o.out)[dst] = any ? ps[hi] - ps[lo] : 0.0;
      } else if (o.kind == kSumI64) {
        const long long* ps = (const long long*)o.psum;
        ((long long*)o.out)[dst] = any ? ps[hi] - ps[lo] : 0;
      } else if (o.kind == kCount) {
        ((long long*)o.out)[dst] = cnt;
        ok = true;
      } else {  // kAvg
        const double* ps = (const double*)o.psum;
        const double sum = any ? ps[hi] - ps[lo] : 0.0;
        ((double*)o.out)[dst] = sum / (double)(cnt > 1 ? cnt : 1);
      }
      if (o.out_valid != nullptr) o.out_valid[dst] = ok;
    }
  }
}

}  // namespace srtpu

using namespace srtpu;

// is_f64: float64 values and prefix, else int64; vals: [>= rows perm
// names] or null (a count: c = 1); valid: [same] bool or null; live_s: [n]
// bool, sorted order; perm: [n] int32 or null (values already sorted); p:
// [n + 1]; scratch: 2 * ceil(n / 4096) + 1 values of the prefix's type.
extern "C" int srtpu_window_prefix(int is_f64, const void* vals,
                                   const void* valid, const void* live_s,
                                   const void* perm, long long n, void* p,
                                   void* scratch, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_f64)
    return window_prefix<double>((const double*)vals, (const uint8_t*)valid,
                                 (const uint8_t*)live_s, (const int*)perm, n,
                                 (double*)p, (double*)scratch, s);
  return window_prefix<long long>(
      (const long long*)vals, (const uint8_t*)valid, (const uint8_t*)live_s,
      (const int*)perm, n, (long long*)p, (long long*)scratch, s);
}

// outs: host array of nouts WinOut (at most 8); the bounds and pid: [n]
// int32, sorted order; perm: [n] int32 or null (results in sorted order);
// inv: [n] int32 scratch (with perm; with_inv 0 reuses the inverse the
// last call left there).
extern "C" int srtpu_window_eval(const WinOut* outs, int nouts, long long n,
                                 const void* seg_start, const void* seg_end,
                                 const void* peer_start, const void* peer_end,
                                 const void* pid, const void* perm,
                                 void* inv, int with_inv, int sm_count,
                                 void* stream) {
  if (nouts < 1 || nouts > kMaxWinOuts || n < 1 ||
      (perm != nullptr && inv == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  WinOuts t = {};
  for (int k = 0; k < nouts; ++k) t.o[k] = outs[k];
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 16LL * sm_count) blocks = 16LL * sm_count;
  if (perm != nullptr && with_inv) {
    inverse_kernel<<<(unsigned)blocks, kThreads, 0, s>>>((const int*)perm,
                                                         n, (int*)inv);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  window_eval_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
      t, nouts, n, (const int*)seg_start, (const int*)seg_end,
      (const int*)peer_start, (const int*)peer_end, (const int*)pid,
      perm != nullptr ? (const int*)inv : nullptr);
  return (int)cudaGetLastError();
}
