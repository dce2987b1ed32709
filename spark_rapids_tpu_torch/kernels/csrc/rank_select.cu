// K25 rank_select: the percentile aggregates' rank selection over rows
// sorted by (group, value).
//
// Replaces spark_rapids_tpu/expr/aggregates.py:996
// ApproxPercentile._extract (called by :1026 update and :1049 merge: a
// segment_sum of the weights, a segment_min of the first live position,
// a global cumsum less the group's base, then for each of K targets a
// segment_min of the hit positions and a take) and the rank
// interpolation of :934 Percentile.evaluate.
//
// Select mode. For group g with rows [lo, hi) of the sorted positions
// (sgid non-decreasing) and integer weights w >= 0 (the live mask as
// 0/1, or a merge's per-point counts scaled by K so that every sum is
// exact), the rows of positive weight first in each group (the update's
// and the merge's sorts put live rows first): total[g] = sum w; with
// incl(r) the group's running weight through r, target j's threshold thr_j = (j / (K-1)) * total - eps; the
// target's position is the first r with w(r) > 0 and incl(r) >= thr_j,
// and out[j, g] = svals[that r]. A group with no positive weight takes
// svals[npos - 1] for every target (the reference's clipped miss). With
// unit weights (eps = 1e-12) every value compared is the reference's
// float64 exactly.
//
// Interpolate mode (Percentile): for row r of a [rows, me] matrix whose
// rows are sorted, rk = p * max(len - 1, 0), lo = floor(rk), hi =
// ceil(rk), out = v[lo] + (v[hi] - v[lo]) * (rk - lo), lo and hi clipped
// into the row; rounded as written (no fused multiply-add).
//
// Groups past the largest id in sgid have no position: they lie past the
// batch's group count (K10 gives dead rows the last group's id), and K25
// leaves their entries unwritten. A group below it with no position (an
// empty bin of the binned partial) takes the miss value and a total of 0,
// as in the reference.
//
// Bound on the H100: bytes. Select reads each live group's weights (or
// live flags), a few ids a group for its bounds and, for the rows a
// target lands on, the value, and writes K + 1 numbers a group:
// orders_price_stats' partial (2^20 rows, 35 groups, K = 128) needs about
// 1.1 MB. Interpolate reads two values and a length a row.
//
// Design: one launch, one block a group (grid-stride over the groups up
// to the largest id present). Thread 0 binary-searches the group's rows
// [lo, hi) in sgid, then the end of its positive rows (a merge's dead
// points, 2^27 of them behind 35 live groups of 128 at a 2^20-row buffer
// batch, all fall in the last group and are never read); a block
// reduction gives the total, the K thresholds go to shared memory, then
// the block walks the positive rows in 4,096-row chunks, 8 consecutive
// rows a thread, with one block scan a chunk. Running weights rise with
// r, so each positive row owns the targets whose threshold lies in
// (excl(r), incl(r)] (the group's first positive row also every lower
// one): two binary searches over the thresholds, and each target is
// written once. Every row of a live group is read about once; the
// reference's K passes of segment_min over every row are gone.

#include <math.h>

#include "common.cuh"

namespace srtpu {

constexpr int kRsThreads = 512;
constexpr int kRsWarps = kRsThreads / 32;
constexpr int kRsItems = 8;
constexpr int kRsMaxK = 128;

__device__ __forceinline__ i64 first_at_least(const int* __restrict__ sgid,
                                              i64 npos, int g) {
  i64 lo = 0, hi = npos;  // sgid ascends: first r with sgid[r] >= g
  while (lo < hi) {
    const i64 mid = (lo + hi) >> 1;
    if (sgid[mid] < g) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int count_at_most(const double* thr, int K,
                                             double x) {
  int lo = 0, hi = K;  // thresholds ascend: first j with thr[j] > x
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (thr[mid] <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ i64 weight_at(const i64* __restrict__ weights,
                                         const uint8_t* __restrict__ live,
                                         i64 r) {
  return weights != nullptr ? weights[r] : (i64)(live[r] != 0);
}

__global__ void __launch_bounds__(kRsThreads)
rs_select_kernel(const double* __restrict__ svals,
                 const int* __restrict__ sgid,
                 const i64* __restrict__ weights,
                 const uint8_t* __restrict__ live, i64 npos, int nseg, int K,
                 double eps, double* __restrict__ outs,
                 i64* __restrict__ total_out) {
  __shared__ double thr[kRsMaxK];
  __shared__ i64 warp_tot[2][kRsWarps];
  __shared__ i64 s_lo, s_hi, s_total;
  const double miss = svals[npos - 1];
  const double denom = (double)(K > 1 ? K - 1 : 1);
  const int last = sgid[npos - 1];
  const int ngroups = last < 0 ? 0 : (last >= nseg ? nseg : last + 1);
  for (int g = blockIdx.x; g < ngroups; g += gridDim.x) {
    __syncthreads();         // the previous group's shared reads are done
    if (threadIdx.x == 0) {  // the group's rows; the positive ones first
      const i64 lo = first_at_least(sgid, npos, g);
      i64 a = lo, b = first_at_least(sgid, npos, g + 1);
      while (a < b) {
        const i64 mid = (a + b) >> 1;
        if (weight_at(weights, live, mid) > 0) a = mid + 1; else b = mid;
      }
      s_lo = lo;
      s_hi = a;
    }
    __syncthreads();
    const i64 lo = s_lo, hi = s_hi;
    if (lo >= hi) {          // no position of positive weight
      for (int j = threadIdx.x; j < K; j += kRsThreads)
        outs[(i64)j * nseg + g] = miss;
      if (threadIdx.x == 0) total_out[g] = 0;
      continue;
    }
    i64 t = 0;
    for (i64 r = lo + threadIdx.x; r < hi; r += kRsThreads)
      t += weight_at(weights, live, r);
    t = warp_sum(t);
    if ((threadIdx.x & 31) == 0) warp_tot[0][threadIdx.x >> 5] = t;
    __syncthreads();
    if (threadIdx.x == 0) {
      i64 s = 0;
      for (int w = 0; w < kRsWarps; ++w) s += warp_tot[0][w];
      s_total = s;
      total_out[g] = s;
    }
    __syncthreads();
    const i64 total = s_total;
    for (int j = threadIdx.x; j < K; j += kRsThreads)
      thr[j] = __dsub_rn(__dmul_rn(__ddiv_rn((double)j, denom),
                                   (double)total), eps);
    __syncthreads();
    i64 carry = 0;
    int round = 1;  // warp_tot[0] was the reduction's
    for (i64 c = lo; c < hi; c += (i64)kRsThreads * kRsItems, ++round) {
      const i64 r0 = c + (i64)threadIdx.x * kRsItems;
      i64 w[kRsItems];
      i64 mine = 0;
#pragma unroll
      for (int it = 0; it < kRsItems; ++it) {
        const i64 r = r0 + it;
        w[it] = r < hi ? weight_at(weights, live, r) : 0;
        mine += w[it];
      }
      i64 chunk;
      i64 run = carry + block_exclusive_scan<i64, kRsWarps>(
                            mine, warp_tot[round & 1], chunk);
#pragma unroll
      for (int it = 0; it < kRsItems; ++it) {
        if (w[it] > 0) {
          const i64 incl = run + w[it];
          const int jlo = run == 0 ? 0 : count_at_most(thr, K, (double)run);
          const int jhi = count_at_most(thr, K, (double)incl);
          if (jlo < jhi) {
            const double v = svals[r0 + it];
            for (int j = jlo; j < jhi; ++j) outs[(i64)j * nseg + g] = v;
          }
        }
        run += w[it];
      }
      carry += chunk;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
rs_interp_kernel(const double* __restrict__ svals,
                 const int* __restrict__ lengths, int rows, int me, double p,
                 double* __restrict__ out) {
  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < rows;
       r += gridDim.x * blockDim.x) {
    const int cnt = lengths[r];
    const double rk = __dmul_rn(p, (double)(cnt > 1 ? cnt - 1 : 0));
    const int lo = (int)floor(rk);
    const int hi = (int)ceil(rk);
    const double frac = __dsub_rn(rk, (double)lo);
    const int slo = lo < 0 ? 0 : (lo > me - 1 ? me - 1 : lo);
    const int shi = hi < 0 ? 0 : (hi > me - 1 ? me - 1 : hi);
    const double vlo = svals[(i64)r * me + slo];
    const double vhi = svals[(i64)r * me + shi];
    out[r] = __dadd_rn(vlo, __dmul_rn(__dsub_rn(vhi, vlo), frac));
  }
}

}  // namespace srtpu

using namespace srtpu;

// Select mode. svals: [npos] float64; sgid: [npos] int32 non-decreasing;
// exactly one of weights ([npos] int64, >= 0) and live ([npos] bool);
// outs: [K, nseg] float64; total: [nseg] int64, both written for the
// groups up to the largest id in sgid.
extern "C" int srtpu_rank_select(const void* svals, const void* sgid,
                                 const void* weights, const void* live,
                                 long long npos, int nseg, int K, double eps,
                                 void* outs, void* total, int sm_count,
                                 void* stream) {
  if (K < 1 || K > kRsMaxK || npos < 1 || nseg < 1 ||
      (weights == nullptr) == (live == nullptr))
    return (int)cudaErrorInvalidValue;
  const int gblocks = nseg < sm_count * 4 ? nseg : sm_count * 4;
  rs_select_kernel<<<gblocks, kRsThreads, 0, (cudaStream_t)stream>>>(
      (const double*)svals, (const int*)sgid, (const i64*)weights,
      (const uint8_t*)live, npos, nseg, K, eps, (double*)outs, (i64*)total);
  return (int)cudaGetLastError();
}

// Interpolate mode. svals: [rows, me] float64, each row sorted; lengths:
// [rows] int32; out: [rows] float64.
extern "C" int srtpu_rank_interp(const void* svals, const void* lengths,
                                 int rows, int me, double p, void* out,
                                 int sm_count, void* stream) {
  if (me < 1 || rows < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  int blocks = (rows + kThreads - 1) / kThreads;
  if (blocks > sm_count * 8) blocks = sm_count * 8;
  rs_interp_kernel<<<blocks, kThreads, 0, s>>>(
      (const double*)svals, (const int*)lengths, rows, me, p, (double*)out);
  return (int)cudaGetLastError();
}
