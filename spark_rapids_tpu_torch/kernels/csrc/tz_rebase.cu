// K23 tz_rebase: each int64 instant rebased between UTC and a time zone's
// wall clock through the zone's transition table.
//
// Replaces spark_rapids_tpu/ops/tzdb.py utc_to_local (:210) and
// local_to_utc (:221): a jnp.searchsorted(side="right") of every row in
// the zone's table, a take of the offsets and, local -> UTC, the gap rule
// (:234-241), which XLA compiles with the tables as constants. Modes:
//   to_utc = 0  out = x + offsets[i], i = the count of transitions <= x;
//   to_utc = 1  i = the count of wall-clock transitions <= x,
//               cand = x - offsets[i]; where i > 0 and cand falls before
//               the transition trans[i - 1] (a local time in a DST gap)
//               out = x - offsets[i - 1] (the pre-gap offset), else cand.
//               An ambiguous local time (an overlap) resolves to the
//               earlier offset, because wall[] holds each transition's
//               wall clock under the offset before it.
// The arithmetic wraps as int64 arithmetic does in the reference.
//
// Bound on the H100: bytes. Each instant is read once and written once:
// 15M rows are 240 MB, 0.07 ms at 3.35 TB/s; the tables (3 x 312 entries
// for America/Los_Angeles through 2100, 7.5 KB) are read once a block.
//
// Design: each block copies the three tables into shared memory (global
// memory when they exceed 48 KB), then each thread runs an upper-bound
// binary search for its rows over the shared copy: about 9 probes for
// 312 entries, all from shared memory, so the search costs no device
// memory traffic. A grid of at most 8 blocks an SM (2,048 threads, the
// SM's limit) amortises the copy.

#include "common.cuh"

namespace srtpu {

constexpr int kTzThreads = 256;
constexpr int kTzSharedMax = 48 * 1024;

__global__ void __launch_bounds__(kTzThreads)
tz_rebase_kernel(int to_utc, const i64* __restrict__ x, i64 n,
                 const i64* __restrict__ trans,
                 const i64* __restrict__ offsets,
                 const i64* __restrict__ wall, int nt, int shared,
                 i64* __restrict__ out) {
  extern __shared__ i64 tables[];
  const i64 *s_trans = trans, *s_off = offsets, *s_wall = wall;
  if (shared) {
    i64* t = tables;
    i64* o = tables + nt;
    i64* w = tables + 2 * nt + 1;
    for (int i = threadIdx.x; i < nt; i += blockDim.x) {
      t[i] = trans[i];
      w[i] = wall[i];
    }
    for (int i = threadIdx.x; i <= nt; i += blockDim.x) o[i] = offsets[i];
    __syncthreads();
    s_trans = t;
    s_off = o;
    s_wall = w;
  }
  const i64* keys = to_utc ? s_wall : s_trans;
  for (i64 r = (i64)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += (i64)gridDim.x * blockDim.x) {
    const i64 v = x[r];
    int lo = 0, hi = nt;  // upper bound: the first key > v
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (keys[mid] <= v)
        lo = mid + 1;
      else
        hi = mid;
    }
    const unsigned long long uv = (unsigned long long)v;
    if (!to_utc) {
      out[r] = (i64)(uv + (unsigned long long)s_off[lo]);
      continue;
    }
    const i64 cand = (i64)(uv - (unsigned long long)s_off[lo]);
    out[r] = (lo > 0 && cand < s_trans[lo - 1])
                 ? (i64)(uv - (unsigned long long)s_off[lo - 1])
                 : cand;
  }
}

}  // namespace srtpu

using namespace srtpu;

// x, out: [n] int64; trans, wall: [nt] int64 (nt >= 1, ascending);
// offsets: [nt + 1] int64.
extern "C" int srtpu_tz_rebase(int to_utc, const void* x, long long n,
                               const void* trans, const void* offsets,
                               const void* wall, int nt, void* out,
                               int sm_count, void* stream) {
  if (n < 1 || nt < 1 || (to_utc != 0 && to_utc != 1))
    return (int)cudaErrorInvalidValue;
  const size_t bytes = (size_t)(3 * nt + 1) * sizeof(i64);
  const int shared = bytes <= (size_t)kTzSharedMax;
  long long blocks = (n + kTzThreads - 1) / kTzThreads;
  if (blocks > 8LL * sm_count) blocks = 8LL * sm_count;
  tz_rebase_kernel<<<(unsigned)blocks, kTzThreads, shared ? bytes : 0,
                     (cudaStream_t)stream>>>(
      to_utc, (const i64*)x, n, (const i64*)trans, (const i64*)offsets,
      (const i64*)wall, nt, shared, (i64*)out);
  return (int)cudaGetLastError();
}
