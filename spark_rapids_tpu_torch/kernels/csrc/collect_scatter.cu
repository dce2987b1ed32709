// K26 collect_scatter: the collect family's buffers. Ranks each kept row
// within its contiguous group, then scatters the rows into a
// [groups, max_elems] matrix with the element counts and per-element
// validity (the padded-matrix array layout of columnar/batch.py).
//
// Replaces spark_rapids_tpu/expr/aggregates.py:668 _seg_exclusive_ranks
// (a cumsum, a searchsorted of every group id and two takes), the
// scatter of :723 CollectList._scatter (`.at[gid, rank].set`, its
// seg_count and the element-validity compare), the dedup test of :751
// _merge_elements and :792 CollectSet.update (a row equal to its sorted
// predecessor in the same group is dropped, :659 _eq_nan_aware: NaN
// equals NaN, -0.0 equals 0.0). For rows r with gid[] non-decreasing:
//   keep[r]   = valid[r] and 0 <= gid[r] < nseg, and, with dedup, not
//               (r > 0, valid[r-1], gid[r-1] == gid[r], vals equal);
//   rank[r]   = kept rows before r in its group (kept rows), else -1;
//   counts[g] = kept rows of group g;
//   out[g, j] = the value of group g's kept row of rank j, 0 past
//               counts[g]; ev[g, j] = j < counts[g].
//
// Bound on the H100: bytes. It reads valid, gid and the value of every
// row (the value twice when deduplicating) and writes keep and rank, then
// reads keep, rank, gid and the values of the kept rows and writes the
// [nseg, me] matrix and its validity once: orders_daily_distinct's
// 2^20-row partial (int64 keys, ~2,406 groups of ~436) is about 30 MB.
//
// Design: K10's three-launch tile scan over the keep flags gives each
// row its global exclusive rank (ballot and popc inside a warp); each
// group's first row publishes its rank as the group's base, and a fourth
// pass subtracts it and writes each group's count at its last row: no
// search, every row read once a pass. After the caller reads the largest
// count (the matrix width, one host sync as in the reference), one launch
// fills the matrix: a grid-stride over its cells writes the element
// validity and zeroes the cells past each count, and a grid-stride over
// the kept rows drops each value into its cell; the two write disjoint
// cells.

#include <math.h>

#include "common.cuh"

namespace srtpu {

// element kinds (ElemKind; ops in expr/aggregates.py name them too)
enum ElemKind { kElemI8 = 0, kElemI16 = 1, kElemI32 = 2, kElemI64 = 3,
                kElemF32 = 4, kElemF64 = 5 };

__device__ __forceinline__ bool elem_eq(const void* __restrict__ v, int kind,
                                        i64 a, i64 b) {
  switch (kind) {
    case kElemI8:
      return ((const int8_t*)v)[a] == ((const int8_t*)v)[b];
    case kElemI16:
      return ((const int16_t*)v)[a] == ((const int16_t*)v)[b];
    case kElemI32:
      return ((const int*)v)[a] == ((const int*)v)[b];
    case kElemI64:
      return ((const i64*)v)[a] == ((const i64*)v)[b];
    case kElemF32: {
      const float x = ((const float*)v)[a], y = ((const float*)v)[b];
      return x == y || (isnan(x) && isnan(y));
    }
    default: {
      const double x = ((const double*)v)[a], y = ((const double*)v)[b];
      return x == y || (isnan(x) && isnan(y));
    }
  }
}

__global__ void __launch_bounds__(kThreads)
collect_mark_kernel(const void* __restrict__ vals, int kind,
                    const uint8_t* __restrict__ valid,
                    const int* __restrict__ gid, i64 n, int nseg, int dedup,
                    uint8_t* __restrict__ keep, int* __restrict__ sums) {
  __shared__ int warp_tot[kWarps];
  const i64 base = (i64)blockIdx.x * kTile;
  int s = 0;
  for (int r = 0; r < kItems; ++r) {
    const i64 j = base + r * kThreads + threadIdx.x;
    if (j >= n) break;
    const int g = gid[j];
    bool k = valid[j] != 0 && g >= 0 && g < nseg;
    if (k && dedup && j > 0 && valid[j - 1] != 0 && gid[j - 1] == g &&
        elem_eq(vals, kind, j - 1, j))
      k = false;
    keep[j] = k;
    s += k;
  }
  s = warp_sum(s);
  if ((threadIdx.x & 31) == 0) warp_tot[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    int t = 0;
    for (int w = 0; w < kWarps; ++w) t += warp_tot[w];
    sums[blockIdx.x] = t;
  }
}

// rank[j] = global exclusive count of kept rows before j; a group's first
// row writes that count as the group's base.
__global__ void __launch_bounds__(kThreads)
collect_excl_kernel(i64 n, int nseg, const uint8_t* __restrict__ keep,
                    const int* __restrict__ gid,
                    const int* __restrict__ tile_off, int* __restrict__ rank,
                    int* __restrict__ base) {
  __shared__ int tot[2][kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const i64 tile = (i64)blockIdx.x * kTile;
  int carry = tile_off[blockIdx.x];
  for (int r = 0; r < kItems; ++r) {
    const i64 j = tile + r * kThreads + threadIdx.x;
    const bool in = j < n;
    const bool k = in && keep[j] != 0;
    const unsigned m = __ballot_sync(kFull, k);
    const int buf = r & 1;
    if (lane == 0) tot[buf][warp] = __popc(m);
    __syncthreads();
    int before = 0, all = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int t = tot[buf][w];
      if (w < warp) before += t;
      all += t;
    }
    if (in) {
      const int ex = carry + before + __popc(m & below);
      rank[j] = ex;
      const int g = gid[j];
      if (g >= 0 && g < nseg && (j == 0 || gid[j - 1] != g)) base[g] = ex;
    }
    carry += all;
  }
}

__global__ void __launch_bounds__(kThreads)
collect_finish_kernel(i64 n, int nseg, const uint8_t* __restrict__ keep,
                      const int* __restrict__ gid,
                      const int* __restrict__ base, int* __restrict__ rank,
                      int* __restrict__ counts) {
  for (i64 j = (i64)blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += (i64)gridDim.x * blockDim.x) {
    const int g = gid[j];
    const bool in = g >= 0 && g < nseg;
    const int ex = rank[j];
    const bool k = keep[j] != 0;
    const int b = in ? base[g] : 0;
    if (in && (j == n - 1 || gid[j + 1] != g)) counts[g] = ex + k - b;
    rank[j] = k ? ex - b : -1;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
collect_scatter_kernel(const T* __restrict__ vals,
                       const uint8_t* __restrict__ keep,
                       const int* __restrict__ rank,
                       const int* __restrict__ gid, i64 n,
                       const int* __restrict__ counts, int nseg, int me,
                       T* __restrict__ out, uint8_t* __restrict__ ev) {
  const i64 stride = (i64)gridDim.x * blockDim.x;
  const i64 first = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  const i64 cells = (i64)nseg * me;
  for (i64 i = first; i < cells; i += stride) {
    const bool on = (int)(i % me) < counts[i / me];
    ev[i] = on;
    if (!on) out[i] = T(0);
  }
  for (i64 j = first; j < n; j += stride) {
    if (!keep[j]) continue;
    const int rk = rank[j];
    if (rk < me) out[(i64)gid[j] * me + rk] = vals[j];
  }
}

}  // namespace srtpu

using namespace srtpu;

// vals: [n] of the element kind; valid: [n] bool; gid: [n] int32,
// non-decreasing over the valid rows' runs; keep: [n] bool; rank: [n]
// int32; counts: [nseg] int32; scratch: nseg + 2 * ceil(n / 4096) + 1
// int32.
extern "C" int srtpu_collect_rank(const void* vals, int kind,
                                  const void* valid, const void* gid,
                                  long long n, int nseg, int dedup,
                                  void* keep, void* rank, void* counts,
                                  void* scratch, int sm_count, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e =
      cudaMemsetAsync(counts, 0, (size_t)nseg * sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  if (n == 0) return (int)cudaGetLastError();
  const int tiles = num_tiles(n);
  int* base = (int*)scratch;
  int* sums = base + nseg;
  int* offsets = sums + tiles;
  int* total = offsets + tiles;
  collect_mark_kernel<<<tiles, kThreads, 0, s>>>(
      vals, kind, (const uint8_t*)valid, (const int*)gid, n, nseg, dedup,
      (uint8_t*)keep, sums);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scan_tiles_kernel<int><<<1, kScanThreads, 0, s>>>(sums, tiles, offsets,
                                                    total);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  collect_excl_kernel<<<tiles, kThreads, 0, s>>>(
      n, nseg, (const uint8_t*)keep, (const int*)gid, offsets, (int*)rank,
      base);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  i64 blocks = (n + kThreads - 1) / kThreads;
  if (blocks > (i64)sm_count * 8) blocks = (i64)sm_count * 8;
  collect_finish_kernel<<<(int)blocks, kThreads, 0, s>>>(
      n, nseg, (const uint8_t*)keep, (const int*)gid, base, (int*)rank,
      (int*)counts);
  return (int)cudaGetLastError();
}

// elem_bytes: 1, 2, 4 or 8; out: [nseg, me] of that width; ev: [nseg, me]
// bool; the other arguments as srtpu_collect_rank left them.
extern "C" int srtpu_collect_scatter(const void* vals, int elem_bytes,
                                     const void* keep, const void* rank,
                                     const void* gid, long long n,
                                     const void* counts, int nseg, int me,
                                     void* out, void* ev, int sm_count,
                                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const i64 work = (i64)nseg * me > n ? (i64)nseg * me : n;
  if (work == 0) return (int)cudaGetLastError();
  i64 blocks = (work + kThreads - 1) / kThreads;
  if (blocks > (i64)sm_count * 8) blocks = (i64)sm_count * 8;
  const uint8_t* k = (const uint8_t*)keep;
  const int* r = (const int*)rank;
  const int* g = (const int*)gid;
  const int* c = (const int*)counts;
  uint8_t* v = (uint8_t*)ev;
  switch (elem_bytes) {
    case 1:
      collect_scatter_kernel<uint8_t><<<(int)blocks, kThreads, 0, s>>>(
          (const uint8_t*)vals, k, r, g, n, c, nseg, me, (uint8_t*)out, v);
      break;
    case 2:
      collect_scatter_kernel<uint16_t><<<(int)blocks, kThreads, 0, s>>>(
          (const uint16_t*)vals, k, r, g, n, c, nseg, me, (uint16_t*)out, v);
      break;
    case 4:
      collect_scatter_kernel<uint32_t><<<(int)blocks, kThreads, 0, s>>>(
          (const uint32_t*)vals, k, r, g, n, c, nseg, me, (uint32_t*)out, v);
      break;
    case 8:
      collect_scatter_kernel<unsigned long long>
          <<<(int)blocks, kThreads, 0, s>>>(
              (const unsigned long long*)vals, k, r, g, n, c, nseg, me,
              (unsigned long long*)out, v);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
