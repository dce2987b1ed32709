// K27 join_marks: the join's match marks.
//
// Replaces three device functions of spark_rapids_tpu/exec/joins.py (and
// their traced copies in parallel/plan_compiler.py):
//
//   probe marks  joins.py:151-152, plan_compiler.py:215-216
//     matched_l = zeros(n).at[pi].max(where(ok, 1, 0)) > 0
//   build marks  joins.py:178-180 and :585-587, plan_compiler.py:236-238
//     matched_b = zeros(n).at[clip(bi, 0, n - 1)].max(where(ok, 1, 0)) > 0
//     (the nested-loop join ORs the marks of each probe chunk, :588)
//   coverage     joins.py:254-262 _matched_build_mask
//     delta[clip(lo)] += counts > 0; delta[clip(lo + counts)] -= counts > 0
//     covered = cumsum(delta[:-1]) > 0
//
// Marks: one thread a pair; an ok pair stores 1 into its mark unless it
// reads 1 there already. The store is idempotent, so pairs that hit one
// mark need no atomics and no order.
// A mark launch may leave the marks as they are first (the nested-loop
// join's OR across chunks) or zero them (cudaMemsetAsync). Without clip,
// an index outside [0, n_marks) traps, as an out-of-range gather does.
//
// Coverage: build row i is covered iff some probe range [lo, lo + count)
// with count > 0 holds it. Three launches, none of them a library scan:
//   1. reach: every probe row with count > 0 raises reach[lo] to
//      lo + count (atomicMax; reach starts at 0);
//   2. tile max and one block's exclusive max-scan over the tiles;
//   3. apply: each tile max-scans its reach in row order behind its
//      tile's carry; covered[i] = (max of reach[0..i]) > i.
// A max-scan holds for any set of ranges, overlapping or not (the
// sorted build's key ranges are disjoint or equal).
//
// Bound on the H100: bytes. Marks read 4 or 8 B of index and 1 B of ok a
// pair and write 1 B a mark; coverage reads 8 B a probe row and writes 1
// B a build row (reach is 4 B a build row, written and read twice).

#include "common.cuh"

#include <cstdio>

namespace srtpu {

constexpr int kMarkThreads = 256;

template <typename I>
__global__ void __launch_bounds__(kMarkThreads)
mark_kernel(const I* __restrict__ idx, const bool* __restrict__ ok, i64 n,
            i64 n_marks, int clip, unsigned char* __restrict__ marks) {
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 j = (i64)blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += stride) {
    if (!ok[j]) continue;
    i64 p = (i64)idx[j];
    if (clip) {
      p = p < 0 ? 0 : (p >= n_marks ? n_marks - 1 : p);
    } else if (p < 0 || p >= n_marks) {
      printf("join_marks: pair %lld has index %lld outside [0, %lld)\n", j,
             p, n_marks);
      __trap();
    }
    // test before set: once a mark is 1 (a hot build row, a probe row's
    // later pairs) its readers skip the store, so many pairs on one mark
    // do not queue on one address
    if (marks[p] == 0) marks[p] = 1;
  }
}

__global__ void __launch_bounds__(kMarkThreads)
reach_kernel(const int* __restrict__ lo, const int* __restrict__ counts,
             i64 n_probe, int n_build, int* __restrict__ reach) {
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 p = (i64)blockIdx.x * blockDim.x + threadIdx.x; p < n_probe;
       p += stride) {
    const int c = counts[p];
    if (c <= 0) continue;
    const i64 l = lo[p] < 0 ? 0 : (i64)lo[p];
    if (l >= n_build) continue;
    i64 h = l + (i64)c;
    if (h > n_build) h = n_build;
    atomicMax(&reach[l], (int)h);
  }
}

__device__ __forceinline__ int warp_inclusive_max(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v = max(v, o);
  }
  return v;
}

// Inclusive max over a block of NW warps in thread order; `total` gets
// the block's max. Two __syncthreads keep successive calls apart.
template <int NW>
__device__ __forceinline__ int block_inclusive_max(int v, int* warp_max,
                                                   int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int inc = warp_inclusive_max(v);
  if (lane == 31) warp_max[warp] = inc;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    const int t = warp_max[w];
    if (w < warp) before = max(before, t);
    total = max(total, t);
  }
  __syncthreads();
  return max(before, inc);
}

__global__ void __launch_bounds__(kThreads)
tile_max_kernel(const int* __restrict__ reach, i64 n, int* __restrict__ tmax) {
  __shared__ int warp_max[kWarps];
  const i64 base = (i64)blockIdx.x * kTile;
  int m = 0;
  for (int r = 0; r < kItems; ++r) {
    const i64 i = base + r * kThreads + threadIdx.x;
    if (i < n) m = max(m, reach[i]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = max(m, __shfl_down_sync(kFull, m, off));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    int t = 0;
    for (int w = 0; w < kWarps; ++w) t = max(t, warp_max[w]);
    tmax[blockIdx.x] = t;
  }
}

// One block: carry[t] = max of tmax[0..t) (exclusive), serial over chunks
// of kScanThreads tiles: the inclusive max of the input shifted by one.
__global__ void __launch_bounds__(kScanThreads)
scan_max_tiles_kernel(const int* __restrict__ tmax, int tiles,
                      int* __restrict__ carry_out) {
  __shared__ int warp_max[kScanThreads / 32];
  int carry = 0;
  for (int base = 0; base < tiles; base += kScanThreads) {
    const int t = base + threadIdx.x;
    const int v = (t >= 1 && t - 1 < tiles) ? tmax[t - 1] : 0;
    int tot;
    const int inc = block_inclusive_max<kScanThreads / 32>(v, warp_max, tot);
    if (t < tiles) carry_out[t] = max(carry, inc);
    carry = max(carry, tot);
  }
}

__global__ void __launch_bounds__(kThreads)
cover_kernel(const int* __restrict__ reach, i64 n,
             const int* __restrict__ tile_carry,
             unsigned char* __restrict__ covered) {
  __shared__ int warp_max[kWarps];
  const i64 base = (i64)blockIdx.x * kTile;
  int carry = tile_carry[blockIdx.x];
  for (int r = 0; r < kItems; ++r) {
    const i64 i = base + r * kThreads + threadIdx.x;
    const int v = i < n ? reach[i] : 0;
    int tot;
    const int inc = block_inclusive_max<kWarps>(v, warp_max, tot);
    if (i < n) covered[i] = (i64)max(carry, inc) > i ? 1 : 0;
    carry = max(carry, tot);
  }
}

static inline int marks_grid(i64 n, int sms) {
  i64 blocks = (n + kMarkThreads - 1) / kMarkThreads;
  const i64 cap = (i64)sms * 8;
  if (blocks > cap) blocks = cap;
  return (int)(blocks < 1 ? 1 : blocks);
}

}  // namespace srtpu

using namespace srtpu;

// idx: [n] int32 (idx_bytes 4) or int64 (8); ok: [n] bool; marks: [n_marks]
// bool, zeroed first when `zero` is set, else ORed into.
extern "C" int srtpu_join_marks(const void* idx, int idx_bytes,
                                const void* ok, long long n,
                                long long n_marks, int clip, int zero,
                                void* marks, int sms, void* stream) {
  if (n < 0 || n_marks < 1 || (idx_bytes != 4 && idx_bytes != 8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (zero) {
    cudaError_t e = cudaMemsetAsync(marks, 0, (size_t)n_marks, s);
    if (e != cudaSuccess) return (int)e;
  }
  if (n == 0) return (int)cudaSuccess;
  const int grid = marks_grid(n, sms);
  if (idx_bytes == 4)
    mark_kernel<int><<<grid, kMarkThreads, 0, s>>>(
        (const int*)idx, (const bool*)ok, n, n_marks, clip,
        (unsigned char*)marks);
  else
    mark_kernel<long long><<<grid, kMarkThreads, 0, s>>>(
        (const long long*)idx, (const bool*)ok, n, n_marks, clip,
        (unsigned char*)marks);
  return (int)cudaGetLastError();
}

// lo, counts: [n_probe] int32; covered: [n_build] bool out; scratch:
// [n_build + 2 * ceil(n_build / 4096)] int32.
extern "C" int srtpu_build_coverage(const void* lo, const void* counts,
                                    long long n_probe, int n_build,
                                    void* covered, void* scratch, int sms,
                                    void* stream) {
  if (n_probe < 0 || n_build < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int* reach = (int*)scratch;
  const int tiles = num_tiles(n_build);
  int* tmax = reach + n_build;
  int* tcarry = tmax + tiles;
  cudaError_t e = cudaMemsetAsync(reach, 0, (size_t)n_build * sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  if (n_probe > 0) {
    reach_kernel<<<marks_grid(n_probe, sms), kMarkThreads, 0, s>>>(
        (const int*)lo, (const int*)counts, n_probe, n_build, reach);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  tile_max_kernel<<<tiles, kThreads, 0, s>>>(reach, n_build, tmax);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scan_max_tiles_kernel<<<1, kScanThreads, 0, s>>>(tmax, tiles, tcarry);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  cover_kernel<<<tiles, kThreads, 0, s>>>(reach, n_build, tcarry,
                                          (unsigned char*)covered);
  return (int)cudaGetLastError();
}
