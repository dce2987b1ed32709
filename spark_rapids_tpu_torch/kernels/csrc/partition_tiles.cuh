// The bucket histogram of a stable counting sort by partition id, shared
// by K7/K28 (partition_by_ids.cu) and K37 (exchange_slots.cu).
//
// Rows are cut into kPartTile-row tiles; row i falls in bucket
// pid[i] when it is live (i < live_rows) and in bucket nparts when it is
// dead. part_hist_kernel counts each tile's rows per bucket in shared
// memory and writes them bucket-major, hist[b * tiles + t], so one
// scan_tiles_kernel (common.cuh) over hist gives off[b * tiles + t]:
// where tile t's rows of bucket b start in the bucket-sorted order, and
// off[b * tiles] where bucket b starts. A live row's pid must lie in
// [0, nparts); one outside traps, as an out-of-range gather index does.
#pragma once

#include <cstdio>

#include "common.cuh"

namespace srtpu {

constexpr int kPartTile = 1024;   // rows per tile: 32 rounds of one warp
constexpr int kPartHistThreads = 256;
constexpr int kMaxBuckets = 8192;

// pid null: K28's round-robin mode, live row i in (i + start) % nparts
__device__ __forceinline__ int bucket_of(const int* __restrict__ pid,
                                         long long i, long long live_rows,
                                         int nparts, long long start) {
  if (i >= live_rows) return nparts;
  if (pid == nullptr) return (int)((i + start) % nparts);
  const int p = pid[i];
  if (p < 0 || p >= nparts) {
    printf("partition id of row %lld is %d, outside [0, %d)\n", i, p,
           nparts);
    __trap();
  }
  return p;
}

// static: each source that includes this header launches its own copy
static __global__ void __launch_bounds__(kPartHistThreads)
part_hist_kernel(const int* __restrict__ pid, long long n,
                 const int* __restrict__ nrows_dev, long long nrows_host,
                 int nparts, long long start, int tiles,
                 int* __restrict__ hist) {
  extern __shared__ int h[];
  const int nb = nparts + 1;
  for (int b = threadIdx.x; b < nb; b += blockDim.x) h[b] = 0;
  __syncthreads();
  const long long live_rows = nrows_dev != nullptr ? *nrows_dev : nrows_host;
  const long long base = (long long)blockIdx.x * kPartTile;
  for (int r = threadIdx.x; r < kPartTile; r += blockDim.x) {
    const long long i = base + r;
    if (i < n) atomicAdd(&h[bucket_of(pid, i, live_rows, nparts, start)], 1);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < nb; b += blockDim.x)
    hist[(long long)b * tiles + blockIdx.x] = h[b];
}

}  // namespace srtpu
