// K7 partition_by_ids: stable counting sort of rows by partition id.
//
// Replaces spark_rapids_tpu/ops/partition.py:35 partition_by_ids (a stable
// lax.sort of key = live ? pid : num_partitions, then a segment_sum of the
// live rows by clipped pid). Output is the same permutation: perm[j] is
// the row that lands at position j, rows of partition 0 first, each
// partition in row order, dead rows (index >= num_rows) last; and
// counts[p] = live rows with pid p. A live row's pid must lie in
// [0, num_partitions) (every caller's pids come from Pmod); one outside
// traps, as an out-of-range gather index does.
//
// Bound on the H100: bytes. It reads pid (4 B/row) and writes perm
// (4 B/row): q5's exchange partitions 1,024 rows, 8 KB, so a launch is
// the floor. At 8,388,608 rows it would be 67 MB, 20 us.
//
// Design: three launches with B = num_partitions + 1 buckets.
//   1. hist: each 1,024-row tile counts its rows per bucket in shared
//      memory and writes them bucket-major, hist[b * tiles + t];
//   2. scan_tiles (common.cuh): one block scans hist in that order, so
//      off[b * tiles + t] is where tile t's rows of bucket b start;
//   3. scatter: one warp per tile walks its rows in 32 rounds of 32; lanes
//      with the same bucket find each other with __match_any_sync and take
//      ranks in lane order, behind a per-bucket carry in shared memory, so
//      every row lands at its stable position. Block 0 also writes counts.
// Shared memory is B ints per block (B <= 8,192).

#include <cstdio>

#include "common.cuh"

namespace srtpu {

constexpr int kPartTile = 1024;   // rows per tile: 32 rounds of one warp
constexpr int kPartHistThreads = 256;
constexpr int kMaxBuckets = 8192;

__device__ __forceinline__ int bucket_of(const int* __restrict__ pid,
                                         long long i, long long live_rows,
                                         int nparts) {
  if (i >= live_rows) return nparts;
  const int p = pid[i];
  if (p < 0 || p >= nparts) {
    printf("partition_by_ids: row %lld has partition id %d outside "
           "[0, %d)\n", i, p, nparts);
    __trap();
  }
  return p;
}

__global__ void __launch_bounds__(kPartHistThreads)
part_hist_kernel(const int* __restrict__ pid, long long n,
                 const int* __restrict__ nrows_dev, long long nrows_host,
                 int nparts, int tiles, int* __restrict__ hist) {
  extern __shared__ int h[];
  const int nb = nparts + 1;
  for (int b = threadIdx.x; b < nb; b += blockDim.x) h[b] = 0;
  __syncthreads();
  const long long live_rows = nrows_dev != nullptr ? *nrows_dev : nrows_host;
  const long long base = (long long)blockIdx.x * kPartTile;
  for (int r = threadIdx.x; r < kPartTile; r += blockDim.x) {
    const long long i = base + r;
    if (i < n) atomicAdd(&h[bucket_of(pid, i, live_rows, nparts)], 1);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < nb; b += blockDim.x)
    hist[(long long)b * tiles + blockIdx.x] = h[b];
}

__global__ void __launch_bounds__(32)
part_scatter_kernel(const int* __restrict__ pid, long long n,
                    const int* __restrict__ nrows_dev, long long nrows_host,
                    int nparts, int tiles, const int* __restrict__ off,
                    int* __restrict__ perm, int* __restrict__ counts) {
  extern __shared__ int carry[];
  const int nb = nparts + 1;
  const int lane = threadIdx.x;
  for (int b = lane; b < nb; b += 32)
    carry[b] = off[(long long)b * tiles + blockIdx.x];
  if (blockIdx.x == 0) {
    for (int b = lane; b < nparts; b += 32)
      counts[b] = off[(long long)(b + 1) * tiles] - off[(long long)b * tiles];
  }
  __syncwarp();
  const long long live_rows = nrows_dev != nullptr ? *nrows_dev : nrows_host;
  const unsigned lanes_below = (1u << lane) - 1u;
  const long long base = (long long)blockIdx.x * kPartTile;
  for (int r = 0; r < kPartTile / 32; ++r) {
    const long long i = base + r * 32 + lane;
    const bool in = i < n;
    // rows past n take a key of their own (-1 - lane): they match nothing
    const int key = in ? bucket_of(pid, i, live_rows, nparts) : -1 - lane;
    const unsigned same = __match_any_sync(kFull, key);
    int pos = 0;
    if (in) pos = carry[key] + __popc(same & lanes_below);
    __syncwarp();
    if (in) {
      perm[pos] = (int)i;
      if ((same & lanes_below) == 0) carry[key] += __popc(same);
    }
    __syncwarp();
  }
}

}  // namespace srtpu

using namespace srtpu;

// pid: [n] int32; perm: [n] int32 out; counts: [nparts] int32 out;
// scratch: [2 * (nparts + 1) * ceil(n / 1024) + 1] int32. The live rows are
// *nrows_dev when given, else nrows_host.
extern "C" int srtpu_partition_by_ids(const void* pid, long long n,
                                      const void* nrows_dev,
                                      long long nrows_host, int nparts,
                                      void* perm, void* counts,
                                      void* scratch, void* stream) {
  if (nparts < 1 || nparts + 1 > kMaxBuckets || n <= 0 || n > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int tiles = (int)((n + kPartTile - 1) / kPartTile);
  const int nb = nparts + 1;
  const long long cells = (long long)nb * tiles;
  if (cells > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  int* hist = (int*)scratch;
  int* off = hist + cells;
  int* total = off + cells;
  const size_t smem = (size_t)nb * sizeof(int);
  part_hist_kernel<<<tiles, kPartHistThreads, smem, s>>>(
      (const int*)pid, n, (const int*)nrows_dev, nrows_host, nparts, tiles,
      hist);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scan_tiles_kernel<int><<<1, kScanThreads, 0, s>>>(hist, (int)cells, off,
                                                     total);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  part_scatter_kernel<<<tiles, 32, smem, s>>>(
      (const int*)pid, n, (const int*)nrows_dev, nrows_host, nparts, tiles,
      off, (int*)perm, (int*)counts);
  return (int)cudaGetLastError();
}
