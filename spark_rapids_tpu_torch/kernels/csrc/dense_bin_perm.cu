// K11 dense_bin_perm: occupied bins -> the dense gather permutation.
//
// Replaces spark_rapids_tpu/ops/segmented.py:297 dense_bin_perm (a cumsum
// plus a mode="drop" scatter that XLA compiles): out[j] is the j-th
// occupied bin for j < num_occupied, and 0 past it (the zeros the
// reference's scatter leaves).
//
// Bound on the H100: bytes. It must read the occupancy (1 byte a bin) and
// write the permutation (4 bytes a bin): 10 KB for q5's 2,048-bin partial,
// 3 ns at 3.35 TB/s, so at every size the path gives it the kernel is
// bound by its three launches.
//
// Design: K1's three launches, with the drop side left out: tile counts of
// the occupancy, their one-block scan, and a scatter in which each warp
// ranks its occupied bins with __ballot_sync/__popc. A bin at index
// i >= num_occupied also writes out[i] = 0; no scatter targets those
// positions, so the two writes never meet.

#include "common.cuh"

namespace srtpu {

__global__ void __launch_bounds__(kThreads)
dense_scatter_kernel(const uint8_t* __restrict__ occ, int n,
                     const int* __restrict__ tile_off,
                     const int* __restrict__ total_p, int* __restrict__ out) {
  __shared__ int tot[2][kWarps];
  const int total = *total_p;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;
  const int base = blockIdx.x * kTile;
  int carry = tile_off[blockIdx.x];
  for (int r = 0; r < kItems; ++r) {
    const int i = base + r * kThreads + threadIdx.x;
    const bool in = i < n;
    const bool o = in && occ[i] != 0;
    const unsigned m = __ballot_sync(kFull, o);
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
    if (o) out[carry + before + __popc(m & lanes_below)] = i;
    if (in && i >= total) out[i] = 0;
    carry += all;
  }
}

}  // namespace srtpu

using namespace srtpu;

// occupied: [n] bool; out: [n] int32; scratch: 2 * ceil(n / 4096) + 1
// int32 (the last holds the occupied count).
extern "C" int srtpu_dense_bin_perm(const void* occupied, int n, void* out,
                                    void* scratch, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int tiles = num_tiles(n);
  int* sums = (int*)scratch;
  int* offsets = sums + tiles;
  int* total = offsets + tiles;
  tile_sums_kernel<uint8_t, int><<<tiles, kThreads, 0, s>>>(
      (const uint8_t*)occupied, n, sums);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scan_tiles_kernel<int><<<1, kScanThreads, 0, s>>>(sums, tiles, offsets,
                                                    total);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dense_scatter_kernel<<<tiles, kThreads, 0, s>>>(
      (const uint8_t*)occupied, n, offsets, total, (int*)out);
  return (int)cudaGetLastError();
}
