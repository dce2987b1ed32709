// K3 expand_gather_maps: (lo, count) per probe row -> the join's probe and
// build gather maps.
//
// Replaces spark_rapids_tpu/ops/joinops.py:129 expand_gather_maps (an int64
// cumsum plus a searchsorted of every output slot that XLA compiles). With
// e[p] the exclusive prefix sum of counts (in int64):
//   pi[e[p] + k] = p,  bi[e[p] + k] = lo[p] + k   for k in [0, count[p]),
// total = sum of counts (0-d int32, left on the device). Slots in
// [total, out_cap) get probe n-1 and build 0, so later gathers stay in
// range (the reference leaves clamped values there too).
//
// Bound on the H100: bytes. It must read count (4 B per probe row), lo
// (4 B per probe row with a match) and write pi and bi (8 B per output
// slot): q5's 8,388,608 probe rows, about 4.05M of them matched, and
// 4,194,304 slots are 83 MB, about 25 us at 3.35 TB/s.
//
// Design: K1's tile scan (tile sums, then one block scans the tile sums in
// int64), then one thread per probe row takes its exclusive offset from a
// block scan and writes its own slots, so no output slot searches for its
// row. A fourth launch fills the slots past total.

#include "common.cuh"

namespace srtpu {

__global__ void __launch_bounds__(kThreads)
expand_kernel(const int* __restrict__ lo, const int* __restrict__ counts,
              int n, const i64* __restrict__ tile_off, int out_cap,
              int* __restrict__ pi, int* __restrict__ bi) {
  __shared__ i64 warp_tot[2][kWarps];
  const int base = blockIdx.x * kTile;
  i64 carry = tile_off[blockIdx.x];
  for (int r = 0; r < kItems; ++r) {
    const int p = base + r * kThreads + threadIdx.x;
    const i64 c = p < n ? (i64)counts[p] : 0;
    i64 tot;
    const i64 e =
        carry + block_exclusive_scan<i64, kWarps>(c, warp_tot[r & 1], tot);
    if (c > 0) {
      const int l = lo[p];
      for (i64 k = 0; k < c && e + k < out_cap; ++k) {
        pi[e + k] = p;
        bi[e + k] = l + (int)k;
      }
    }
    carry += tot;
  }
}

__global__ void expand_fill_kernel(int out_cap, const i64* __restrict__ total,
                                   int n, int* __restrict__ pi,
                                   int* __restrict__ bi,
                                   int* __restrict__ total32) {
  const i64 t = *total;
  const i64 first = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (first == 0) *total32 = (int)t;
  for (i64 j = first; j < out_cap; j += (i64)gridDim.x * blockDim.x) {
    if (j >= t) {
      pi[j] = n - 1;
      bi[j] = 0;
    }
  }
}

}  // namespace srtpu

using namespace srtpu;

// lo, counts: [n] int32; pi, bi: [out_cap] int32; total: 0-d int32;
// scratch: [2 * ceil(n / 4096) + 1] int64.
extern "C" int srtpu_expand_gather_maps(const void* lo, const void* counts,
                                        int n, int out_cap, void* pi,
                                        void* bi, void* total, void* scratch,
                                        int sm_count, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int tiles = num_tiles(n);
  i64* sums = (i64*)scratch;
  i64* offsets = sums + tiles;
  i64* total64 = offsets + tiles;
  tile_sums_kernel<int, i64><<<tiles, kThreads, 0, s>>>((const int*)counts,
                                                        n, sums);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scan_tiles_kernel<i64><<<1, kScanThreads, 0, s>>>(sums, tiles, offsets,
                                                    total64);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  expand_kernel<<<tiles, kThreads, 0, s>>>((const int*)lo, (const int*)counts,
                                           n, offsets, out_cap, (int*)pi,
                                           (int*)bi);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  i64 blocks = ((i64)out_cap + kThreads - 1) / kThreads;
  if (blocks > (i64)sm_count * 8) blocks = (i64)sm_count * 8;
  if (blocks < 1) blocks = 1;
  expand_fill_kernel<<<(int)blocks, kThreads, 0, s>>>(
      out_cap, total64, n, (int*)pi, (int*)bi, (int*)total);
  return (int)cudaGetLastError();
}
