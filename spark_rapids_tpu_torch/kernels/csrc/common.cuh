// Shared pieces of the hand-written Hopper kernels (sm_90a): tile
// geometry, warp and block scans, and the two-launch tile-offset scan
// that K1 (compact_perm) and K3 (expand_gather_maps) are built on.
//
// A "tile" is the kTile consecutive rows one block owns. Rows are read in
// kItems rounds of kThreads, so neighbouring threads touch neighbouring
// addresses (coalesced) and the round order is the row order, which is
// what keeps every scan below stable.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace srtpu {

typedef long long i64;

constexpr int kThreads = 256;             // threads per row block
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                // rounds per tile
constexpr int kTile = kThreads * kItems;  // 4096 rows per block
constexpr int kScanThreads = 1024;        // the one block of scan_tiles
constexpr unsigned kFull = 0xffffffffu;

inline int num_tiles(i64 n) { return (int)((n + kTile - 1) / kTile); }

template <typename T>
__device__ __forceinline__ T warp_inclusive_scan(T v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    T o = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v += o;
  }
  return v;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  return v;
}

// Exclusive prefix of one value per thread, in thread order, over a block
// of NW warps; `total` gets the block's sum. `warp_tot` holds NW entries.
// Successive calls must alternate between two `warp_tot` buffers: the one
// __syncthreads inside then also orders the previous call's reads.
template <typename T, int NW>
__device__ __forceinline__ T block_exclusive_scan(T v, T* warp_tot, T& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T inc = warp_inclusive_scan(v);
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  T before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    const T t = warp_tot[w];
    if (w < warp) before += t;
    total += t;
  }
  return before + inc - v;
}

// Launch 1 of a tile scan: sums[b] = sum of x over tile b.
template <typename TIn, typename TAcc>
__global__ void __launch_bounds__(kThreads)
tile_sums_kernel(const TIn* __restrict__ x, i64 n, TAcc* __restrict__ sums) {
  __shared__ TAcc warp_tot[kWarps];
  const i64 base = (i64)blockIdx.x * kTile;
  TAcc s = 0;
#pragma unroll 4
  for (int r = 0; r < kItems; ++r) {
    const i64 i = base + r * kThreads + threadIdx.x;
    if (i < n) s += (TAcc)x[i];
  }
  s = warp_sum(s);
  if ((threadIdx.x & 31) == 0) warp_tot[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    TAcc t = 0;
    for (int w = 0; w < kWarps; ++w) t += warp_tot[w];
    sums[blockIdx.x] = t;
  }
}

// Launch 2 of a tile scan, in ONE block: offsets[b] = exclusive prefix of
// sums, *total = sum of all. Serial over chunks of 1024 tiles (8,388,608
// rows are 2,048 tiles: two chunks).
template <typename T>
__global__ void __launch_bounds__(kScanThreads)
scan_tiles_kernel(const T* __restrict__ sums, int n, T* __restrict__ offsets,
                  T* __restrict__ total) {
  __shared__ T warp_tot[2][kScanThreads / 32];
  T carry = 0;
  int round = 0;
  for (int base = 0; base < n; base += kScanThreads, ++round) {
    const int i = base + threadIdx.x;
    const T v = i < n ? sums[i] : T(0);
    T tot;
    const T ex = block_exclusive_scan<T, kScanThreads / 32>(
        v, warp_tot[round & 1], tot);
    if (i < n) offsets[i] = carry + ex;
    carry += tot;
  }
  if (threadIdx.x == 0) *total = carry;
}

}  // namespace srtpu
