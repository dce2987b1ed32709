// K10 group_bounds: segment structure of rows sorted by their key words.
//
// Replaces the body of spark_rapids_tpu/ops/segmented.py:306 group_by
// after its sort (takes of the key words, rows_equal_adjacent, a cumsum
// and a segment_min, which XLA compiles). Given the unsorted key words
// [nwords, n] int64, K9's permutation perm and the live mask:
//   live_s[j]    = live[perm[j]]
//   boundary[j]  = live_s[j] and (j == 0 or some word of row perm[j]
//                  differs from row perm[j-1])
//   gid[j]       = clip(boundaries in [0, j] - 1, 0, n - 1)
//   num_groups   = boundaries in [0, n)
//   first_pos[g] = min over rows j with gid[j] == g of (live_s[j] ? j : n),
//                  INT32_MAX where no row has gid g (segment_min's
//                  identity).
// gid is non-decreasing, so rows of one gid are one run, and the minimum
// of a run is its first live row, else n if it holds a dead row: only a
// run's first row and a row whose predecessor differs in liveness can
// hold it, and only those rows take an atomicMin. Sorted input has one
// such row per group (its boundary) plus the first dead row.
//
// Bound on the H100: bytes. It reads the permutation, the live mask and
// the key words of every row (through the permutation) and writes gid,
// live_s and first_pos: 4 + 1 + 8 * nwords + 4 + 1 + 4 bytes a row, 2.4 us
// for the 16,384-row final merge at 3.35 TB/s with 2 words; at the path's
// 4,096-32,768 rows it is bound by its three launches.
//
// Design: K1's three-launch tile scan. 1. one pass marks the boundaries
// (one byte each), writes live_s, fills first_pos with INT32_MAX and sums
// every 4,096-row tile; 2. scan_tiles over the tile sums also writes
// num_groups (left on the card); 3. each tile ranks its boundaries with
// __ballot_sync/__popc to give gid, then takes the run minima.

#include <limits.h>

#include "common.cuh"

namespace srtpu {

__global__ void __launch_bounds__(kThreads)
bounds_mark_kernel(const i64* __restrict__ words, int nwords, int n,
                   const int* __restrict__ perm,
                   const uint8_t* __restrict__ live,
                   uint8_t* __restrict__ bnd, uint8_t* __restrict__ live_s,
                   int* __restrict__ first_pos, int* __restrict__ sums) {
  __shared__ int warp_tot[kWarps];
  const int base = blockIdx.x * kTile;
  int s = 0;
  for (int r = 0; r < kItems; ++r) {
    const int j = base + r * kThreads + threadIdx.x;
    if (j >= n) break;
    const int pj = perm[j];
    const bool ls = live[pj] != 0;
    bool b = ls;
    if (b && j > 0) {
      const int pp = perm[j - 1];
      bool eq = true;
      for (int w = 0; w < nwords && eq; ++w)
        eq = words[(i64)w * n + pj] == words[(i64)w * n + pp];
      b = !eq;
    }
    bnd[j] = b;
    live_s[j] = ls;
    first_pos[j] = INT_MAX;
    s += b;
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

__global__ void __launch_bounds__(kThreads)
bounds_gid_kernel(int n, const uint8_t* __restrict__ bnd,
                  const uint8_t* __restrict__ live_s,
                  const int* __restrict__ tile_off, int* __restrict__ gid,
                  int* __restrict__ first_pos) {
  __shared__ int tot[2][kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lanes_upto = (lane == 31) ? kFull : ((2u << lane) - 1u);
  const int base = blockIdx.x * kTile;
  int carry = tile_off[blockIdx.x];
  for (int r = 0; r < kItems; ++r) {
    const int j = base + r * kThreads + threadIdx.x;
    const bool in = j < n;
    const bool b = in && bnd[j] != 0;
    const unsigned m = __ballot_sync(kFull, b);
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
      const int c = carry + before + __popc(m & lanes_upto);  // inclusive
      const int hi = n - 1;
      int g = c - 1;
      g = g < 0 ? 0 : (g > hi ? hi : g);
      int gp = c - (b ? 1 : 0) - 1;  // gid of row j - 1
      gp = gp < 0 ? 0 : (gp > hi ? hi : gp);
      gid[j] = g;
      const bool ls = live_s[j] != 0;
      const bool starts = j == 0 || gp != g;
      if (ls && (starts || live_s[j - 1] == 0)) atomicMin(&first_pos[g], j);
      if (!ls && (starts || live_s[j - 1] != 0)) atomicMin(&first_pos[g], n);
    }
    carry += all;
  }
}

}  // namespace srtpu

using namespace srtpu;

// words: [nwords, n] int64; perm: [n] int32; live: [n] bool; gid,
// first_pos: [n] int32; live_s: [n] bool; num_groups: 0-d int32;
// scratch: n bytes (16-byte aligned up) + 2 * ceil(n / 4096) int32.
extern "C" int srtpu_group_bounds(const void* words, int nwords, int n,
                                  const void* perm, const void* live,
                                  void* gid, void* live_s, void* num_groups,
                                  void* first_pos, void* scratch,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int tiles = num_tiles(n);
  uint8_t* bnd = (uint8_t*)scratch;
  int* sums = (int*)((char*)scratch + (((size_t)n + 15) & ~(size_t)15));
  int* offsets = sums + tiles;
  bounds_mark_kernel<<<tiles, kThreads, 0, s>>>(
      (const i64*)words, nwords, n, (const int*)perm, (const uint8_t*)live,
      bnd, (uint8_t*)live_s, (int*)first_pos, sums);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scan_tiles_kernel<int><<<1, kScanThreads, 0, s>>>(sums, tiles, offsets,
                                                    (int*)num_groups);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  bounds_gid_kernel<<<tiles, kThreads, 0, s>>>(
      n, bnd, (const uint8_t*)live_s, offsets, (int*)gid, (int*)first_pos);
  return (int)cudaGetLastError();
}
