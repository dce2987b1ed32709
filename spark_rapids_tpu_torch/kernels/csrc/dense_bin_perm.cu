// K11 dense_bin_perm: occupied bins -> the dense gather permutation and
// the occupied count.
//
// Replaces spark_rapids_tpu/ops/segmented.py:297 dense_bin_perm (a cumsum
// plus a mode="drop" scatter that XLA compiles): out[j] is the j-th
// occupied bin for j < num_occupied, and 0 past it (the zeros the
// reference's scatter leaves); *count is num_occupied, the binned
// partial's group count (exec/operators.py took it from a separate
// reduction and cast before).
//
// Bound on the H100: bytes. It must read the occupancy (1 byte a bin) and
// write the permutation (4 bytes a bin) and the count: 20 KB for q5's
// 4,096 bins, 6 ns at 3.35 TB/s, and 1.6 us at the binned path's largest
// 2^20 bins, so at every size the path gives it the kernel is bound by
// its launches.
//
// Design: up to kOneBlockMaxBins bins, ONE launch of one block of 1,024
// threads (the count written by it too). Each round, thread t reads B
// occupancy bytes at B t (B = 4 up to 4,096 bins, else 16) with one 4- or
// 16-byte load (byte loads at a ragged end or an unaligned input; the
// next round's load is issued before this round is ranked), turns them
// into a bit mask, and the block's exclusive scan of the masks' popcounts
// (warp shuffles, then one shared-memory pass over the 32 warp totals)
// gives each warp where its occupied bins go. The warp then writes them
// in bin order, 32 bins a step (a shuffle of the owning lane's mask, a
// ballot, a store of consecutive positions), so its stores are
// coalesced. After the last round every position i >= count gets 0
// (coalesced) and one thread writes the count. q5's 4,096 bins are one
// round of 4 bytes a thread.
// Past kOneBlockMaxBins K1's three launches run instead: tile counts of
// the occupancy, their one-block scan (which writes the count), and a
// scatter in which each warp ranks its occupied bins with
// __ballot_sync/__popc; a bin at index i >= count also writes out[i] = 0.
// No scatter targets those positions, so the two writes never meet, in
// either design.
//
// kOneBlockMaxBins: device ms a call on one H100 80GB HBM3 at 700.00 W
// (tools/parent_ab.py, bins three in ten occupied; PERF.md section 6),
// one block / the three launches: 4,096 bins 0.0030 / 0.0089, 16,384
// 0.0056 / 0.0093, 32,768 0.0098 (two rounds) / 0.0093, 65,536 0.0181 /
// 0.0092, 2^17 0.035 / 0.0094, 2^20 0.27 / 0.0100. One SM's rounds run
// one after another, so past 2^14 the three launches win. Each thread
// writing its own bins' outputs (uncoalesced) took 0.0040 at 4,096 and
// 0.021 at 65,536; 64 bytes a thread a round, 0.0171 at 65,536.

#include "common.cuh"

namespace srtpu {

constexpr int kBinThreads = 1024;  // the one block
constexpr int kOneBlockMaxBins = 1 << 14;

// bit k of the result: byte k of w is nonzero
__device__ __forceinline__ unsigned nonzero_bytes(unsigned w) {
  w |= w >> 4;
  w |= w >> 2;
  w |= w >> 1;
  // bits 0, 8, 16 and 24 gathered into bits 28-31: the four partial
  // products land on distinct bits, so nothing carries
  return ((w & 0x01010101u) * 0x10204080u) >> 28;
}

// The B occupancy bytes at i as B / 4 words (zeros past n): 16-byte loads
// (one 4-byte load for B = 4) where they are aligned and whole.
template <int B>
__device__ __forceinline__ void load_bins(const uint8_t* __restrict__ occ,
                                          int i, int n, bool vec,
                                          unsigned (&w)[B / 4]) {
  if (vec && i + B <= n) {
    if constexpr (B == 4) {
      w[0] = *reinterpret_cast<const unsigned*>(occ + i);
    } else {
#pragma unroll
      for (int q = 0; q < B / 16; ++q) {
        const uint4 v = reinterpret_cast<const uint4*>(occ + i)[q];
        w[4 * q] = v.x;
        w[4 * q + 1] = v.y;
        w[4 * q + 2] = v.z;
        w[4 * q + 3] = v.w;
      }
    }
    return;
  }
#pragma unroll
  for (int q = 0; q < B / 4; ++q) w[q] = 0u;
#pragma unroll
  for (int k = 0; k < B; ++k)
    if (i + k < n && occ[i + k] != 0) w[k >> 2] |= 1u << ((k & 3) * 8);
}

// B: occupancy bytes a thread a round (4 or 16), so a round covers 1,024 B
// bins and a warp writes its 32 B bins' outputs in B steps.
template <int B>
__global__ void __launch_bounds__(kBinThreads)
dense_one_block_kernel(const uint8_t* __restrict__ occ, int n,
                       int* __restrict__ out, int* __restrict__ count) {
  typedef unsigned long long u64;
  constexpr int kRound = kBinThreads * B;
  __shared__ int warp_tot[2][kBinThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;
  const bool vec =
      (reinterpret_cast<uintptr_t>(occ) & (B < 16 ? B - 1 : 15)) == 0;
  int carry = 0;
  int round = 0;
  unsigned w[B / 4];
  load_bins<B>(occ, threadIdx.x * B, n, vec, w);
  for (int base = 0; base < n; base += kRound, ++round) {
    u64 mask = 0;  // bit k: bin base + B t + k is occupied
#pragma unroll
    for (int q = 0; q < B / 4; ++q) mask |= (u64)nonzero_bytes(w[q]) << 4 * q;
    // the next round's bytes are in flight while this one is ranked
    load_bins<B>(occ, base + kRound + threadIdx.x * B, n, vec, w);
    int tot;
    const int pos = carry + block_exclusive_scan<int, kBinThreads / 32>(
                                __popcll(mask), warp_tot[round & 1], tot);
    // the warp writes its bins' occupied ones in B steps of 32 bins, each
    // a store of consecutive positions: bin wbase + 32 j + lane is bit
    // (32 j + lane) % B of lane (32 j + lane) / B's mask
    int wpos = __shfl_sync(kFull, pos, 0);
    const int wbase = base + warp * 32 * B;
#pragma unroll
    for (int j = 0; j < B; ++j) {
      const int k = 32 * j + lane;
      const u64 m = __shfl_sync(kFull, mask, k / B);
      const bool o = (m >> (k % B)) & 1u;
      const unsigned b = __ballot_sync(kFull, o);
      if (o) out[wpos + __popc(b & lanes_below)] = wbase + k;
      wpos += __popc(b);
    }
    carry += tot;
  }
  for (int i = carry + threadIdx.x; i < n; i += kBinThreads) out[i] = 0;
  if (threadIdx.x == 0) *count = carry;
}

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

// occupied: [n] bool; out: [n] int32; count: one int32 (the occupied
// bins); scratch: 2 * ceil(n / 4096) int32 (the three launches' tile sums
// and offsets). route: 0 picks by kOneBlockMaxBins (the port's), 1 the one
// block, 2 the three launches (tools/parent_ab.py times both).
extern "C" int srtpu_dense_bin_perm(const void* occupied, int n, void* out,
                                    void* count, void* scratch, int route,
                                    void* stream) {
  if (n < 1 || route < 0 || route > 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (route == 1 || (route == 0 && n <= kOneBlockMaxBins)) {
    const uint8_t* occ = (const uint8_t*)occupied;
    if (n <= 4 * kBinThreads)
      dense_one_block_kernel<4><<<1, kBinThreads, 0, s>>>(occ, n, (int*)out,
                                                          (int*)count);
    else
      dense_one_block_kernel<16><<<1, kBinThreads, 0, s>>>(
          occ, n, (int*)out, (int*)count);
    return (int)cudaGetLastError();
  }
  const int tiles = num_tiles(n);
  int* sums = (int*)scratch;
  int* offsets = sums + tiles;
  tile_sums_kernel<uint8_t, int><<<tiles, kThreads, 0, s>>>(
      (const uint8_t*)occupied, n, sums);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scan_tiles_kernel<int><<<1, kScanThreads, 0, s>>>(sums, tiles, offsets,
                                                    (int*)count);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dense_scatter_kernel<<<tiles, kThreads, 0, s>>>(
      (const uint8_t*)occupied, n, offsets, (const int*)count, (int*)out);
  return (int)cudaGetLastError();
}
