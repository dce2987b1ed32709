// K1 compact_perm: stable partition of a keep mask, kept rows first.
//
// Replaces spark_rapids_tpu/ops/filterops.py:16 compact_perm (a cumsum
// plus an inverse scatter that XLA compiles). Output is the same bijection
// on [0, cap): perm[j] is the row that lands at position j; kept rows fill
// [0, n_keep) and dropped rows [n_keep, cap), both in row order.
//
// Bound on the H100: bytes. It must read the mask (1 B/row) and write perm
// (4 B/row), so 8,388,608 rows need 42 MB, about 12.5 us at 3.35 TB/s;
// the few integer operations per row are far below the card's rate.
//
// Design: three launches on the caller's stream.
//   1. tile_sums: keep count of every 4,096-row tile;
//   2. scan_tiles: exclusive scan of the tile counts in one block, which
//      also writes n_keep (left on the device: the caller syncs on it
//      only where the operator needs the row count on the host);
//   3. scatter: each tile re-reads its mask; per round a warp ranks its
//      rows with __ballot_sync/__popc, warp totals go through shared
//      memory, and each row writes its own index at its final position.
// The mask is read twice (5 B/row of traffic instead of the bound's 1);
// a single-pass decoupled look-back scan is later work.

#include "common.cuh"

namespace srtpu {

__global__ void __launch_bounds__(kThreads)
compact_scatter_kernel(const uint8_t* __restrict__ keep, int cap,
                       const int* __restrict__ tile_off,
                       const int* __restrict__ n_keep_p,
                       int* __restrict__ perm) {
  __shared__ int keep_tot[2][kWarps];
  __shared__ int drop_tot[2][kWarps];
  const int n_keep = *n_keep_p;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;
  const int base = blockIdx.x * kTile;
  int carry_keep = tile_off[blockIdx.x];
  int carry_drop = base - carry_keep;  // every row before base is live
  for (int r = 0; r < kItems; ++r) {
    const int i = base + r * kThreads + threadIdx.x;
    const bool in = i < cap;
    const bool k = in && keep[i] != 0;
    const unsigned km = __ballot_sync(kFull, k);
    const unsigned dm = __ballot_sync(kFull, in && !k);
    const int buf = r & 1;
    if (lane == 0) {
      keep_tot[buf][warp] = __popc(km);
      drop_tot[buf][warp] = __popc(dm);
    }
    __syncthreads();
    int kb = 0, db = 0, kt = 0, dt = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int a = keep_tot[buf][w], b = drop_tot[buf][w];
      if (w < warp) {
        kb += a;
        db += b;
      }
      kt += a;
      dt += b;
    }
    if (k) {
      perm[carry_keep + kb + __popc(km & lanes_below)] = i;
    } else if (in) {
      perm[n_keep + carry_drop + db + __popc(dm & lanes_below)] = i;
    }
    carry_keep += kt;
    carry_drop += dt;
  }
}

}  // namespace srtpu

using namespace srtpu;

// keep: [cap] bool (1 byte); perm: [cap] int32; n_keep: 0-d int32;
// scratch: [2 * ceil(cap / 4096)] int32.
extern "C" int srtpu_compact_perm(const void* keep, int cap, void* perm,
                                  void* n_keep, void* scratch,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int tiles = num_tiles(cap);
  int* sums = (int*)scratch;
  int* offsets = sums + tiles;
  tile_sums_kernel<uint8_t, int><<<tiles, kThreads, 0, s>>>(
      (const uint8_t*)keep, cap, sums);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scan_tiles_kernel<int><<<1, kScanThreads, 0, s>>>(sums, tiles, offsets,
                                                    (int*)n_keep);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  compact_scatter_kernel<<<tiles, kThreads, 0, s>>>(
      (const uint8_t*)keep, cap, offsets, (const int*)n_keep, (int*)perm);
  return (int)cudaGetLastError();
}

extern "C" const char* srtpu_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
