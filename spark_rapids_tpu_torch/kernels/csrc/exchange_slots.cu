// K37 exchange_slots: the send side of the mesh engine's all-to-all.
//
// Replaces spark_rapids_tpu/parallel/collective.py:139 all_to_all_batch's
// slot assignment (its :157-167 one-hot cumsum rank, the overflow flag and
// the per-destination counts; :124 _scatter_to_slots' placement). Row i of
// a shard goes to destination pid[i]; its rank is its FIFO position among
// the live rows (i < num_rows) of that destination. For each of the
// n_dest * slot send slots, slot j of destination d, it writes:
//   src_row[d * slot + j] = the live row of rank j in d (0 when none),
//   live[d * slot + j]    = whether there is one (j < count_d and j < slot);
// and send_counts[d] = min(count_d, slot), *overflow = any count_d > slot.
// Rows past a destination's slot are dropped, as the reference's scatter
// with mode="drop" drops them. One K8 launch with `live` as its mask then
// writes every leaf of the batch into its [n_dest, slot] blocks.
//
// Bound on the H100: bytes. It reads pid (4 B a row) and writes src_row
// and live (5 B a slot): (4 * cap + 5 * n_dest * slot) bytes.
//
// Design: four launches with B = n_dest + 1 buckets (the last one dead
// rows'), on K7's tile scan:
//   1. hist (partition_tiles.cuh): each 1,024-row tile's rows per bucket;
//   2. scan_tiles (common.cuh): off[b * tiles + t], where tile t's rows of
//      bucket b start in bucket-sorted order, off[b * tiles] where bucket
//      b starts, off[(b + 1) * tiles] - off[b * tiles] its count;
//   3. fill: the live marks of every slot and src_row 0 under the dead
//      ones, and from block (0, 0) the send counts and the overflow flag;
//   4. scatter: one warp a tile walks its rows in 32 rounds of 32 as K7's
//      scatter does (ranks in lane order among lanes of one bucket behind
//      a per-bucket carry), the carry starting at the tile's rank within
//      the bucket, off[b * tiles + t] - off[b * tiles]; a row of rank
//      below the slot writes its index to its slot.
// Launches 3 and 4 write disjoint slots. Counts are exact however the
// rows spread, all of them to one destination included.

#include "partition_tiles.cuh"

namespace srtpu {

constexpr int kFillThreads = 256;
constexpr int kFillBlocksMax = 1024;   // per destination (grid-stride)

__device__ __forceinline__ long long bucket_count(const int* __restrict__ off,
                                                  int b, int tiles) {
  return (long long)off[(long long)(b + 1) * tiles] -
         off[(long long)b * tiles];
}

__global__ void __launch_bounds__(kFillThreads)
slots_fill_kernel(const int* __restrict__ off, int tiles, int ndest,
                  long long slot, int* __restrict__ src_row,
                  bool* __restrict__ live, int* __restrict__ send_counts,
                  bool* __restrict__ overflow) {
  const int d = blockIdx.y;
  const long long cnt = bucket_count(off, d, tiles);
  const long long base = (long long)d * slot;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       j < slot; j += (long long)gridDim.x * blockDim.x) {
    const bool l = j < cnt;
    live[base + j] = l;
    if (!l) src_row[base + j] = 0;
  }
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) {
    bool over = false;
    for (int b = 0; b < ndest; ++b) {
      const long long c = bucket_count(off, b, tiles);
      send_counts[b] = (int)(c < slot ? c : slot);
      over |= c > slot;
    }
    *overflow = over;
  }
}

__global__ void __launch_bounds__(32)
slots_scatter_kernel(const int* __restrict__ pid, long long n,
                     const int* __restrict__ nrows_dev, long long nrows_host,
                     int ndest, int tiles, const int* __restrict__ off,
                     long long slot, int* __restrict__ src_row) {
  extern __shared__ int carry[];
  const long long live_rows = nrows_dev != nullptr ? *nrows_dev : nrows_host;
  const long long base = (long long)blockIdx.x * kPartTile;
  if (base >= live_rows) return;  // a tile of dead rows places nothing
  const int lane = threadIdx.x;
  for (int b = lane; b < ndest; b += 32)
    carry[b] = off[(long long)b * tiles + blockIdx.x] -
               off[(long long)b * tiles];
  __syncwarp();
  const unsigned lanes_below = (1u << lane) - 1u;
  for (int r = 0; r < kPartTile / 32; ++r) {
    const long long i = base + r * 32 + lane;
    const bool in = i < n && i < live_rows;
    // dead rows and rows past n take a key of their own: they match none
    const int key = in ? bucket_of(pid, i, live_rows, ndest, 0) : -1 - lane;
    const unsigned same = __match_any_sync(kFull, key);
    int rank = 0;
    if (in) rank = carry[key] + __popc(same & lanes_below);
    __syncwarp();
    if (in) {
      if (rank < slot) src_row[(long long)key * slot + rank] = (int)i;
      if ((same & lanes_below) == 0) carry[key] += __popc(same);
    }
    __syncwarp();
  }
}

}  // namespace srtpu

using namespace srtpu;

// pid: [n] int32; the live rows are *nrows_dev when given, else
// nrows_host. src_row: [ndest * slot] int32 out; live: [ndest * slot] bool
// out; send_counts: [ndest] int32 out; overflow: one bool out; scratch:
// [2 * (ndest + 1) * ceil(n / 1024) + 1] int32.
extern "C" int srtpu_exchange_slots(const void* pid, long long n,
                                    const void* nrows_dev,
                                    long long nrows_host, int ndest,
                                    long long slot, void* src_row,
                                    void* live, void* send_counts,
                                    void* overflow, void* scratch,
                                    void* stream) {
  if (pid == nullptr || ndest < 1 || ndest + 1 > kMaxBuckets || n <= 0 ||
      n > 0x7fffffffLL || slot < 1 || slot > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int tiles = (int)((n + kPartTile - 1) / kPartTile);
  const int nb = ndest + 1;
  const long long cells = (long long)nb * tiles;
  if (cells > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  int* hist = (int*)scratch;
  int* off = hist + cells;
  int* total = off + cells;
  const size_t smem = (size_t)nb * sizeof(int);
  part_hist_kernel<<<tiles, kPartHistThreads, smem, s>>>(
      (const int*)pid, n, (const int*)nrows_dev, nrows_host, ndest, 0, tiles,
      hist);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scan_tiles_kernel<int><<<1, kScanThreads, 0, s>>>(hist, (int)cells, off,
                                                     total);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  long long fill_blocks = (slot + kFillThreads - 1) / kFillThreads;
  if (fill_blocks > kFillBlocksMax) fill_blocks = kFillBlocksMax;
  slots_fill_kernel<<<dim3((unsigned)fill_blocks, (unsigned)ndest),
                      kFillThreads, 0, s>>>(
      off, tiles, ndest, slot, (int*)src_row, (bool*)live, (int*)send_counts,
      (bool*)overflow);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  slots_scatter_kernel<<<tiles, 32, (size_t)ndest * sizeof(int), s>>>(
      (const int*)pid, n, (const int*)nrows_dev, nrows_host, ndest, tiles,
      off, slot, (int*)src_row);
  return (int)cudaGetLastError();
}
