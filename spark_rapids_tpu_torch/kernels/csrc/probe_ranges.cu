// K2 probe_ranges: per probe row, the range of equal keys in the sorted
// build side.
//
// Replaces spark_rapids_tpu/ops/joinops.py:86 _binary_search and :116
// probe_ranges (two vectorised binary searches that XLA compiles). For
// probe row p with key words q[0..W), over build rows [0, valid_bound)
// sorted lexicographically by their W int64 words:
//   lo[p]    = first row whose key is >= q   (lower bound)
//   count[p] = (first row whose key is > q) - lo[p], or 0 when the probe
//              row is dead or has a null key (all_valid[p] == 0).
// lo is written for every row, dead ones included, as the reference does.
//
// Bound on the H100: bytes. It must read W int64 words and one mask byte
// per probe row and write two int32, so q5's 8,388,608 probe rows with W=1
// need 109 MB, about 33 us at 3.35 TB/s. The search does about 2 log2(2048)
// = 22 compares per row, far below the integer rate.
//
// Design: one thread per probe row (grid-stride), both bounds in one pass;
// the upper-bound search starts from the lower bound. The build keys sit in
// shared memory when W * build_cap * 8 bytes fit in 48 KB (q5: 16 KB), so
// the ~22 dependent loads per row hit shared memory, not L2. Otherwise they
// are read from device memory through L1.

#include "common.cuh"

namespace srtpu {

constexpr int kProbeSmemBytes = 48 * 1024;

// sign of (build row `mid`) - (probe row p), lexicographic over W words
__device__ __forceinline__ int key_cmp(const i64* __restrict__ build,
                                       int bcap, int mid,
                                       const i64* __restrict__ probe,
                                       i64 n, i64 p, int W) {
  for (int w = 0; w < W; ++w) {
    const i64 b = build[(i64)w * bcap + mid];
    const i64 q = probe[(i64)w * n + p];
    if (b < q) return -1;
    if (b > q) return 1;
  }
  return 0;
}

__global__ void __launch_bounds__(kThreads)
probe_ranges_kernel(const i64* __restrict__ build, int bcap, int W,
                    const int* __restrict__ bound_p,
                    const i64* __restrict__ probe, i64 n,
                    const uint8_t* __restrict__ all_valid,
                    int* __restrict__ lo_out, int* __restrict__ cnt_out,
                    int use_smem) {
  extern __shared__ i64 sbuild[];
  const i64* keys = build;
  if (use_smem) {
    for (int i = threadIdx.x; i < W * bcap; i += blockDim.x)
      sbuild[i] = build[i];
    __syncthreads();
    keys = sbuild;
  }
  const int bound = *bound_p;
  for (i64 p = (i64)blockIdx.x * blockDim.x + threadIdx.x; p < n;
       p += (i64)gridDim.x * blockDim.x) {
    int lo = 0, hi = bound;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (key_cmp(keys, bcap, mid, probe, n, p, W) < 0) lo = mid + 1;
      else hi = mid;
    }
    const int lower = lo;
    hi = bound;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (key_cmp(keys, bcap, mid, probe, n, p, W) <= 0) lo = mid + 1;
      else hi = mid;
    }
    lo_out[p] = lower;
    cnt_out[p] = all_valid[p] ? lo - lower : 0;
  }
}

}  // namespace srtpu

using namespace srtpu;

// build: [W, bcap] int64 (row-major, sorted); probe: [W, n] int64;
// valid_bound: 0-d int32; all_valid: [n] bool; lo, counts: [n] int32.
extern "C" int srtpu_probe_ranges(const void* build, int bcap, int W,
                                  const void* valid_bound, const void* probe,
                                  long long n, const void* all_valid,
                                  void* lo, void* counts, int sm_count,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = (size_t)W * bcap * sizeof(i64);
  const int use_smem = smem <= (size_t)kProbeSmemBytes;
  i64 blocks = (n + kThreads - 1) / kThreads;
  const i64 max_blocks = (i64)sm_count * 8;
  if (blocks > max_blocks) blocks = max_blocks;
  if (blocks < 1) blocks = 1;
  probe_ranges_kernel<<<(int)blocks, kThreads, use_smem ? smem : 0, s>>>(
      (const i64*)build, bcap, W, (const int*)valid_bound, (const i64*)probe,
      n, (const uint8_t*)all_valid, (int*)lo, (int*)counts, use_smem);
  return (int)cudaGetLastError();
}
