// K13 merge_runs: merge two sorted runs into one without re-sorting.
//
// Replaces spark_rapids_tpu/ops/sortops.py:89 merge_sorted (two vectorised
// binary searches and one scatter per leaf, which XLA compiles). Runs A and
// B hold live rows [0, na) and [0, nb), each sorted by its int64 key words
// ([W, ca] and [W, cb], word-major, K9's pack). Each live row's place in
// the merged run is its own index plus its rank in the other run:
//   dest_a[i] = i + (rows of B whose key is <  row i's)   (lower bound)
//   dest_b[j] = j + (rows of A whose key is <= row j's)   (upper bound)
// so a tie puts the row of A first, and dest is a bijection onto
// [0, na + nb). Dead rows are dropped (the reference scatters them out of
// range). Then every leaf of both runs (data, validity, lengths, string
// bytes; the caller pads both runs' byte matrices to one width) is
// scattered to dest, and rows [na + nb, out_cap) of every output are zero,
// as the reference's zero-initialised scatter leaves them.
//
// Bound on the H100: bytes. It reads the key words of the live rows once
// and every leaf row once, and writes every output row once: two 2^22-row
// (store, qty) runs (2 rank + 2 value words, 18 bytes of leaves a row) move
// about 50 bytes a row, 0.13 ms at 3.35 TB/s. The searches do about
// 2 * W * log2(rows) compares a row, below the integer rate.
//
// Design: two launches on the caller's stream. 1. one thread a row of
// either run finds dest with the lexicographic search K2 uses
// (search.cuh); 2. one launch scatters every leaf (a table of up to 32
// leaves in parameter space, blockIdx.y picking the leaf, as K8 gathers):
// a row moves in the widest unit (16, 8, 4, 2 or 1 bytes) that divides it
// and both base addresses, and the threads past both runs zero the tail.

#include "common.cuh"
#include "search.cuh"

namespace srtpu {

struct MergeLeaf {
  const void* src_a;  // [ca, row_bytes]
  const void* src_b;  // [cb, row_bytes]
  void* dst;          // [out_cap, row_bytes]
  int row_bytes;
  int unit;           // bytes per load/store; divides row_bytes
};

constexpr int kMaxMergeLeaves = 32;

struct MergeLeaves {
  MergeLeaf l[kMaxMergeLeaves];
};

__global__ void __launch_bounds__(kThreads)
merge_dest_kernel(const i64* __restrict__ ka, i64 ca,
                  const i64* __restrict__ kb, i64 cb, int W,
                  const int* __restrict__ na_p, const int* __restrict__ nb_p,
                  int* __restrict__ dest) {
  const int na = *na_p, nb = *nb_p;
  for (i64 t = (i64)blockIdx.x * blockDim.x + threadIdx.x; t < ca + cb;
       t += (i64)gridDim.x * blockDim.x) {
    if (t < ca) {
      dest[t] = t < na ? (int)t + key_search(kb, cb, 0, nb, ka, ca, t, W,
                                             false)
                       : -1;
    } else {
      const i64 j = t - ca;
      dest[t] = j < nb ? (int)j + key_search(ka, ca, 0, na, kb, cb, j, W,
                                             true)
                       : -1;
    }
  }
}

template <typename T>
__device__ __forceinline__ void move_row(const MergeLeaf& L, const T* src,
                                         i64 from, i64 to) {
  const int words = L.row_bytes / (int)sizeof(T);
  T* dst = (T*)L.dst;
  for (int w = 0; w < words; ++w) dst[to * words + w] = src[from * words + w];
}

template <typename T>
__device__ __forceinline__ void zero_row(const MergeLeaf& L, i64 to) {
  const int words = L.row_bytes / (int)sizeof(T);
  T* dst = (T*)L.dst;
  for (int w = 0; w < words; ++w) dst[to * words + w] = T{};
}

template <typename T>
__device__ __forceinline__ void merge_leaf(const MergeLeaf& L, i64 ca,
                                           i64 cb, i64 out_cap, i64 live,
                                           const int* __restrict__ dest) {
  const i64 total = ca + cb + out_cap;
  for (i64 t = (i64)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += (i64)gridDim.x * blockDim.x) {
    if (t < ca + cb) {
      const int d = dest[t];
      if (d < 0 || d >= out_cap) continue;
      if (t < ca)
        move_row<T>(L, (const T*)L.src_a, t, d);
      else
        move_row<T>(L, (const T*)L.src_b, t - ca, d);
    } else {
      const i64 r = t - ca - cb;
      if (r >= live) zero_row<T>(L, r);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
merge_scatter_kernel(MergeLeaves leaves, i64 ca, i64 cb, i64 out_cap,
                     const int* __restrict__ na_p,
                     const int* __restrict__ nb_p,
                     const int* __restrict__ dest) {
  const MergeLeaf L = leaves.l[blockIdx.y];
  const i64 live = (i64)*na_p + *nb_p;
  switch (L.unit) {
    case 16: merge_leaf<uint4>(L, ca, cb, out_cap, live, dest); break;
    case 8: merge_leaf<unsigned long long>(L, ca, cb, out_cap, live, dest);
      break;
    case 4: merge_leaf<uint32_t>(L, ca, cb, out_cap, live, dest); break;
    case 2: merge_leaf<uint16_t>(L, ca, cb, out_cap, live, dest); break;
    default: merge_leaf<uint8_t>(L, ca, cb, out_cap, live, dest);
  }
}

}  // namespace srtpu

using namespace srtpu;

// ka: [W, ca] int64, kb: [W, cb] int64 (each run's rows sorted); na, nb:
// 0-d int32 live rows; leaves: host array of nleaves MergeLeaf (at most
// 32); dest: scratch of ca + cb int32 (kept for the next leaf chunk: pass
// with_dest 0 to reuse it).
extern "C" int srtpu_merge_runs(const void* ka, long long ca, const void* kb,
                                long long cb, int W, const void* na,
                                const void* nb, long long out_cap,
                                const MergeLeaf* leaves, int nleaves,
                                void* dest, int with_dest, int sm_count,
                                void* stream) {
  if (nleaves < 1 || nleaves > kMaxMergeLeaves || W < 1 || ca < 1 ||
      cb < 1 || out_cap < 1)
    return (int)cudaErrorInvalidValue;
  MergeLeaves t = {};
  for (int k = 0; k < nleaves; ++k) {
    const MergeLeaf& L = leaves[k];
    if (L.row_bytes <= 0 || L.unit <= 0 || L.row_bytes % L.unit)
      return (int)cudaErrorInvalidValue;
    t.l[k] = L;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const long long cap = 8LL * sm_count;
  if (with_dest) {
    long long blocks = (ca + cb + kThreads - 1) / kThreads;
    if (blocks > cap) blocks = cap;
    merge_dest_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
        (const i64*)ka, ca, (const i64*)kb, cb, W, (const int*)na,
        (const int*)nb, (int*)dest);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  long long blocks = (ca + cb + out_cap + kThreads - 1) / kThreads;
  if (blocks > cap) blocks = cap;
  const dim3 grid((unsigned)blocks, (unsigned)nleaves);
  merge_scatter_kernel<<<grid, kThreads, 0, s>>>(
      t, ca, cb, out_cap, (const int*)na, (const int*)nb, (const int*)dest);
  return (int)cudaGetLastError();
}
