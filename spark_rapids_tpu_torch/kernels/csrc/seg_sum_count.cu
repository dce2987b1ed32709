// K4 seg_sum_count: masked segmented sums of k <= 4 value vectors, each
// with its own optional mask and count, plus a row count, over segment
// ids, in one pass over the rows.
//
// Replaces spark_rapids_tpu/ops/segmented.py:349 seg_count, :358 seg_sum
// and :371 seg_sum_count (jax.ops.segment_sum on the CPU backend), and the
// one-sweep partial of exec/operators.py:1005 _binned_all_sums (the TPU's
// f32-chunk one-hot matmul, _mm_pass_multi :192, is a TPU limit and is not
// copied). For every row r with valid[r] and 0 <= g = gid[r] < nseg:
//   counts[g] += 1, and for each j with no mask or mask[j][r]:
//   sums[j][g] += values[j][r],  vcounts[j][g] += 1.
// int64 sums wrap exactly as segment_sum does (unsigned atomics); float64
// sums use native atomicAdd(double), so their order varies between runs.
//
// Bound on the H100: bytes. It must read valid (1 B) for every row, and
// gid (4 B) and each mask (1 B) for the valid rows and each value (8 B)
// where its mask holds: q5's binned partial (k = 2 float64 vectors, about
// 3.7M valid rows in 4,194,304 slots) is about 86 MB, 26 us at 3.35 TB/s.
//
// Design: grid-stride over rows. When the ids are unsorted (the binned
// aggregate) and the bins fit in shared memory, each block keeps private
// bins (k sums, k counts and a row count per segment), adds into them with
// shared-memory atomics, and flushes its occupied bins with global
// atomics, so device memory sees a few atomics per block instead of one
// per row. Sorted ids (the merge after a sort) or bins too large for
// shared memory add straight into device memory.

#include "common.cuh"

namespace srtpu {

constexpr int kMaxK = 4;

struct SegInputs {
  const void* v[kMaxK];     // value vectors [n]
  const uint8_t* m[kMaxK];  // their masks [n], or null for "every row"
};

__device__ __forceinline__ void add_to(double* p, double v) { atomicAdd(p, v); }
__device__ __forceinline__ void add_to(i64* p, i64 v) {
  atomicAdd((unsigned long long*)p, (unsigned long long)v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
seg_sum_shared_kernel(SegInputs in, int k, const uint8_t* __restrict__ valid,
                      const int* __restrict__ gid, i64 n, int nseg,
                      T* __restrict__ sums, i64* __restrict__ vcounts,
                      i64* __restrict__ counts) {
  extern __shared__ __align__(8) unsigned char smem_raw[];
  T* ssum = (T*)smem_raw;                      // [k][nseg]
  i64* svcnt = (i64*)(ssum + (i64)k * nseg);   // [k][nseg]
  i64* scnt = svcnt + (i64)k * nseg;           // [nseg]
  for (int i = threadIdx.x; i < k * nseg; i += blockDim.x) {
    ssum[i] = T(0);
    svcnt[i] = 0;
  }
  for (int i = threadIdx.x; i < nseg; i += blockDim.x) scnt[i] = 0;
  __syncthreads();
  for (i64 r = (i64)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += (i64)gridDim.x * blockDim.x) {
    if (!valid[r]) continue;
    const int g = gid[r];
    if (g < 0 || g >= nseg) continue;
    add_to(&scnt[g], (i64)1);
    for (int j = 0; j < k; ++j) {
      if (in.m[j] != nullptr && !in.m[j][r]) continue;
      add_to(&ssum[(i64)j * nseg + g], ((const T*)in.v[j])[r]);
      add_to(&svcnt[(i64)j * nseg + g], (i64)1);
    }
  }
  __syncthreads();
  // a bin no valid row reached holds only zeros: skip it
  for (int g = threadIdx.x; g < nseg; g += blockDim.x) {
    const i64 c = scnt[g];
    if (c == 0) continue;
    if (counts != nullptr) add_to(&counts[g], c);
    for (int j = 0; j < k; ++j) {
      const i64 at = (i64)j * nseg + g;
      add_to(&sums[at], ssum[at]);
      if (vcounts != nullptr) add_to(&vcounts[at], svcnt[at]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
seg_sum_global_kernel(SegInputs in, int k, const uint8_t* __restrict__ valid,
                      const int* __restrict__ gid, i64 n, int nseg,
                      T* __restrict__ sums, i64* __restrict__ vcounts,
                      i64* __restrict__ counts) {
  for (i64 r = (i64)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += (i64)gridDim.x * blockDim.x) {
    if (!valid[r]) continue;
    const int g = gid[r];
    if (g < 0 || g >= nseg) continue;
    if (counts != nullptr) add_to(&counts[g], (i64)1);
    for (int j = 0; j < k; ++j) {
      if (in.m[j] != nullptr && !in.m[j][r]) continue;
      const i64 at = (i64)j * nseg + g;
      add_to(&sums[at], ((const T*)in.v[j])[r]);
      if (vcounts != nullptr) add_to(&vcounts[at], (i64)1);
    }
  }
}

template <typename T>
int launch(const SegInputs& in, int k, const void* valid, const void* gid,
           i64 n, int nseg, void* sums, void* vcounts, void* counts,
           int privatize, int sm_count, int smem_optin, cudaStream_t s) {
  if (k > 0) {
    cudaError_t e = cudaMemsetAsync(sums, 0, (size_t)k * nseg * sizeof(T), s);
    if (e != cudaSuccess) return (int)e;
  }
  if (vcounts != nullptr) {
    cudaError_t e =
        cudaMemsetAsync(vcounts, 0, (size_t)k * nseg * sizeof(i64), s);
    if (e != cudaSuccess) return (int)e;
  }
  if (counts != nullptr) {
    cudaError_t e = cudaMemsetAsync(counts, 0, (size_t)nseg * sizeof(i64), s);
    if (e != cudaSuccess) return (int)e;
  }
  if (n == 0) return (int)cudaGetLastError();
  i64 blocks = (n + kThreads - 1) / kThreads;
  if (blocks > (i64)sm_count * 4) blocks = (i64)sm_count * 4;
  const size_t smem =
      (size_t)nseg * (k * (sizeof(T) + sizeof(i64)) + sizeof(i64));
  if (privatize && smem <= (size_t)smem_optin) {
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          seg_sum_shared_kernel<T>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    seg_sum_shared_kernel<T><<<(int)blocks, kThreads, smem, s>>>(
        in, k, (const uint8_t*)valid, (const int*)gid, n, nseg, (T*)sums,
        (i64*)vcounts, (i64*)counts);
  } else {
    seg_sum_global_kernel<T><<<(int)blocks, kThreads, 0, s>>>(
        in, k, (const uint8_t*)valid, (const int*)gid, n, nseg, (T*)sums,
        (i64*)vcounts, (i64*)counts);
  }
  return (int)cudaGetLastError();
}

}  // namespace srtpu

using namespace srtpu;

// is_float: 0 -> values and sums int64, 1 -> float64. values, masks: host
// arrays of k device pointers (a null mask admits every valid row);
// valid: [n] bool; gid: [n] int32; sums: [k, nseg] (null when k == 0);
// vcounts: [k, nseg] int64 or null; counts: [nseg] int64 or null.
extern "C" int srtpu_seg_sum_count(int is_float, int k,
                                   const void* const* values,
                                   const void* const* masks,
                                   const void* valid, const void* gid,
                                   long long n, int nseg, void* sums,
                                   void* vcounts, void* counts, int privatize,
                                   int sm_count, int smem_optin,
                                   void* stream) {
  if (k < 0 || k > kMaxK) return (int)cudaErrorInvalidValue;
  SegInputs in = {};
  for (int j = 0; j < k; ++j) {
    in.v[j] = values[j];
    in.m[j] = (const uint8_t*)masks[j];
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (is_float)
    return launch<double>(in, k, valid, gid, n, nseg, sums, vcounts, counts,
                          privatize, sm_count, smem_optin, s);
  return launch<i64>(in, k, valid, gid, n, nseg, sums, vcounts, counts,
                     privatize, sm_count, smem_optin, s);
}
