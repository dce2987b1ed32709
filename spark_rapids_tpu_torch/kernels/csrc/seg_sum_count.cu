// K4 seg_sum_count: masked segmented sums of k <= 8 value vectors, each
// with its own optional mask and count, plus a row count, over segment
// ids, in one pass over the rows.
//
// Replaces spark_rapids_tpu/ops/segmented.py:349 seg_count, :358 seg_sum
// and :371 seg_sum_count (jax.ops.segment_sum on the CPU backend), :392
// seg_multi_sum (the moment and bivariate aggregates' power and cross
// sums, expr/aggregates.py:407, :533), and the one-sweep partial of
// exec/operators.py:1005 _binned_all_sums (the TPU's
// f32-chunk one-hot matmul, _mm_pass_multi :192, is a TPU limit and is not
// copied). For every row r with valid[r] and 0 <= g = gid[r] < nseg:
//   counts[g] += 1, and for each j with no mask or mask[j][r]:
//   sums[j][g] += values[j][r],  vcounts[j][g] += 1.
// int64 sums wrap exactly as segment_sum does (unsigned adds); counts are
// exact.
//
// Bound on the H100: bytes. It must read valid (1 B) for every row, and
// gid (4 B) and each mask (1 B) for the valid rows and each value (8 B)
// where its mask holds, and write the outputs, k sums, the value counts
// asked for and the row count, each [nseg] of 8 bytes: q5's binned
// partial (k = 2 float64 vectors, about 3.7M valid rows in 4,194,304
// slots) is about 86 MB, 26 us at 3.35 TB/s; posexplode's sums (k = 1
// int64 with the count, 59,986,052 valid rows of 2^26 slots sorted into
// 21 groups, nseg = 2^26) read 0.79 GB and write 1.07 GB, 0.56 ms.
//
// Design: two routes, which the caller picks (ops/segmented.py
// seg_sum_route).
// - Sorted ids (the merge after a sort, every group-by of the sorted
//   path), and bins too many for shared memory: seg_sum_runs_kernel.
//   Each block owns one contiguous chunk of rows, read in coalesced steps;
//   a thread folds the rows it reads into one open run of equal ids in
//   registers (k sums, k value counts, a row count) and flushes it with
//   device atomics only where the id changes. At the chunk's end the
//   block's open runs reduce by id across each warp (head flags where the
//   id changes, shuffles inside each stretch of equal ids) and then across
//   the warps, and each run left adds its totals once. Over sorted ids
//   that is one atomic a run, block and output (2k + 1 for a chunk inside
//   one group), where the rows of a group used to take one each, all on
//   one address: 21 groups over 60M rows were 120M atomics serialised at
//   the L2. Unsorted ids stay right: they flush at every change of id.
// - Unsorted ids (the binned aggregate) whose bins fit in shared memory:
//   seg_sum_shared_kernel. Each block keeps private bins (k sums, k
//   counts and a row count per segment), adds into them with
//   shared-memory atomics, and flushes its occupied bins with global
//   atomics (k = 8 takes 136 bytes a bin: 1,709 bins fit 227 KB).
//
// float64 sums add in another order than the plain version's
// scatter_add_: a thread's rows in row order, then a shuffle tree, then
// atomics whose order varies between runs (no deterministic fold was
// built). Tolerances (chip_smoke.py): within 1e-12 relative of the
// exactly rounded sum of each group (math.fsum's) at posexplode's 60M
// rows, and within the project's 1e-9 of the plain version (F64_ATOMIC_TOL
// = 1e-12 at the smaller shapes).

#include "common.cuh"

namespace srtpu {

constexpr int kMaxK = 8;

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

// The accumulator of a value type: int64 sums add as unsigned, so they
// wrap as segment_sum's do, without signed overflow.
template <typename T> struct Acc { typedef T type; };
template <> struct Acc<i64> { typedef unsigned long long type; };

__device__ __forceinline__ void add_to(unsigned long long* p,
                                       unsigned long long v) {
  atomicAdd(p, v);
}

// rows a thread loads a step: more for few vectors (more bytes in flight)
template <int K>
struct RunItems {
  static constexpr int value = K <= 2 ? 8 : 4;
};

// One open run: its id (-1: none) and its partials.
template <typename A, int K>
struct Run {
  int g;
  A s[K > 0 ? K : 1];
  i64 vc[K > 0 ? K : 1];
  i64 c;
  __device__ __forceinline__ void clear(int id) {
    g = id;
    c = 0;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      s[j] = A(0);
      vc[j] = 0;
    }
  }
  // the run's totals to device memory; a sum no row reached holds zero
  __device__ __forceinline__ void flush(int nseg, A* sums, i64* vcounts,
                                        i64* counts) const {
    if (g < 0) return;
    if (counts != nullptr) add_to(&counts[g], c);
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (vc[j] == 0) continue;
      const i64 at = (i64)j * nseg + g;
      add_to(&sums[at], s[j]);
      if (vcounts != nullptr) add_to(&vcounts[at], vc[j]);
    }
  }
};

// Segmented reduction of one run a lane over a warp, keyed on the id:
// each lane that heads a maximal stretch of equal ids (lane 0 always)
// ends with the stretch's totals. Returns whether this lane is a head.
template <typename A, int K>
__device__ __forceinline__ bool warp_reduce_runs(Run<A, K>& r) {
  const int lane = threadIdx.x & 31;
  const int up = __shfl_up_sync(kFull, r.g, 1);
  const unsigned heads = __ballot_sync(kFull, lane == 0 || up != r.g);
  const unsigned after = lane == 31 ? 0u : heads & (~0u << (lane + 1));
  const int last = after ? __ffs(after) - 2 : 31;  // the stretch's last lane
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const bool take = lane + off <= last;
    const i64 c = __shfl_down_sync(kFull, r.c, off);
    if (take) r.c += c;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const A s = __shfl_down_sync(kFull, r.s[j], off);
      const i64 vc = __shfl_down_sync(kFull, r.vc[j], off);
      if (take) {
        r.s[j] += s;
        r.vc[j] += vc;
      }
    }
  }
  return (heads >> lane) & 1;
}

// The sorted-id route (and the route of bins too many for shared memory).
// Block b owns the contiguous rows [b * chunk, (b + 1) * chunk), read a
// step at a time, kThreads x items rows, coalesced (row base + i *
// kThreads + tid), every load of a step issued before any is used. A
// thread folds its rows into one open run in registers while the id stays
// the same and flushes it with device atomics when the id changes. At the
// end the block's open runs reduce by id, a warp and then the block's
// warps, and each remaining run adds its totals once: over sorted ids one
// atomic a run, block and output, where the rows of one id used to take one
// each. Unsorted ids flush at every change of id, which is right, only
// slower.
template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
seg_sum_runs_kernel(SegInputs in, const uint8_t* __restrict__ valid,
                    const int* __restrict__ gid, i64 n, int nseg, i64 chunk,
                    typename Acc<T>::type* __restrict__ sums,
                    i64* __restrict__ vcounts, i64* __restrict__ counts) {
  typedef typename Acc<T>::type A;
  constexpr int R = RunItems<K>::value;
  constexpr int KA = K > 0 ? K : 1;
  __shared__ Run<A, K> warp_runs[kWarps];
  const i64 lo = (i64)blockIdx.x * chunk;
  const i64 hi = lo + chunk < n ? lo + chunk : n;
  Run<A, K> run;
  run.clear(-1);
  for (i64 base = lo; base < hi; base += (i64)kThreads * R) {
    int g[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const i64 r = base + (i64)i * kThreads + threadIdx.x;
      g[i] = -1;
      if (r < hi) {
        const uint8_t ok = __ldcs(valid + r);
        const int x = __ldcs(gid + r);
        if (ok && x >= 0 && x < nseg) g[i] = x;
      }
    }
    T v[R][KA];
    bool m[R][KA];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const i64 r = base + (i64)i * kThreads + threadIdx.x;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        v[i][j] = T(0);
        m[i][j] = false;
        if (g[i] >= 0) {
          v[i][j] = __ldcs((const T*)in.v[j] + r);
          m[i][j] = in.m[j] == nullptr || __ldcs(in.m[j] + r);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (g[i] < 0) continue;
      if (g[i] != run.g) {
        run.flush(nseg, sums, vcounts, counts);
        run.clear(g[i]);
      }
      run.c += 1;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        if (!m[i][j]) continue;
        run.s[j] += (A)v[i][j];
        run.vc[j] += 1;
      }
    }
  }
  // the block's open runs: heads past lane 0 flush, lane 0's run goes to
  // warp 0, which reduces the warps' first runs the same way
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool head = warp_reduce_runs(run);
  if (head && lane != 0) run.flush(nseg, sums, vcounts, counts);
  if (lane == 0) warp_runs[warp] = run;
  __syncthreads();
  if (warp != 0) return;
  if (lane < kWarps)
    run = warp_runs[lane];
  else
    run.clear(-1);
  if (warp_reduce_runs(run)) run.flush(nseg, sums, vcounts, counts);
}

template <typename T, int K>
int launch_runs(const SegInputs& in, const void* valid, const void* gid,
                i64 n, int nseg, void* sums, void* vcounts, void* counts,
                int sm_count, cudaStream_t s) {
  constexpr i64 step = (i64)kThreads * RunItems<K>::value;
  static int per_sm = 0;  // resident blocks an SM, asked once a kernel
  if (per_sm == 0) {
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, seg_sum_runs_kernel<T, K>, kThreads, 0);
    if (e != cudaSuccess) return (int)e;
  }
  const i64 steps = (n + step - 1) / step;
  i64 blocks = (i64)sm_count * (per_sm > 0 ? per_sm : 1);
  if (blocks > steps) blocks = steps;
  const i64 chunk = (steps + blocks - 1) / blocks * step;
  blocks = (n + chunk - 1) / chunk;
  seg_sum_runs_kernel<T, K><<<(unsigned)blocks, kThreads, 0, s>>>(
      in, (const uint8_t*)valid, (const int*)gid, n, nseg, chunk,
      (typename Acc<T>::type*)sums, (i64*)vcounts, (i64*)counts);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_runs_k(int k, const SegInputs& in, const void* valid,
                  const void* gid, i64 n, int nseg, void* sums,
                  void* vcounts, void* counts, int sm_count,
                  cudaStream_t s) {
  switch (k) {
#define SRTPU_RUNS_K(K)                                                     \
  case K:                                                                  \
    return launch_runs<T, K>(in, valid, gid, n, nseg, sums, vcounts,       \
                             counts, sm_count, s);
    SRTPU_RUNS_K(0) SRTPU_RUNS_K(1) SRTPU_RUNS_K(2) SRTPU_RUNS_K(3)
    SRTPU_RUNS_K(4) SRTPU_RUNS_K(5) SRTPU_RUNS_K(6) SRTPU_RUNS_K(7)
    SRTPU_RUNS_K(8)
#undef SRTPU_RUNS_K
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch(const SegInputs& in, int k, const void* valid, const void* gid,
           i64 n, int nseg, void* sums, void* vcounts, void* counts,
           int privatize, int sm_count, cudaStream_t s) {
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
  if (!privatize)
    return launch_runs_k<T>(k, in, valid, gid, n, nseg, sums, vcounts,
                            counts, sm_count, s);
  i64 blocks = (n + kThreads - 1) / kThreads;
  if (blocks > (i64)sm_count * 4) blocks = (i64)sm_count * 4;
  // bins past what a block may opt into fail here (cudaErrorInvalidValue)
  const size_t smem =
      (size_t)nseg * (k * (sizeof(T) + sizeof(i64)) + sizeof(i64));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        seg_sum_shared_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  seg_sum_shared_kernel<T><<<(int)blocks, kThreads, smem, s>>>(
      in, k, (const uint8_t*)valid, (const int*)gid, n, nseg, (T*)sums,
      (i64*)vcounts, (i64*)counts);
  return (int)cudaGetLastError();
}

}  // namespace srtpu

using namespace srtpu;

// is_float: 0 -> values and sums int64, 1 -> float64. values, masks: host
// arrays of k device pointers (a null mask admits every valid row);
// valid: [n] bool; gid: [n] int32; sums: [k, nseg] (null when k == 0);
// vcounts: [k, nseg] int64 or null; counts: [nseg] int64 or null;
// privatize: the route (ops/segmented.py seg_sum_route), 1 for the
// shared-memory bins, which must fit a block, 0 for the runs.
extern "C" int srtpu_seg_sum_count(int is_float, int k,
                                   const void* const* values,
                                   const void* const* masks,
                                   const void* valid, const void* gid,
                                   long long n, int nseg, void* sums,
                                   void* vcounts, void* counts, int privatize,
                                   int sm_count, void* stream) {
  if (k < 0 || k > kMaxK) return (int)cudaErrorInvalidValue;
  SegInputs in = {};
  for (int j = 0; j < k; ++j) {
    in.v[j] = values[j];
    in.m[j] = (const uint8_t*)masks[j];
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (is_float)
    return launch<double>(in, k, valid, gid, n, nseg, sums, vcounts, counts,
                          privatize, sm_count, s);
  return launch<i64>(in, k, valid, gid, n, nseg, sums, vcounts, counts,
                     privatize, sm_count, s);
}
