// K32 seg_sum128: the segmented sum of 128-bit decimal values, exact mod
// 2^128, with the count of the rows each sum took.
//
// Replaces spark_rapids_tpu/ops/decimal128.py:213 seg_sum128: the
// reference splits every value into four 32-bit limbs, sums each with a
// segment_sum (XLA's scatter-add) and carry-normalises the four sums;
// Sum's update and merge (spark_rapids_tpu/expr/aggregates.py:96-126) add
// the count with one more segment_sum. For every row r with valid[r] and
// 0 <= g = gid[r] < nseg:
//   sums[g] += value[r] (mod 2^128),  counts[g] += 1.
// A value is a [n, 2] int64 limb row (hi, lo), or with `narrow` an int64
// sign-extended (a decimal(<= 18) input of a decimal(> 18) sum).
//
// Bound on the H100: bytes. It must read valid (1 B) for every row, and
// gid (4 B) and the value (16 B, or 8 B narrow) for the valid rows, and
// write 24 bytes a segment: q1's sum of 59,986,052 wide products is about
// 1.26 GB, 0.38 ms at 3.35 TB/s.
//
// Design: each thread owns kSumItems consecutive rows of a tile and adds
// runs of equal ids in registers as an unsigned __int128; a run that ends
// inside the thread's rows is flushed at once. The last run of every
// thread is reduced across the warp by shuffles when the whole warp ends
// in one id (the usual case over sorted ids, and over a handful of bins),
// and the warps' totals of one id across the block by one thread, so a
// tile of 2,048 rows in one group costs one flush. A flush splits the
// partial sum into four 32-bit limbs and adds them with 64-bit atomics
// into uint64 accumulators [nseg, 4] (exact below 2^32 flushes a
// segment), with the count beside them: into shared-memory bins flushed
// once a block when the segments fit (the binned aggregate's ids), else
// straight into device memory (a sort's ids, one per row of capacity). A
// second launch carries each segment's limbs into (hi, lo) as the
// reference's normalisation does.

#include "decimal128.cuh"

namespace srtpu {

constexpr int kSumItems = 8;                    // rows a thread a tile
constexpr int kSumTile = kThreads * kSumItems;  // 2,048 rows a block
constexpr int kSumWords = 5;                    // 4 limbs + the count

__device__ __forceinline__ void flush(unsigned long long* acc, int g, u128 s,
                                      unsigned long long c) {
  unsigned long long* p = acc + (i64)g * kSumWords;
  const unsigned long long lo = (unsigned long long)s,
                           hi = (unsigned long long)(s >> 64);
  atomicAdd(p + 0, lo & 0xFFFFFFFFull);
  atomicAdd(p + 1, lo >> 32);
  atomicAdd(p + 2, hi & 0xFFFFFFFFull);
  atomicAdd(p + 3, hi >> 32);
  atomicAdd(p + 4, c);
}

__device__ __forceinline__ u128 shfl_down_128(u128 v, int off) {
  const unsigned long long lo = __shfl_down_sync(
      kFull, (unsigned long long)v, off);
  const unsigned long long hi = __shfl_down_sync(
      kFull, (unsigned long long)(v >> 64), off);
  return ((u128)hi << 64) | (u128)lo;
}

__global__ void __launch_bounds__(kThreads)
seg_sum128_kernel(const i64* __restrict__ data, int narrow,
                  const uint8_t* __restrict__ valid,
                  const int* __restrict__ gid, i64 n, int nseg,
                  unsigned long long* __restrict__ acc, int use_shared) {
  extern __shared__ __align__(16) unsigned long long sacc[];
  __shared__ int warp_g[kWarps];
  __shared__ u128 warp_s[kWarps];
  __shared__ unsigned long long warp_c[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned long long* bins = use_shared ? sacc : acc;
  if (use_shared) {
    for (int i = threadIdx.x; i < nseg * kSumWords; i += kThreads)
      sacc[i] = 0;
    __syncthreads();
  }
  for (i64 base = (i64)blockIdx.x * kSumTile; base < n;
       base += (i64)gridDim.x * kSumTile) {
    const i64 first = base + (i64)threadIdx.x * kSumItems;
    int g = -1;
    u128 s = 0;
    unsigned long long c = 0;
    for (int k = 0; k < kSumItems; ++k) {
      const i64 r = first + k;
      if (r >= n || !valid[r]) continue;
      const int gr = gid[r];
      if (gr < 0 || gr >= nseg) continue;
      if (gr != g) {
        if (g >= 0) flush(bins, g, s, c);
        g = gr;
        s = 0;
        c = 0;
      }
      s += load_dec(data, !narrow, r);
      ++c;
    }
    // the warp's last runs: one flush when every lane ends in one id
    const int g0 = __shfl_sync(kFull, g, 0);
    const bool uniform = __all_sync(kFull, g == g0) && g0 >= 0;
    if (uniform) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        s += shfl_down_128(s, off);
        c += __shfl_down_sync(kFull, c, off);
      }
    } else if (g >= 0) {
      flush(bins, g, s, c);
    }
    if (lane == 0) {
      warp_g[warp] = uniform ? g0 : -1;
      warp_s[warp] = s;
      warp_c[warp] = c;
    }
    __syncthreads();
    if (threadIdx.x == 0) {  // runs of warps that end in one id
      int gb = -1;
      u128 sb = 0;
      unsigned long long cb = 0;
      for (int w = 0; w < kWarps; ++w) {
        const int gw = warp_g[w];
        if (gw < 0) continue;
        if (gw != gb) {
          if (gb >= 0) flush(bins, gb, sb, cb);
          gb = gw;
          sb = 0;
          cb = 0;
        }
        sb += warp_s[w];
        cb += warp_c[w];
      }
      if (gb >= 0) flush(bins, gb, sb, cb);
    }
    __syncthreads();
  }
  if (use_shared) {
    for (int i = threadIdx.x; i < nseg; i += kThreads) {
      const unsigned long long* p = sacc + (i64)i * kSumWords;
      if (p[4] == 0) continue;  // no row reached this bin
#pragma unroll
      for (int w = 0; w < kSumWords; ++w) atomicAdd(acc + (i64)i * kSumWords + w, p[w]);
    }
  }
}

// the reference's carry normalisation of the four limb sums
__global__ void __launch_bounds__(kThreads)
seg_sum128_finish(const unsigned long long* __restrict__ acc, int nseg,
                  i64* __restrict__ out, i64* __restrict__ counts) {
  for (i64 g = (i64)blockIdx.x * kThreads + threadIdx.x; g < nseg;
       g += (i64)gridDim.x * kThreads) {
    const unsigned long long* p = acc + g * kSumWords;
    unsigned long long limb[4], carry = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const unsigned long long tot = p[k] + carry;
      limb[k] = tot & 0xFFFFFFFFull;
      carry = tot >> 32;
    }
    out[2 * g] = (i64)(limb[2] | (limb[3] << 32));
    out[2 * g + 1] = (i64)(limb[0] | (limb[1] << 32));
    if (counts != nullptr) counts[g] = (i64)p[4];
  }
}

inline int sum_grid(i64 rows, int per_block, int sm_count, int per_sm) {
  const i64 blocks = (rows + per_block - 1) / per_block;
  const i64 cap = (i64)per_sm * sm_count;
  return (int)(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

}  // namespace srtpu

using namespace srtpu;

// data: [n, 2] int64 limbs, or [n] int64 with narrow; valid: [n] bool;
// gid: [n] int32; out: [nseg, 2] int64; counts: [nseg] int64 or null;
// scratch: nseg * 5 uint64 (zeroed here).
extern "C" int srtpu_seg_sum128(const void* data, int narrow,
                                const void* valid, const void* gid,
                                long long n, int nseg, void* out,
                                void* counts, void* scratch, int sm_count,
                                int smem_optin, void* stream) {
  if (n < 0 || nseg < 1 || data == nullptr || valid == nullptr ||
      gid == nullptr || out == nullptr || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, (size_t)nseg * kSumWords * sizeof(unsigned long long), st);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    const size_t smem = (size_t)nseg * kSumWords * sizeof(unsigned long long);
    // the static arrays take about 0.3 KB of the block's shared memory
    const int use_shared = smem + 1024 <= (size_t)smem_optin;
    if (use_shared && smem > 48 * 1024) {
      err = cudaFuncSetAttribute(seg_sum128_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    seg_sum128_kernel<<<sum_grid(n, kSumTile, sm_count, use_shared ? 2 : 8),
                        kThreads, use_shared ? smem : 0, st>>>(
        (const i64*)data, narrow, (const uint8_t*)valid, (const int*)gid, n,
        nseg, (unsigned long long*)scratch, use_shared);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  seg_sum128_finish<<<sum_grid(nseg, kThreads, sm_count, 8), kThreads, 0,
                      st>>>((const unsigned long long*)scratch, nseg,
                            (i64*)out, (i64*)counts);
  return (int)cudaGetLastError();
}
