// K5 bloom: build the join's runtime bloom filter from the build keys, and
// test every probe row against it.
//
// Replaces spark_rapids_tpu/ops/bloom.py:29 _positions, :45 build and
// :55 might_contain (with ops/hashing.py:68 hash_long): k = 4 double-hashed
// bit positions per key, h1 = Murmur3Hash(keys, 0x9747b28c) and
// h2 = Murmur3Hash(keys, 0x85ebca6b) | 1, both sign-extended to int64;
// position i is pmod(int32(h1 + i * h2), m). The bit array is the
// reference's bool[m] (one byte per bit), so both packages' filters compare
// array for array.
//   build: a live row whose key columns are all non-null sets its k bytes;
//   might_contain: keep[i] = every key column non-null and all k bits set;
//   with a count pointer it tests only the rows below num_rows, writes
//   keep = 0 for the dead rows past them (the join ANDs keep with its
//   live mask anyway) and counts the kept rows (the join's host check of
//   how many live rows survive).
//
// Bound on the H100: bytes. might_contain reads 8 B of key and 1 B of
// validity per live probe row and writes 1 B per row of the capacity:
// q5's part (4,050,610 live rows at capacity 8,388,608) needs about 45 MB,
// 13 us at 3.35 TB/s. The work per live row is two hashLong chains (some
// 50 integer operations) and four bit tests.
//
// Design: build is one thread per build row; the byte writes race only
// with writes of the same value. might_contain runs 2 blocks per SM of
// 1,024 threads over the rows (grid-stride); each block first packs the
// bool[m] bytes into m/32 words of shared memory (q5: 4 KB, dupjoin:
// 8 KB), so the k tests per row are shared-memory reads. Larger filters
// (over 48 KB packed) read the bytes from device memory through L1/L2.
// The kept count is a block sum plus one atomic per block.

#include "common.cuh"
#include "murmur3.cuh"

namespace srtpu {

constexpr uint32_t kSeedA = 0x9747b28cu;
constexpr uint32_t kSeedB = 0x85ebca6bu;
constexpr int kProbeThreads = 1024;
constexpr int kMaxSmemBloomBits = 48 * 1024 * 8;

__device__ __forceinline__ bool keys_valid(const HashCols& cols, long long i) {
  for (int j = 0; j < cols.n; ++j)
    if (cols.c[j].validity != nullptr && !cols.c[j].validity[i]) return false;
  return true;
}

// the t-th position: int64 arithmetic, truncated to int32, then Pmod by m
__device__ __forceinline__ int bloom_pos(long long h1, long long h2, int t,
                                         int m) {
  return pmod32((int32_t)(uint32_t)(unsigned long long)(h1 + t * h2), m);
}

__global__ void __launch_bounds__(kThreads)
bloom_build_kernel(HashCols cols, long long n,
                   const uint8_t* __restrict__ live, int m, int k,
                   uint8_t* __restrict__ bits) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    if (!live[i] || !keys_valid(cols, i)) continue;
    const long long h1 = (int32_t)hash_row(cols, i, kSeedA);
    const long long h2 = (long long)(int32_t)hash_row(cols, i, kSeedB) | 1;
    for (int t = 0; t < k; ++t) bits[bloom_pos(h1, h2, t, m)] = 1;
  }
}

// bit j of the result = byte j of x is nonzero (x holds 4 bool bytes)
__device__ __forceinline__ uint32_t pack4(uint32_t x) {
  const uint32_t y = __vcmpne4(x, 0u) & 0x01010101u;
  return (y & 1u) | ((y >> 7) & 2u) | ((y >> 14) & 4u) | ((y >> 21) & 8u);
}

template <bool kSmem>
__global__ void __launch_bounds__(kProbeThreads)
bloom_probe_kernel(HashCols cols, long long n,
                   const uint8_t* __restrict__ bits, int m, int k,
                   uint8_t* __restrict__ keep,
                   const int* __restrict__ nrows_dev, long long nrows_host,
                   unsigned long long* __restrict__ count) {
  extern __shared__ uint32_t words[];
  if (kSmem) {
    for (int w = threadIdx.x; w < (m >> 5); w += blockDim.x) {
      const uint4* src = reinterpret_cast<const uint4*>(bits) + 2 * w;
      const uint4 a = src[0], b = src[1];
      words[w] = pack4(a.x) | pack4(a.y) << 4 | pack4(a.z) << 8 |
                 pack4(a.w) << 12 | pack4(b.x) << 16 | pack4(b.y) << 20 |
                 pack4(b.z) << 24 | pack4(b.w) << 28;
    }
    __syncthreads();
  }
  // without a count every row is tested
  const long long live_rows = count == nullptr ? n
                              : nrows_dev != nullptr ? *nrows_dev
                                                     : nrows_host;
  unsigned long long kept = 0;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    bool ok = i < live_rows && keys_valid(cols, i);
    if (ok) {
      const long long h1 = (int32_t)hash_row(cols, i, kSeedA);
      const long long h2 = (long long)(int32_t)hash_row(cols, i, kSeedB) | 1;
      for (int t = 0; t < k && ok; ++t) {
        const int p = bloom_pos(h1, h2, t, m);
        ok = kSmem ? ((words[p >> 5] >> (p & 31)) & 1u) != 0 : bits[p] != 0;
      }
    }
    keep[i] = ok;
    kept += ok ? 1 : 0;
  }
  if (count == nullptr) return;
  __shared__ unsigned long long warp_kept[kProbeThreads / 32];
  kept = warp_sum(kept);
  if ((threadIdx.x & 31) == 0) warp_kept[threadIdx.x >> 5] = kept;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long t = 0;
    for (int w = 0; w < kProbeThreads / 32; ++w) t += warp_kept[w];
    atomicAdd(count, t);
  }
}

}  // namespace srtpu

using namespace srtpu;

static int fill_cols(const HashCol* cols, int ncols, HashCols* hc) {
  if (ncols < 1 || ncols > kMaxHashCols) return 1;
  *hc = HashCols{};
  for (int j = 0; j < ncols; ++j) hc->c[j] = cols[j];
  hc->n = ncols;
  return 0;
}

// cols: host array of ncols HashCol over n build rows; live: [n] bool;
// bits: [m] bool, zeroed by the caller.
extern "C" int srtpu_bloom_build(const HashCol* cols, int ncols, long long n,
                                 const void* live, int m, int k, void* bits,
                                 void* stream) {
  HashCols hc;
  if (fill_cols(cols, ncols, &hc) || m <= 0 || k < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const int blocks = (int)((n + kThreads - 1) / kThreads);
  bloom_build_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      hc, n, (const uint8_t*)live, m, k, (uint8_t*)bits);
  return (int)cudaGetLastError();
}

// bits: [m] bool, m a multiple of 32; keep: [n] bool out; count: one int64
// zeroed by the caller, or null to test every row; with a count the live
// rows are *nrows_dev when given, else nrows_host.
extern "C" int srtpu_bloom_probe(const HashCol* cols, int ncols, long long n,
                                 const void* bits, int m, int k, void* keep,
                                 const void* nrows_dev, long long nrows_host,
                                 void* count, int sm_count, void* stream) {
  HashCols hc;
  if (fill_cols(cols, ncols, &hc) || m <= 0 || (m & 31) || k < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const long long want = (n + kProbeThreads - 1) / kProbeThreads;
  const int blocks = (int)(want < 2LL * sm_count ? want : 2LL * sm_count);
  if (m <= kMaxSmemBloomBits) {
    bloom_probe_kernel<true><<<blocks, kProbeThreads, (m / 32) * 4, s>>>(
        hc, n, (const uint8_t*)bits, m, k, (uint8_t*)keep,
        (const int*)nrows_dev, nrows_host, (unsigned long long*)count);
  } else {
    bloom_probe_kernel<false><<<blocks, kProbeThreads, 0, s>>>(
        hc, n, (const uint8_t*)bits, m, k, (uint8_t*)keep,
        (const int*)nrows_dev, nrows_host, (unsigned long long*)count);
  }
  return (int)cudaGetLastError();
}
