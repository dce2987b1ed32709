// K6 murmur3 partition ids: Spark's Murmur3Hash chained over key columns,
// then Pmod by the partition count.
//
// Replaces spark_rapids_tpu/ops/hashing.py:63 hash_int, :68 hash_long,
// :78 hash_string, :109 hash_column, :153 murmur3_columns, :163 pmod and
// spark_rapids_tpu/ops/partition.py:29 hash_partition_ids (vectorised
// int32 XLA arithmetic, one pass per column and per string chunk).
// out[i] = pmod(chain(cols, seed_i), nparts) where seed_i is seed_vec[i]
// when a seed vector is given (hash_int/hash_long/hash_string/hash_column
// take a per-row seed) and `seed` otherwise; nparts == 0 skips the Pmod,
// and no columns at all makes it Pmod of seed_vec alone (`pmod`).
//
// Bound on the H100: bytes. It reads each key column once (q5's exchange:
// 1,024 rows of a decoded 16-byte region string, 4-byte length and a
// validity byte) and writes 4 B per row: about 25 KB, far under one
// microsecond at 3.35 TB/s, so at this size a launch (a few us) is the
// floor. A 9-byte string costs 2 chunk and 1 tail mix rounds plus fmix,
// some 40 integer operations per row.
//
// Design: one thread per row, grid-stride; the column descriptors travel
// in kernel parameter space; every key column of the row is hashed in
// registers, so the partition id is the only write.

#include "common.cuh"
#include "murmur3.cuh"

namespace srtpu {

__global__ void __launch_bounds__(kThreads)
murmur3_kernel(HashCols cols, long long n, uint32_t seed,
               const int32_t* __restrict__ seed_vec, int nparts,
               int32_t* __restrict__ out) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const uint32_t s = seed_vec != nullptr ? (uint32_t)seed_vec[i] : seed;
    const int32_t h = (int32_t)hash_row(cols, i, s);
    out[i] = nparts > 0 ? pmod32(h, nparts) : h;
  }
}

}  // namespace srtpu

using namespace srtpu;

// cols: host array of ncols HashCol; seed_vec: [n] int32 or null;
// out: [n] int32.
extern "C" int srtpu_murmur3(const HashCol* cols, int ncols, long long n,
                             int seed, const void* seed_vec, int nparts,
                             void* out, int sm_count, void* stream) {
  if (ncols < 0 || ncols > kMaxHashCols || nparts < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  HashCols hc = {};
  for (int j = 0; j < ncols; ++j) hc.c[j] = cols[j];
  hc.n = ncols;
  const long long want = (n + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 8LL * sm_count ? want : 8LL * sm_count);
  murmur3_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      hc, n, (uint32_t)seed, (const int32_t*)seed_vec, nparts,
      (int32_t*)out);
  return (int)cudaGetLastError();
}
