// K30 xxhash64: Spark's XxHash64 (seed 42) chained over up to kMaxHashCols
// key columns, one int64 a row.
//
// Replaces spark_rapids_tpu/ops/hashing.py:198 xxh64_int, :207 xxh64_long,
// :216 xxh64_bytes, :277 xxh64_column and :308 xxhash64_columns (uint64
// jnp arithmetic; the byte hash pads every row to 32 bytes and masks each
// possible stripe, word and tail byte, a pass over the whole matrix
// each). Spark's org.apache.spark.sql.catalyst.expressions.XXH64:
// hashInt for the 32-bit kinds, hashLong for the 64-bit ones, floats and
// doubles by their bits after -0.0 -> 0.0 and every NaN -> the canonical
// NaN, strings by hashUnsafeBytes (32-byte stripes in four lanes, then
// 8-byte words, one 4-byte word, the last bytes one at a time, unsigned).
// The seed chains column by column from `seed` (or seed_vec[i], the
// output of an earlier launch over more than kMaxHashCols columns); a
// null leaves the running hash as it is. All arithmetic is uint64_t,
// which wraps as Java's long does.
//
// Bound on the H100: bytes. Each key column is read once and 8 B a row
// written: orders_hash_sample's MinHash key (o_custkey int64, the
// priority's 16-byte rows and o_comment's 128-byte rows, lengths 4 B
// each, validity 1 B each) over 15M rows is about 2.5 GB, 0.75 ms at
// 3.35 TB/s. A 79-byte comment costs two stripes, three words and a few
// bytes: some 80 multiplies a row, well under the integer rate.
//
// Design: one thread a row, grid-stride; each thread walks its own row's
// length only (not the padded width), reading 8-byte words where the row
// is 8-byte aligned. The descriptors (the HashCol layout K5 and K6 use)
// travel in kernel parameter space. A warp-cooperative layout for long
// rows is later work.

#include "common.cuh"
#include "murmur3.cuh"

namespace srtpu {

constexpr uint64_t kXP1 = 0x9E3779B185EBCA87ULL;
constexpr uint64_t kXP2 = 0xC2B2AE3D27D4EB4FULL;
constexpr uint64_t kXP3 = 0x165667B19E3779F9ULL;
constexpr uint64_t kXP4 = 0x85EBCA77C2B2AE63ULL;
constexpr uint64_t kXP5 = 0x27D4EB2F165667C5ULL;

__device__ __forceinline__ uint64_t rotl64(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}

__device__ __forceinline__ uint64_t xxh_fmix(uint64_t h) {
  h ^= h >> 33;
  h *= kXP2;
  h ^= h >> 29;
  h *= kXP3;
  return h ^ (h >> 32);
}

__device__ __forceinline__ uint64_t xxh_int(uint32_t v, uint64_t seed) {
  uint64_t h = seed + kXP5 + 4ULL;
  h ^= (uint64_t)v * kXP1;
  h = rotl64(h, 23) * kXP2 + kXP3;
  return xxh_fmix(h);
}

__device__ __forceinline__ uint64_t xxh_round(uint64_t acc, uint64_t w) {
  return rotl64(acc + w * kXP2, 31) * kXP1;
}

__device__ __forceinline__ uint64_t xxh_long(uint64_t v, uint64_t seed) {
  uint64_t h = seed + kXP5 + 8ULL;
  h ^= rotl64(v * kXP2, 31) * kXP1;
  h = rotl64(h, 27) * kXP1 + kXP4;
  return xxh_fmix(h);
}

// little-endian loads at any alignment
__device__ __forceinline__ uint64_t load64(const uint8_t* p, bool aligned) {
  if (aligned) return *reinterpret_cast<const uint64_t*>(p);
  uint64_t w = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) w |= (uint64_t)p[k] << (8 * k);
  return w;
}

__device__ __forceinline__ uint32_t load32(const uint8_t* p, bool aligned) {
  if (aligned) return *reinterpret_cast<const uint32_t*>(p);
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}

// XXH64.hashUnsafeBytes over the first `len` bytes of one row
__device__ __forceinline__ uint64_t xxh_bytes(const uint8_t* row, int len,
                                              uint64_t seed) {
  const bool aligned = ((uintptr_t)row & 7) == 0;
  int off = 0;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = seed + kXP1 + kXP2, v2 = seed + kXP2, v3 = seed,
             v4 = seed - kXP1;
    for (; off <= len - 32; off += 32) {
      v1 = xxh_round(v1, load64(row + off, aligned));
      v2 = xxh_round(v2, load64(row + off + 8, aligned));
      v3 = xxh_round(v3, load64(row + off + 16, aligned));
      v4 = xxh_round(v4, load64(row + off + 24, aligned));
    }
    h = rotl64(v1, 1) + rotl64(v2, 7) + rotl64(v3, 12) + rotl64(v4, 18);
    h = (h ^ xxh_round(0, v1)) * kXP1 + kXP4;
    h = (h ^ xxh_round(0, v2)) * kXP1 + kXP4;
    h = (h ^ xxh_round(0, v3)) * kXP1 + kXP4;
    h = (h ^ xxh_round(0, v4)) * kXP1 + kXP4;
  } else {
    h = seed + kXP5;
  }
  h += (uint64_t)len;
  for (; off + 8 <= len; off += 8)
    h = rotl64(h ^ xxh_round(0, load64(row + off, aligned)), 27) * kXP1 +
        kXP4;
  if (off + 4 <= len) {
    h = rotl64(h ^ ((uint64_t)load32(row + off, aligned) * kXP1), 23) *
            kXP2 + kXP3;
    off += 4;
  }
  for (; off < len; ++off)
    h = rotl64(h ^ ((uint64_t)row[off] * kXP5), 11) * kXP1;
  return xxh_fmix(h);
}

// one column's update of the running hash h for row i (validity ignored)
__device__ __forceinline__ uint64_t xxh_col(const HashCol& c, i64 i,
                                            uint64_t h) {
  switch (c.kind) {
    case kHashI32:
      return xxh_int((uint32_t)((const int32_t*)c.data)[i], h);
    case kHashI64:
      return xxh_long((uint64_t)((const long long*)c.data)[i], h);
    case kHashF32: {
      const float f = ((const float*)c.data)[i];
      uint32_t bits = __float_as_uint(f);
      if ((bits << 1) == 0) bits = 0;  // -0.0 -> 0.0
      if (f != f) bits = 0x7FC00000u;  // one NaN
      return xxh_int(bits, h);
    }
    case kHashF64: {
      const double d = ((const double*)c.data)[i];
      uint64_t bits = (uint64_t)__double_as_longlong(d);
      if ((bits << 1) == 0) bits = 0;
      if (d != d) bits = 0x7FF8000000000000ull;
      return xxh_long(bits, h);
    }
    default:
      return xxh_bytes((const uint8_t*)c.data + i * (i64)c.row_bytes,
                       c.lengths[i], h);
  }
}

__global__ void __launch_bounds__(kThreads)
xxhash64_kernel(HashCols cols, i64 n, uint64_t seed,
                const long long* __restrict__ seed_vec,
                long long* __restrict__ out) {
  for (i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (i64)gridDim.x * blockDim.x) {
    uint64_t h = seed_vec != nullptr ? (uint64_t)seed_vec[i] : seed;
    for (int j = 0; j < cols.n; ++j) {
      const HashCol& c = cols.c[j];
      if (c.validity == nullptr || c.validity[i]) h = xxh_col(c, i, h);
    }
    out[i] = (long long)h;
  }
}

}  // namespace srtpu

using namespace srtpu;

// cols: host array of ncols HashCol; seed_vec: [n] int64 or null (then
// every row starts from `seed`); out: [n] int64.
extern "C" int srtpu_xxhash64(const HashCol* cols, int ncols, long long n,
                              long long seed, const void* seed_vec,
                              void* out, int sm_count, void* stream) {
  if (ncols < 1 || ncols > kMaxHashCols || n < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  HashCols hc = {};
  for (int j = 0; j < ncols; ++j) hc.c[j] = cols[j];
  hc.n = ncols;
  const long long want = (n + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 8LL * sm_count ? want : 8LL * sm_count);
  xxhash64_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      hc, n, (uint64_t)seed, (const long long*)seed_vec, (long long*)out);
  return (int)cudaGetLastError();
}
