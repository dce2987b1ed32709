// Spark's Murmur3_x86_32, shared by K5 (bloom) and K6 (murmur3 partition
// ids): org.apache.spark.unsafe.hash.Murmur3_x86_32 hashInt, hashLong and
// hashUnsafeBytes (with Spark's one-byte-at-a-time tail), chained over key
// columns as Spark's Murmur3Hash does (a null column leaves the running
// hash unchanged).
//
// Replaces the jnp/lax arithmetic of spark_rapids_tpu/ops/hashing.py:63-163.
// All arithmetic is uint32_t (wrapping, defined) and the result is
// reinterpreted as int32 by the caller; the reference's int32 multiplies
// wrap the same way and lax.shift_right_logical is the unsigned shift.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace srtpu {

// How a key column is hashed; the wrapper converts the column's data to
// the width its logical type hashes at (hash_column's dispatch).
enum HashKind : int {
  kHashI32 = 0,   // int32 data: hashInt (int, short, byte, date, bool)
  kHashI64 = 1,   // int64 data: hashLong (long, timestamp)
  kHashF32 = 2,   // float32 data: -0.0 -> 0.0, NaN -> 0x7FC00000, hashInt
  kHashF64 = 3,   // float64 data: -0.0 -> 0.0, NaN canonical, hashLong
  kHashStr = 4,   // [n, row_bytes] zero-padded uint8 + int32 lengths
};

struct HashCol {
  const void* data;
  const uint8_t* validity;  // [n] bool; null = every row valid
  const int* lengths;       // strings only
  int kind;                 // HashKind
  int row_bytes;            // strings: the padded width
};

constexpr int kMaxHashCols = 8;

// passed to kernels by value (kernel parameter space)
struct HashCols {
  HashCol c[kMaxHashCols];
  int n;
};

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ uint32_t mix_k1(uint32_t k1) {
  k1 *= 0xCC9E2D51u;
  k1 = rotl32(k1, 15);
  return k1 * 0x1B873593u;
}

__device__ __forceinline__ uint32_t mix_h1(uint32_t h1, uint32_t k1) {
  h1 ^= k1;
  h1 = rotl32(h1, 13);
  return h1 * 5u + 0xE6546B64u;
}

__device__ __forceinline__ uint32_t fmix32(uint32_t h1, uint32_t length) {
  h1 ^= length;
  h1 ^= h1 >> 16;
  h1 *= 0x85EBCA6Bu;
  h1 ^= h1 >> 13;
  h1 *= 0xC2B2AE35u;
  return h1 ^ (h1 >> 16);
}

__device__ __forceinline__ uint32_t hash_int(uint32_t v, uint32_t seed) {
  return fmix32(mix_h1(seed, mix_k1(v)), 4u);
}

// low word, then high word
__device__ __forceinline__ uint32_t hash_long(uint64_t v, uint32_t seed) {
  uint32_t h1 = mix_h1(seed, mix_k1((uint32_t)v));
  h1 = mix_h1(h1, mix_k1((uint32_t)(v >> 32)));
  return fmix32(h1, 8u);
}

// hashUnsafeBytes over one zero-padded row: full little-endian 4-byte
// chunks up to length / 4, then each tail byte as a sign-extended int8
__device__ __forceinline__ uint32_t hash_bytes(const uint8_t* row, int length,
                                               uint32_t seed) {
  uint32_t h1 = seed;
  const int full = length >> 2;
  for (int c = 0; c < full; ++c) {
    const uint8_t* b = row + 4 * c;
    const uint32_t chunk = (uint32_t)b[0] | ((uint32_t)b[1] << 8) |
                           ((uint32_t)b[2] << 16) | ((uint32_t)b[3] << 24);
    h1 = mix_h1(h1, mix_k1(chunk));
  }
  for (int t = full * 4; t < length; ++t)
    h1 = mix_h1(h1, mix_k1((uint32_t)(int32_t)(int8_t)row[t]));
  return fmix32(h1, (uint32_t)length);
}

// one column's update of the running hash h for row i (validity ignored)
__device__ __forceinline__ uint32_t hash_col(const HashCol& c, long long i,
                                             uint32_t h) {
  switch (c.kind) {
    case kHashI32:
      return hash_int((uint32_t)((const int32_t*)c.data)[i], h);
    case kHashI64:
      return hash_long((uint64_t)((const long long*)c.data)[i], h);
    case kHashF32: {
      const float f = ((const float*)c.data)[i];
      uint32_t bits = __float_as_uint(f);
      if ((bits << 1) == 0) bits = 0;  // -0.0 -> 0.0
      if (f != f) bits = 0x7FC00000u;  // one NaN
      return hash_int(bits, h);
    }
    case kHashF64: {
      const double d = ((const double*)c.data)[i];
      uint64_t bits = (uint64_t)__double_as_longlong(d);
      if ((bits << 1) == 0) bits = 0;
      if (d != d) bits = 0x7FF8000000000000ull;
      return hash_long(bits, h);
    }
    default:
      return hash_bytes((const uint8_t*)c.data + i * (long long)c.row_bytes,
                        c.lengths[i], h);
  }
}

// Spark Murmur3Hash(cols, seed): chain the seed through the columns left to
// right, skipping a column where the row is null
__device__ __forceinline__ uint32_t hash_row(const HashCols& cols, long long i,
                                             uint32_t seed) {
  uint32_t h = seed;
  for (int j = 0; j < cols.n; ++j) {
    const HashCol& c = cols.c[j];
    if (c.validity == nullptr || c.validity[i]) h = hash_col(c, i, h);
  }
  return h;
}

// Spark's Pmod: C's % truncates, so a negative remainder moves up by n
__device__ __forceinline__ int pmod32(int32_t x, int n) {
  const int r = x % n;
  return r < 0 ? r + n : r;
}

}  // namespace srtpu
