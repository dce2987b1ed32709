// K29 codes_remap: dictionary codes re-encoded into another dictionary.
//
// Replaces spark_rapids_tpu/columnar/encoding.py:524, the gather inside
// CodesOf.eval (:515-531): codes' = table[clip(code, 0, K - 1)] as int32,
// where table (remap_table, :308) maps a code of the column's dictionary
// to the code of the same value in the target dictionary, or -1 when the
// value is absent there. Validity is carried by the caller unchanged.
//
// Design: one thread a row over a grid-stride loop. A table of at most
// kSmemEntries entries (48 KB) is staged in shared memory by each block
// first, so the random reads stay on chip; a larger one (dictionaries hold
// at most 2^16 values) is read from global memory through the read-only
// cache.
//
// Bound on the H100: bytes. It reads 2 or 4 B of code and writes 4 B a
// row; the table is read once a block.

#include "common.cuh"

namespace srtpu {

constexpr int kRemapThreads = 256;
constexpr int kSmemEntries = 12288;

template <typename C, bool kSmem>
__global__ void __launch_bounds__(kRemapThreads)
remap_kernel(const C* __restrict__ codes, i64 n,
             const int* __restrict__ table, int k, int* __restrict__ out) {
  extern __shared__ int stab[];
  if (kSmem) {
    for (int j = threadIdx.x; j < k; j += blockDim.x) stab[j] = table[j];
    __syncthreads();
  }
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    int c = (int)codes[i];
    c = c < 0 ? 0 : (c >= k ? k - 1 : c);
    out[i] = kSmem ? stab[c] : __ldg(&table[c]);
  }
}

template <typename C>
static int remap_launch(const void* codes, i64 n, const void* table, int k,
                        void* out, int sms, cudaStream_t s) {
  i64 blocks = (n + kRemapThreads - 1) / kRemapThreads;
  const i64 cap = (i64)sms * 4;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  if (k <= kSmemEntries)
    remap_kernel<C, true><<<(int)blocks, kRemapThreads,
                            (size_t)k * sizeof(int), s>>>(
        (const C*)codes, n, (const int*)table, k, (int*)out);
  else
    remap_kernel<C, false><<<(int)blocks, kRemapThreads, 0, s>>>(
        (const C*)codes, n, (const int*)table, k, (int*)out);
  return (int)cudaGetLastError();
}

}  // namespace srtpu

using namespace srtpu;

// codes: [n] int16 (code_bytes 2) or int32 (4); table: [k] int32; out: [n]
// int32.
extern "C" int srtpu_codes_remap(const void* codes, int code_bytes,
                                 long long n, const void* table, int k,
                                 void* out, int sms, void* stream) {
  if (n < 0 || k < 1 || (code_bytes != 2 && code_bytes != 4))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  return code_bytes == 2
             ? remap_launch<short>(codes, n, table, k, out, sms, s)
             : remap_launch<int>(codes, n, table, k, out, sms, s);
}
