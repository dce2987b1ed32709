// K18 dfa_match: Spark RLIKE (find anywhere) over a string column, by a
// walk of the pattern's DFA.
//
// Replaces spark_rapids_tpu/ops/regexops.py:18 dfa_match (a lax.scan over
// the byte positions: one table gather a step for all rows, which XLA
// compiles). Each row starts in `start`, moves through
// table[state * C + classes[byte]] for each of its bytes, and matches when
// the state it ends in accepts. The transpiler (regex/transpiler.py)
// makes an unanchored-end pattern's accept states absorbing (every class
// loops back), so a row may stop at one: accept[s] is 2 there, 1 at the
// other accept states and 0 elsewhere, and the answer is unchanged.
//
// Bound on the H100: bytes. It must read each row's bytes (up to its
// length), the length and write one byte: for 36M rows of `region`
// (9 bytes) about 0.5 GB, 0.15 ms at 3.35 TB/s. The table walk is one
// dependent shared-memory read per byte, so a thread's chain of reads,
// not the memory, sets the pace at short rows; many rows in flight per SM
// hide it.
//
// Design: one thread a row, 8 bytes a load (RowReader). The byte-class
// map and the [S, C] table go to shared memory as int16 when they fit the
// block's opt-in limit (`smem_limit`, the caller's
// kernels.smem_optin), with the accept flags; otherwise the walk reads
// the table and the flags from device memory in the same kernel.

#include "strings.cuh"

namespace srtpu {

template <bool kShared>
__global__ void __launch_bounds__(kStrThreads)
dfa_match_kernel(const uint8_t* __restrict__ data,
                 const int* __restrict__ lengths, i64 n, int mb,
                 const int16_t* __restrict__ classes,
                 const int16_t* __restrict__ table, int S, int C,
                 const uint8_t* __restrict__ accept, int start,
                 uint8_t* __restrict__ out) {
  extern __shared__ int16_t smem[];
  int16_t* cls = smem;
  const int16_t* tbl = table;
  const uint8_t* acc = accept;
  for (int i = threadIdx.x; i < 256; i += blockDim.x) cls[i] = classes[i];
  if (kShared) {
    int16_t* t = smem + 256;
    const int cells = S * C;
    for (int i = threadIdx.x; i < cells; i += blockDim.x) t[i] = table[i];
    uint8_t* a = reinterpret_cast<uint8_t*>(t + cells);
    for (int i = threadIdx.x; i < S; i += blockDim.x) a[i] = accept[i];
    tbl = t;
    acc = a;
  }
  __syncthreads();
  for (i64 r = (i64)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += (i64)gridDim.x * blockDim.x) {
    const int len = row_len(lengths, r, mb);
    RowReader row(data, r, mb);
    int s = start;
    for (int i = 0; i < len; ++i) {
      if (acc[s] == 2) break;
      s = tbl[s * C + cls[row[i]]];
    }
    out[r] = acc[s] != 0;
  }
}

}  // namespace srtpu

using namespace srtpu;

// data: [n, mb] uint8; lengths: [n] int32; classes: [256] int16; table:
// [S, C] int16; accept: [S] uint8 (0, 1, or 2 for an absorbing accept);
// out: [n] bool. smem_limit: the dynamic shared memory a block may opt
// into.
extern "C" int srtpu_dfa_match(const void* data, const void* lengths,
                               long long n, int mb, const void* classes,
                               const void* table, int S, int C,
                               const void* accept, int start, void* out,
                               int smem_limit, int sm_count, void* stream) {
  if (n < 1 || mb < 1 || S < 1 || C < 1 || start < 0 || start >= S)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long shared = 512LL + 2LL * S * C + S;
  const unsigned blocks = str_blocks(n, sm_count);
  if (shared <= smem_limit) {
    if (shared > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          dfa_match_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)shared);
      if (e != cudaSuccess) return (int)e;
    }
    dfa_match_kernel<true><<<blocks, kStrThreads, (size_t)shared, st>>>(
        (const uint8_t*)data, (const int*)lengths, n, mb,
        (const int16_t*)classes, (const int16_t*)table, S, C,
        (const uint8_t*)accept, start, (uint8_t*)out);
  } else {
    dfa_match_kernel<false><<<blocks, kStrThreads, 512, st>>>(
        (const uint8_t*)data, (const int*)lengths, n, mb,
        (const int16_t*)classes, (const int16_t*)table, S, C,
        (const uint8_t*)accept, start, (uint8_t*)out);
  }
  return (int)cudaGetLastError();
}
