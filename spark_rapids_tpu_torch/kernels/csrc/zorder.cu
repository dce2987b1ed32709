// K36 zorder_interleave: the Morton (Z-order) key of n rank columns.
//
// Replaces spark_rapids_tpu/ops/zorder.py:34 interleave_bits: for each row
//   z = OR over b < use, c < n of (((rank_c >> shift) >> b) & 1) << (b*n + c)
// in int64, where use = min(rank_bits, max(1, 63 / n)) and shift =
// max(0, rank_bits - use) keep the top `use` bits of each rank. A bit
// position of 64 or more (n >= 65 columns) gives nothing, as XLA's shift
// out of range does (a C++ shift by 64 is undefined, so it is guarded);
// position 63 (column 63 of n >= 64) lands on the sign bit.
//
// Design: one thread a row over a grid-stride loop. The rank columns are
// int32 vectors anywhere in device memory; their addresses pass by value
// in the launch's parameters (no copy to the device, no host sync), at
// most kMaxZCols of them: a column c >= 64 lands at b*n + c >= 64 for
// every b and places no bit, so a launch takes any n. For n <= 4 (the
// common OPTIMIZE ZORDER BY widths) the (b, c) loop is a template over n
// with the column loop unrolled.
//
// Bound on the H100: bytes. A row reads 4 B a column and writes 8 B; the
// bit loop is at most 63 shift-and-or steps.

#include "common.cuh"

namespace srtpu {

constexpr int kZThreads = 256;
constexpr int kMaxZCols = 64;  // columns that can place a bit

struct ZCols {
  const int* col[kMaxZCols];
};

__device__ __forceinline__ unsigned long long deposit(i64 v, int use,
                                                      int stride, int c) {
  unsigned long long z = 0;
  for (int b = 0; b < use; ++b) {
    const int pos = b * stride + c;
    if (pos >= 64) break;  // later b only move further out
    z |= (unsigned long long)((v >> b) & 1) << pos;
  }
  return z;
}

template <int N>
__global__ void __launch_bounds__(kZThreads)
zorder_fixed_kernel(const ZCols cols, i64 n_rows, int use, int shift,
                    i64* __restrict__ out) {
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x; i < n_rows;
       i += stride) {
    unsigned long long z = 0;
#pragma unroll
    for (int c = 0; c < N; ++c)
      z |= deposit((i64)__ldg(&cols.col[c][i]) >> shift, use, N, c);
    out[i] = (i64)z;
  }
}

__global__ void __launch_bounds__(kZThreads)
zorder_any_kernel(const ZCols cols, int n_cols, i64 n_rows, int use,
                  int shift, i64* __restrict__ out) {
  const i64 stride = (i64)gridDim.x * blockDim.x;
  const int live_cols = n_cols < kMaxZCols ? n_cols : kMaxZCols;
  for (i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x; i < n_rows;
       i += stride) {
    unsigned long long z = 0;
    for (int c = 0; c < live_cols; ++c)
      z |= deposit((i64)__ldg(&cols.col[c][i]) >> shift, use, n_cols, c);
    out[i] = (i64)z;
  }
}

}  // namespace srtpu

using namespace srtpu;

// ranks: a host array of n_cols pointers to [n_rows] int32 on the device;
// out: [n_rows] int64. use in [1, 63], shift in [0, 63).
extern "C" int srtpu_zorder_interleave(const void* ranks, int n_cols,
                                       long long n_rows, int use, int shift,
                                       void* out, int sms, void* stream) {
  if (n_cols < 1 || n_rows < 0 || use < 1 || use > 63 || shift < 0 ||
      shift > 62)
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  i64 blocks = (n_rows + kZThreads - 1) / kZThreads;
  const i64 cap = (i64)sms * 8;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  ZCols r;
  const int* const* given = (const int* const*)ranks;
  for (int c = 0; c < kMaxZCols; ++c)
    r.col[c] = c < n_cols ? given[c] : nullptr;
  i64* o = (i64*)out;
  switch (n_cols) {
    case 1:
      zorder_fixed_kernel<1><<<(int)blocks, kZThreads, 0, s>>>(r, n_rows, use,
                                                              shift, o);
      break;
    case 2:
      zorder_fixed_kernel<2><<<(int)blocks, kZThreads, 0, s>>>(r, n_rows, use,
                                                              shift, o);
      break;
    case 3:
      zorder_fixed_kernel<3><<<(int)blocks, kZThreads, 0, s>>>(r, n_rows, use,
                                                              shift, o);
      break;
    case 4:
      zorder_fixed_kernel<4><<<(int)blocks, kZThreads, 0, s>>>(r, n_rows, use,
                                                              shift, o);
      break;
    default:
      zorder_any_kernel<<<(int)blocks, kZThreads, 0, s>>>(r, n_cols, n_rows,
                                                          use, shift, o);
  }
  return (int)cudaGetLastError();
}
