// K33 frame_collect: collect_list / collect_set over bounded ROWS window
// frames, written back to input order.
//
// Replaces spark_rapids_tpu/ops/windowops.py:355 frame_collect (a
// [cap, W] take of the frame's elements, a [cap, W] duplicate test per
// column for a set, then a stable argsort of the drop flags and two
// take_along_axis to left-pack), with the write-back of
// exec/operators.py:2750-2757 (`to_original`, takes through the inverse
// permutation). For each sorted row j of a partition, the frame is
// [start, end] = [max(seg_start, j + lower), min(seg_end, j + upper)];
// its W = upper - lower + 1 slots k read sorted row start + k when that
// is <= end. A slot is kept when the row is live and its value valid; a
// set also drops a value equal to one kept before it (NaN equals NaN,
// -0.0 equals 0.0, as Spark's collect_set; the reference compares with
// ==, so NaN never equals NaN there: ROADMAP section C). Kept values are
// left-packed in frame order into out[perm[j], :], their validity set and
// the rest of the row zeroed, and lengths[perm[j]] counts them.
//
// Bound on the H100: bytes. Each output row reads W values, validities
// and live flags through the permutation (the frames overlap, so most
// come from L1/L2) and writes W values, W flags and a length: about
// W * (8 + 1) + 4 bytes a row written, the values read once each.
//
// Design: one thread a sorted row over a grid-stride loop, W static per
// launch (<= 1,024, the planner's bound). The thread walks its frame in
// order and appends each kept value to its output row, testing a set's
// candidates against the values already appended (O(W^2) compares,
// W = 3 and 6 on the path). No shared memory, no atomics.

#include <math.h>

#include "window_frame.cuh"

namespace srtpu {

// element kinds (ElemKind of collect_scatter.cu; kernels.ELEM_KINDS)
enum FcKind { kFcI8 = 0, kFcI16 = 1, kFcI32 = 2, kFcI64 = 3, kFcF32 = 4,
              kFcF64 = 5 };

template <typename T>
__device__ __forceinline__ bool fc_eq(T a, T b) {
  return a == b;
}
template <>
__device__ __forceinline__ bool fc_eq<float>(float a, float b) {
  return a == b || (isnan(a) && isnan(b));
}
template <>
__device__ __forceinline__ bool fc_eq<double>(double a, double b) {
  return a == b || (isnan(a) && isnan(b));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
frame_collect_kernel(const T* __restrict__ vals,
                     const uint8_t* __restrict__ valid,
                     const uint8_t* __restrict__ live,
                     const int* __restrict__ perm,
                     const int* __restrict__ seg_start,
                     const int* __restrict__ seg_end, i64 n, i64 lower,
                     i64 upper, int width, int distinct,
                     T* __restrict__ out, uint8_t* __restrict__ out_ev,
                     int* __restrict__ out_len) {
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 j = (i64)blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += stride) {
    const i64 ss = seg_start[j], se = seg_end[j];
    const i64 start = j + lower > ss ? j + lower : ss;
    const i64 end = j + upper < se ? j + upper : se;
    const i64 dst = perm[j];
    T* row = out + dst * width;
    uint8_t* rev = out_ev + dst * width;
    int m = 0;
    for (int k = 0; k < width; ++k) {
      const i64 idx = start + k;
      if (idx > end || idx < 0 || idx >= n || !live[idx]) continue;
      const i64 src = perm[idx];
      if (!valid[src]) continue;
      const T v = vals[src];
      bool dup = false;
      if (distinct)
        for (int q = 0; q < m && !dup; ++q) dup = fc_eq<T>(row[q], v);
      if (dup) continue;
      row[m] = v;
      rev[m] = 1;
      ++m;
    }
    out_len[dst] = m;
    for (int q = m; q < width; ++q) {
      row[q] = T(0);
      rev[q] = 0;
    }
  }
}

template <typename T>
static int fc_launch(const void* vals, const void* valid, const void* live,
                     const void* perm, const void* seg_start,
                     const void* seg_end, i64 n, i64 lower, i64 upper,
                     int width, int distinct, void* out, void* out_ev,
                     void* out_len, int sm_count, cudaStream_t s) {
  frame_collect_kernel<T><<<row_blocks(n, sm_count), kThreads, 0, s>>>(
      (const T*)vals, (const uint8_t*)valid, (const uint8_t*)live,
      (const int*)perm, (const int*)seg_start, (const int*)seg_end, n,
      lower, upper, width, distinct, (T*)out, (uint8_t*)out_ev,
      (int*)out_len);
  return (int)cudaGetLastError();
}

}  // namespace srtpu

using namespace srtpu;

// vals, valid: [n] in input order (kind: FcKind); live, seg_start,
// seg_end: [n] in sorted order; perm: [n] int32, sorted row -> input
// row (a permutation of 0..n-1); out: [n, width] of the value type and
// out_ev [n, width] bool and out_len [n] int32, in input order.
extern "C" int srtpu_frame_collect(const void* vals, int kind,
                                   const void* valid, const void* live,
                                   const void* perm, const void* seg_start,
                                   const void* seg_end, long long n,
                                   long long lower, long long upper,
                                   int width, int distinct, void* out,
                                   void* out_ev, void* out_len, int sm_count,
                                   void* stream) {
  if (n < 0 || width < 1 || width > 1024 || upper - lower + 1 != width)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  switch (kind) {
    case kFcI8:
      return fc_launch<int8_t>(vals, valid, live, perm, seg_start, seg_end,
                               n, lower, upper, width, distinct, out, out_ev,
                               out_len, sm_count, s);
    case kFcI16:
      return fc_launch<short>(vals, valid, live, perm, seg_start, seg_end, n,
                              lower, upper, width, distinct, out, out_ev,
                              out_len, sm_count, s);
    case kFcI32:
      return fc_launch<int>(vals, valid, live, perm, seg_start, seg_end, n,
                            lower, upper, width, distinct, out, out_ev,
                            out_len, sm_count, s);
    case kFcI64:
      return fc_launch<long long>(vals, valid, live, perm, seg_start,
                                  seg_end, n, lower, upper, width, distinct,
                                  out, out_ev, out_len, sm_count, s);
    case kFcF32:
      return fc_launch<float>(vals, valid, live, perm, seg_start, seg_end, n,
                              lower, upper, width, distinct, out, out_ev,
                              out_len, sm_count, s);
    case kFcF64:
      return fc_launch<double>(vals, valid, live, perm, seg_start, seg_end,
                               n, lower, upper, width, distinct, out, out_ev,
                               out_len, sm_count, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
