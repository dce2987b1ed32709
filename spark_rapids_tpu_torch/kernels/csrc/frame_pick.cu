// K17 frame_pick: the source row of first_value / last_value frames and of
// lead / lag.
//
// Replaces spark_rapids_tpu/ops/windowops.py:318 frame_first_last and :435
// lead_lag (index arithmetic, a binary search over a validity prefix and a
// take, which XLA compiles). For each sorted row j and each requested
// output, the sorted position p it reads and whether it has one:
//   first / last           p = start / end, has = end >= start
//                          (p = 0 where the frame is empty)
//   first / last, ignoring nulls
//                          p = the first (last) row of the frame that is
//                          valid and live, found by a binary search of
//                          K14's count prefix inside the frame; has = the
//                          frame holds one (p = clip(start) where not)
//   lead / lag (offset o)  p = clip(j + o, 0, n - 1), has = j + o lies in
//                          the row's partition
// and writes src = perm[p] (the input row; p without perm) and has at the
// row's input position through inv (K14's inverse permutation). K8 then
// gathers every leaf of the input column, strings included, by src: the
// value is the gathered one, its validity the gathered validity and has.
// The reference searches the whole batch's validity prefix for the
// ignore-nulls pick; the first (last) valid row at or after start (at or
// before end) is the same row when it lies inside the frame, which is
// when has holds, and otherwise the value is not valid in either. Lag is
// lead with the offset negated.
//
// Bound on the H100: bytes. It reads inv and the frame's bounds (and the
// prefix at a few positions for an ignore-nulls pick) and writes src and
// has, about 4 + 4 + 8 + 4 + 1 bytes a row an output; 37.7M rows take
// about 0.24 ms at 3.35 TB/s for one output.
//
// Design: one thread an output row, up to eight outputs a launch (their
// descriptors in parameter space), as K14's evaluation.

#include "window_frame.cuh"

namespace srtpu {

enum PickKind { kPickFirst = 0, kPickLast = 1, kPickFirstValid = 2,
                kPickLastValid = 3, kPickShift = 4 };

struct PickOut {
  int kind;               // PickKind
  int pad;
  WinFrame frame;         // first / last frames
  long long offset;       // lead / lag: the signed offset
  const long long* pcnt;  // [n + 1] count prefix of valid live rows
  int* src;               // [n] int32 out: the input row to read
  uint8_t* has;           // [n] bool out
};

constexpr int kMaxPickOuts = 8;

struct PickOuts {
  PickOut o[kMaxPickOuts];
};

// first q in [lo, hi] with pcnt[q + 1] >= target (hi when none before it)
__device__ __forceinline__ i64 prefix_search(const long long* __restrict__ p,
                                             i64 lo, i64 hi,
                                             long long target) {
  while (lo < hi) {
    const i64 mid = (lo + hi) >> 1;
    if (p[mid + 1] < target)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
frame_pick_kernel(PickOuts outs, int nouts, i64 n, SegBounds b,
                  const int* __restrict__ perm,
                  const int* __restrict__ inv) {
  for (i64 dst = (i64)blockIdx.x * blockDim.x + threadIdx.x; dst < n;
       dst += (i64)gridDim.x * blockDim.x) {
    const i64 j = inv != nullptr ? (i64)inv[dst] : dst;
    for (int k = 0; k < nouts; ++k) {
      const PickOut& o = outs.o[k];
      i64 p;
      bool has;
      if (o.kind == kPickShift) {
        const i64 t = j + o.offset;
        has = t >= b.seg_start[j] && t <= b.seg_end[j];
        p = clip(t, 0, n - 1);
      } else {
        i64 start, end;
        frame_bounds(o.frame, b, j, start, end);
        has = end >= start;
        if (o.kind == kPickFirst || o.kind == kPickLast) {
          p = has ? (o.kind == kPickLast ? end : start) : 0;
        } else {
          const i64 lo = clip(start, 0, n), hi = clip(end + 1, 0, n);
          const long long before = o.pcnt[lo], upto = o.pcnt[hi];
          has = has && upto > before;
          p = has ? prefix_search(o.pcnt, lo, hi - 1,
                                  o.kind == kPickLastValid ? upto
                                                           : before + 1)
                  : lo;
        }
        p = clip(p, 0, n - 1);
      }
      o.src[dst] = perm != nullptr ? perm[p] : (int)p;
      o.has[dst] = has;
    }
  }
}

}  // namespace srtpu

using namespace srtpu;

// outs: host array of nouts PickOut (at most 8); the bounds: [n] int32,
// sorted order; perm: [n] int32 or null (src are sorted positions); inv:
// [n] int32 (K14's inverse) or null (outputs in sorted order).
extern "C" int srtpu_frame_pick(const PickOut* outs, int nouts, long long n,
                                const void* seg_start, const void* seg_end,
                                const void* peer_start, const void* peer_end,
                                const void* perm, const void* inv,
                                int sm_count, void* stream) {
  if (nouts < 1 || nouts > kMaxPickOuts || n < 1)
    return (int)cudaErrorInvalidValue;
  PickOuts t = {};
  for (int k = 0; k < nouts; ++k) {
    t.o[k] = outs[k];
    if ((outs[k].kind == kPickFirstValid || outs[k].kind == kPickLastValid)
        && outs[k].pcnt == nullptr)
      return (int)cudaErrorInvalidValue;
  }
  const SegBounds b = {(const int*)seg_start, (const int*)seg_end,
                       (const int*)peer_start, (const int*)peer_end};
  frame_pick_kernel<<<row_blocks(n, sm_count), kThreads, 0,
                      (cudaStream_t)stream>>>(t, nouts, n, b,
                                              (const int*)perm,
                                              (const int*)inv);
  return (int)cudaGetLastError();
}
