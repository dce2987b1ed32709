// The lexicographic binary search over sorted int64 key words that K2
// (probe_ranges.cu) and K13 (merge_runs.cu) share: the device form of
// spark_rapids_tpu/ops/joinops.py:86 _binary_search.
//
// Keys are word-major: word w of row r of a [W, rows] table sits at
// keys[w * rows + r], so one word of neighbouring rows is contiguous (the
// layout K9's pack writes).
#pragma once

#include "common.cuh"

namespace srtpu {

// sign of (row `mid` of keys [W, bcap]) - (row p of probe [W, n]),
// lexicographic over W words in signed order
__device__ __forceinline__ int key_cmp(const i64* __restrict__ keys,
                                       i64 bcap, i64 mid,
                                       const i64* __restrict__ probe,
                                       i64 n, i64 p, int W) {
  for (int w = 0; w < W; ++w) {
    const i64 b = keys[(i64)w * bcap + mid];
    const i64 q = probe[(i64)w * n + p];
    if (b < q) return -1;
    if (b > q) return 1;
  }
  return 0;
}

// first row in [lo, hi) of keys whose key is >= probe row p (lower bound),
// or > it with `upper`; hi when there is none. Rows [lo, hi) must be
// sorted.
__device__ __forceinline__ int key_search(const i64* __restrict__ keys,
                                          i64 bcap, int lo, int hi,
                                          const i64* __restrict__ probe,
                                          i64 n, i64 p, int W, bool upper) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const int c = key_cmp(keys, bcap, mid, probe, n, p, W);
    if (c < 0 || (upper && c == 0)) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

}  // namespace srtpu
