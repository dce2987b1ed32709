// The lexicographic binary search over sorted int64 key words that K13
// (merge_runs.cu) uses: the device form of
// spark_rapids_tpu/ops/joinops.py:86 _binary_search; and the galloping
// search from a guess that K2 (probe_ranges.cu) and K15 (range_bounds.cu)
// use.
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

// first p in [lo, hi) with less(p) false, hi when there is none, for a
// predicate that is true and then false over [lo, hi): steps of 1, 2, 4,
// ... rows from the guess g toward the answer, then a binary search inside
// the last step. An answer d rows from g costs about 2 log2(d + 1) probes,
// and threads with neighbouring guesses probe neighbouring rows.
template <typename Less>
__device__ __forceinline__ int gallop(int lo, int hi, int g, Less less) {
  if (lo >= hi) return lo;
  g = g < lo ? lo : (g >= hi ? hi - 1 : g);
  int a, b;  // the answer lies in (a, b]
  if (less(g)) {
    a = g;
    b = hi;
    for (unsigned step = 1; step < (unsigned)(hi - g); step <<= 1) {
      const int p = g + (int)step;
      if (!less(p)) {
        b = p;
        break;
      }
      a = p;
    }
  } else {
    a = lo - 1;
    b = g;
    for (unsigned step = 1; step <= (unsigned)(g - lo); step <<= 1) {
      const int p = g - (int)step;
      if (less(p)) {
        a = p;
        break;
      }
      b = p;
    }
  }
  while (b - a > 1) {
    const int m = a + ((b - a) >> 1);
    if (less(m))
      a = m;
    else
      b = m;
  }
  return b;
}

}  // namespace srtpu
