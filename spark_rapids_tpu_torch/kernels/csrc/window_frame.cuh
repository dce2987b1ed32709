// Shared pieces of the window kernels K14-K17: where a row's frame starts
// and ends, and the per-row segment bounds they read.
//
// Rows are in the window's sorted order. A frame side is one of
//   kSeg    the partition's first (last) row,
//   kPeer   the ORDER BY peer run's first (last) row,
//   kOffset j + lower (j + upper), clipped to the partition (ROWS),
//   kGiven  an int32 array of positions (K15's RANGE bounds),
// as spark_rapids_tpu/ops/windowops.py's rows_frame_bounds,
// default_frame_bounds and range_frame_bounds give them: inclusive
// [start, end], empty where end < start.
#pragma once

#include "common.cuh"

namespace srtpu {

enum WinBound { kSeg = 0, kPeer = 1, kOffset = 2, kGiven = 3 };

// one frame as the window kernels take it (Frame in ops/windowops.py)
struct WinFrame {
  int start_kind;   // WinBound
  int end_kind;
  long long lower;  // kOffset offsets
  long long upper;
  const int* start;  // kGiven positions, [n] int32
  const int* end;
};

struct SegBounds {
  const int* seg_start;
  const int* seg_end;
  const int* peer_start;
  const int* peer_end;
};

__device__ __forceinline__ i64 clip(i64 v, i64 lo, i64 hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ void frame_bounds(int start_kind, int end_kind,
                                             long long lower,
                                             long long upper,
                                             const int* given_start,
                                             const int* given_end,
                                             const SegBounds& b, i64 j,
                                             i64& start, i64& end) {
  switch (start_kind) {
    case kSeg: start = b.seg_start[j]; break;
    case kPeer: start = b.peer_start[j]; break;
    case kOffset: {
      const i64 ss = b.seg_start[j];
      start = j + lower > ss ? j + lower : ss;
      break;
    }
    default: start = given_start[j];
  }
  switch (end_kind) {
    case kSeg: end = b.seg_end[j]; break;
    case kPeer: end = b.peer_end[j]; break;
    case kOffset: {
      const i64 se = b.seg_end[j];
      end = j + upper < se ? j + upper : se;
      break;
    }
    default: end = given_end[j];
  }
}

__device__ __forceinline__ void frame_bounds(const WinFrame& f,
                                             const SegBounds& b, i64 j,
                                             i64& start, i64& end) {
  frame_bounds(f.start_kind, f.end_kind, f.lower, f.upper, f.start, f.end,
               b, j, start, end);
}

// Grid-stride launch geometry of the per-row window kernels: at most 16
// blocks an SM.
inline unsigned row_blocks(i64 n, int sm_count) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 16LL * sm_count) blocks = 16LL * sm_count;
  return (unsigned)(blocks > 0 ? blocks : 1);
}

}  // namespace srtpu
