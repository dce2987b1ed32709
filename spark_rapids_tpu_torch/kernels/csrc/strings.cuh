// Shared pieces of the per-row string kernels K18-K21: the row layout,
// a sequential reader and writer of one row's bytes, and the launch
// geometry.
//
// Strings are the reference's byte matrix: row r of a column of width
// `mb` is mb bytes at data + r * mb, its byte count lengths[r], and bytes
// at positions >= the length are zero. Every kernel here gives one thread
// one row and walks the row's bytes in order, carrying a state (a DFA
// state, the next free position of a greedy match, an output offset), so
// the reader and the writer move 8-byte words: a row is read and written
// once, a word at a time, where the width is a multiple of 8 (every width
// the engine makes is a power of two of at least 8; other widths take
// byte loads and stores).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace srtpu {

typedef unsigned long long u64;

constexpr int kStrThreads = 128;  // threads (rows) a block

// a row's byte count as the reference's masks (pos < length) read it
__device__ __forceinline__ int row_len(const int* lengths, i64 r, int mb) {
  const int len = lengths[r];
  return len < 0 ? 0 : (len > mb ? mb : len);
}

__device__ __forceinline__ bool is_cont(uint32_t b) {
  return (b & 0xC0u) == 0x80u;
}

// Reads the bytes of one row; consecutive positions reuse the loaded word.
struct RowReader {
  const uint8_t* row;
  int width;
  bool words;
  int cur;
  u64 w;

  __device__ __forceinline__ RowReader(const uint8_t* base, i64 r, int mb)
      : row(base + r * (i64)mb), width(mb), words((mb & 7) == 0),
        cur(-1), w(0) {}

  __device__ __forceinline__ uint32_t operator[](int i) {
    if (!words) return __ldg(row + i);
    const int wi = i >> 3;
    if (wi != cur) {
      cur = wi;
      w = __ldg(reinterpret_cast<const u64*>(row) + wi);
    }
    return (uint32_t)(w >> ((i & 7) * 8)) & 0xFFu;
  }
};

// Writes one output row left to right and zeroes its tail at finish();
// bytes past the width are dropped.
struct RowWriter {
  uint8_t* row;
  int width;
  bool words;
  int pos;
  u64 w;

  __device__ __forceinline__ RowWriter(uint8_t* base, i64 r, int mb)
      : row(base + r * (i64)mb), width(mb), words((mb & 7) == 0), pos(0),
        w(0) {}

  __device__ __forceinline__ void put(uint32_t b) {
    if (pos >= width) return;
    if (!words) {
      row[pos++] = (uint8_t)b;
      return;
    }
    w |= (u64)(b & 0xFFu) << ((pos & 7) * 8);
    ++pos;
    if ((pos & 7) == 0) {
      reinterpret_cast<u64*>(row)[(pos >> 3) - 1] = w;
      w = 0;
    }
  }

  // the byte count written (at most the width)
  __device__ __forceinline__ int finish() {
    const int n = pos;
    if (!words) {
      for (int i = pos; i < width; ++i) row[i] = 0;
      return n;
    }
    int wi = pos >> 3;
    if (pos & 7) reinterpret_cast<u64*>(row)[wi++] = w;
    for (; wi < (width >> 3); ++wi) reinterpret_cast<u64*>(row)[wi] = 0;
    return n;
  }
};

// Grid-stride geometry of the per-row string kernels: at most 16 blocks
// an SM.
inline unsigned str_blocks(i64 n, int sm_count) {
  long long blocks = (n + kStrThreads - 1) / kStrThreads;
  if (blocks > 16LL * sm_count) blocks = 16LL * sm_count;
  return (unsigned)(blocks > 0 ? blocks : 1);
}

}  // namespace srtpu
