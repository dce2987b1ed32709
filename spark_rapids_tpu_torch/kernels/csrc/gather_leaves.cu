// K8 gather_leaves: one row gather of many column leaves in one launch.
//
// Replaces spark_rapids_tpu/columnar/batch.py:216 DeviceColumn.gather and
// :345 ColumnBatch.gather (one jnp.take per leaf: data, validity, lengths)
// and columnar/encoding.py:377 decode_column (a jnp.take of dictionary rows
// by code). Each leaf is a row-major array of src_rows rows of row_bytes
// bytes (a 1-D column, a validity mask or a [cap, max_bytes] string
// matrix); out row i of a leaf is src row idx[i]. A leaf may carry a mask:
// out rows where mask[i] is false are zero (decode's zero-padding rule).
// Indices must lie in [0, src_rows): one outside traps (a bug, as
// torch.index_select's device assert reports it), except for a leaf
// marked `clamp`, whose indices are dictionary codes that decode clips to
// the dictionary as the reference does.
//
// Bound on the H100: bytes. Each leaf row is read once and written once,
// plus 4 B of index per row and index vector: a q5 join output of
// 4,194,304 rows over 7 columns (14 leaves, 54 B of leaves per row) moves
// about 490 MB, 0.15 ms at 3.35 TB/s.
//
// Design: the leaf table rides in kernel parameter space (up to 32 leaves,
// so a whole batch, or both sides of a join, is one launch); blockIdx.y
// picks the leaf. A gather is a chain of dependent loads (index, then
// row), so each thread keeps several rows in flight: kRows rows a
// thread, their index loads first, then their row loads, then the
// stores. A row moves in the widest unit (1, 2, 4, 8 or 16 bytes) that
// divides it and both base addresses. One-byte rows (validity masks, int8
// codes) go four consecutive rows a thread, with one 4-byte store, so a
// warp writes 128 contiguous bytes instead of 32.

#include <cstdio>

#include "common.cuh"

namespace srtpu {

struct GatherLeaf {
  const void* src;
  void* dst;
  const void* idx;        // int32 (idx_bytes 4) or int16 (2)
  const uint8_t* mask;    // [n_out] bool or null
  long long src_rows;
  int row_bytes;
  int unit;               // bytes per load/store; divides row_bytes
  int idx_bytes;
  int clamp;              // 1: clip indices to [0, src_rows) (decode)
};

constexpr int kMaxLeaves = 32;
constexpr int kRows = 4;  // rows in flight per thread

struct GatherLeaves {
  GatherLeaf l[kMaxLeaves];
};

__device__ __noinline__ void bad_index(long long j, long long i,
                                       long long rows) {
  printf("gather_leaves: index %lld at row %lld outside [0, %lld)\n", j, i,
         rows);
  __trap();
}

template <typename I>
__device__ __forceinline__ long long load_index(const I* __restrict__ idx,
                                                long long i, long long rows,
                                                bool clamp) {
  long long j = (long long)idx[i];
  if (clamp) {
    j = j < 0 ? 0 : (j >= rows ? rows - 1 : j);
  } else if (j < 0 || j >= rows) {
    bad_index(j, i, rows);
  }
  return j;
}

// rows of `words` units of T, kRows rows a thread, strided by the grid
template <typename T, typename I>
__device__ __forceinline__ void gather_rows(const GatherLeaf& L,
                                            long long n_out) {
  const T* __restrict__ src = (const T*)L.src;
  T* __restrict__ dst = (T*)L.dst;
  const I* __restrict__ idx = (const I*)L.idx;
  const uint8_t* __restrict__ mask = L.mask;
  const int words = L.row_bytes / (int)sizeof(T);
  const long long rows = L.src_rows;
  const bool clamp = L.clamp != 0;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long base = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       base < n_out; base += step * kRows) {
    long long j[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const long long i = base + r * step;
      j[r] = i < n_out ? load_index(idx, i, rows, clamp) : 0;
    }
    for (int w = 0; w < words; ++w) {
      T v[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (base + r * step < n_out) v[r] = src[j[r] * words + w];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const long long i = base + r * step;
        if (i < n_out)
          dst[i * words + w] = (mask != nullptr && !mask[i]) ? T{} : v[r];
      }
    }
  }
}

// one-byte rows: four consecutive rows a thread, one 4-byte store (dst is
// 4-byte aligned; the caller checks)
template <typename I>
__device__ __forceinline__ void gather_bytes(const GatherLeaf& L,
                                             long long n_out) {
  const uint8_t* __restrict__ src = (const uint8_t*)L.src;
  uint8_t* __restrict__ dst = (uint8_t*)L.dst;
  const I* __restrict__ idx = (const I*)L.idx;
  const uint8_t* __restrict__ mask = L.mask;
  const long long rows = L.src_rows;
  const bool clamp = L.clamp != 0;
  const long long quads = (n_out + 3) / 4;
  for (long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       q < quads; q += (long long)gridDim.x * blockDim.x) {
    const long long i0 = q * 4;
    uint32_t packed = 0;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const long long i = i0 + r;
      if (i < n_out) {
        const long long j = load_index(idx, i, rows, clamp);
        const uint32_t b = (mask != nullptr && !mask[i]) ? 0u : src[j];
        packed |= b << (8 * r);
      }
    }
    if (i0 + 3 < n_out) {
      *reinterpret_cast<uint32_t*>(dst + i0) = packed;
    } else {
      for (int r = 0; i0 + r < n_out; ++r) dst[i0 + r] = packed >> (8 * r);
    }
  }
}

template <typename I>
__device__ __forceinline__ void gather_leaf(const GatherLeaf& L,
                                            long long n_out) {
  switch (L.unit) {
    case 16: gather_rows<uint4, I>(L, n_out); break;
    case 8: gather_rows<unsigned long long, I>(L, n_out); break;
    case 4: gather_rows<uint32_t, I>(L, n_out); break;
    case 2: gather_rows<uint16_t, I>(L, n_out); break;
    default:
      if (L.row_bytes == 1 && ((uintptr_t)L.dst & 3) == 0)
        gather_bytes<I>(L, n_out);
      else
        gather_rows<uint8_t, I>(L, n_out);
  }
}

// at most 64 registers a thread: four resident blocks an SM
__global__ void __launch_bounds__(kThreads, 4)
gather_leaves_kernel(GatherLeaves leaves, long long n_out) {
  const GatherLeaf L = leaves.l[blockIdx.y];
  if (L.idx_bytes == 2)
    gather_leaf<int16_t>(L, n_out);
  else
    gather_leaf<int32_t>(L, n_out);
}

}  // namespace srtpu

using namespace srtpu;

// leaves: host array of nleaves GatherLeaf (at most 32), each gathering
// n_out rows.
extern "C" int srtpu_gather_leaves(const GatherLeaf* leaves, int nleaves,
                                   long long n_out, int sm_count,
                                   void* stream) {
  if (nleaves < 1 || nleaves > kMaxLeaves) return (int)cudaErrorInvalidValue;
  GatherLeaves t = {};
  for (int k = 0; k < nleaves; ++k) {
    const GatherLeaf& L = leaves[k];
    if (L.row_bytes <= 0 || L.unit <= 0 || L.row_bytes % L.unit ||
        (L.idx_bytes != 2 && L.idx_bytes != 4) || L.src_rows <= 0)
      return (int)cudaErrorInvalidValue;
    t.l[k] = L;
  }
  if (n_out == 0) return (int)cudaSuccess;
  // kRows rows a thread: about 8 resident blocks an SM for every leaf
  const long long want = (n_out + kThreads * kRows - 1) / (kThreads * kRows);
  const long long cap = 8LL * sm_count;
  const dim3 grid((unsigned)(want < cap ? want : cap), (unsigned)nleaves);
  gather_leaves_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(t, n_out);
  return (int)cudaGetLastError();
}
