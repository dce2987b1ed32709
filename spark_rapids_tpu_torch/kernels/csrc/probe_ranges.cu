// K2 probe_ranges: per probe row, the range of equal keys in the sorted
// build side.
//
// Replaces spark_rapids_tpu/ops/joinops.py:86 _binary_search and :116
// probe_ranges (two vectorised binary searches that XLA compiles). For
// probe row p with key words q[0..W), over build rows [0, valid_bound)
// sorted lexicographically by their W int64 words:
//   lo[p]    = first row whose key is >= q   (lower bound)
//   count[p] = (first row whose key is > q) - lo[p], or 0 when the probe
//              row is dead or has a null key (all_valid[p] == 0).
// lo is written for every row, dead ones included, as the reference does.
// Both predicates are monotone over the sorted build, so any search that
// finds their boundary gives the reference's positions.
//
// Bound on the H100: bytes. It must read the build once, W int64 words
// and one mask byte a probe row, and write two int32 a row: q5's 8,388,608
// probe rows against 2,048 build rows with W=1 need 143 MB, 43 us at
// 3.35 TB/s. The compares are far below the integer rate.
//
// Design: two launches.
// 1. A bucket index on the first key word over the build's range
//    [build[0].w0, build[bound-1].w0]: 2^k buckets of 2^shift values each
//    (the span taken in unsigned 64-bit arithmetic, so keys may reach
//    INT64_MIN and INT64_MAX), start[b] the first build row at or past
//    bucket b's lower edge, start[count] = bound. One thread a build row
//    writes the starts of the buckets from its predecessor's, exclusive,
//    to its own; k is at most log2 of the build capacity and 14.
// 2. The probe: a persistent grid of two blocks an SM (one when a block's
//    shared memory passes 113 KB) of 512 threads, each copying the index
//    and, for builds up to 200 KB, the build's rows [0, bound) into
//    dynamic shared memory (16-byte loads; cudaFuncSetAttribute past 48
//    KB); larger builds stay in device memory, the index still in shared
//    memory. Templated on W = 1..4 (the probe row's words in registers,
//    read once, coalesced) with a generic path above 4, and on where the
//    build lies, so the shared-memory path compiles to plain shared loads.
//    A probe row below the build's range gets [0, 0), above it [bound,
//    bound); otherwise the row's bucket bounds both searches to [start[b],
//    start[b + 1]]. The lower bound gallops from an interpolated guess
//    inside the bucket (exact for dense keys), the upper one from the lower
//    (one compare for a unique key); a unique key found at the guess
//    settles both in one round of three neighbouring loads. Each thread
//    takes two rows a step, so their loads overlap.

#include <stdint.h>

#include "common.cuh"
#include "search.cuh"

namespace srtpu {

typedef unsigned long long u64;

constexpr int kProbeThreads = 512;
constexpr int kIndexLogMax = 14;                   // at most 16,384 buckets
constexpr size_t kSmemBlockMax = 232448;           // 227 KB: one block's
constexpr size_t kSmemTwoBlocks = 113 * 1024;      // two blocks an SM
constexpr size_t kSmemBuildMax = 200 * 1024;       // builds kept in shared

__device__ __forceinline__ int clamp_bound(int bound, int bcap) {
  return bound < 0 ? 0 : (bound > bcap ? bcap : bound);
}

// the index's geometry over word 0 of build rows [0, bound), bound > 0
struct Buckets {
  i64 kmin;
  int shift;
  int count;  // buckets in use; start[count] == bound

  __device__ __forceinline__ void init(i64 lo, i64 hi, int log_nb) {
    kmin = lo;
    const u64 span = (u64)hi - (u64)lo;
    const int bits = span == 0 ? 0 : 64 - __clzll((long long)span);
    shift = bits > log_nb ? bits - log_nb : 0;
    count = (int)(span >> shift) + 1;
  }

  // bucket of x: -1 below the range, count above it; off = x - kmin
  __device__ __forceinline__ int of(i64 x, u64& off) const {
    if (x < kmin) return -1;
    off = (u64)x - (u64)kmin;
    const u64 b = off >> shift;
    return b >= (u64)count ? count : (int)b;
  }
};

__global__ void __launch_bounds__(kThreads)
bucket_index_kernel(const i64* __restrict__ build, int bcap,
                    const int* __restrict__ bound_p, int log_nb,
                    int* __restrict__ start) {
  const int bound = clamp_bound(*bound_p, bcap);
  if (bound == 0) return;
  Buckets bk;
  bk.init(build[0], build[bound - 1], log_nb);
  u64 off;
  for (i64 r = (i64)blockIdx.x * blockDim.x + threadIdx.x; r <= bound;
       r += (i64)gridDim.x * blockDim.x) {
    // buckets (bucket of row r - 1, bucket of row r] start at row r
    const int hi = r < bound ? bk.of(build[r], off) : bk.count;
    const int lo = r > 0 ? bk.of(build[r - 1], off) : -1;
    for (int k = lo + 1; k <= hi; ++k) start[k] = (int)r;
  }
}

// one probe row's key: W = KW words in registers
template <int KW>
struct ProbeKey {
  i64 w[KW];

  __device__ __forceinline__ void load(const i64* __restrict__ probe, i64 n,
                                       i64 p, int) {
#pragma unroll
    for (int i = 0; i < KW; ++i) w[i] = probe[(i64)i * n + p];
  }
  __device__ __forceinline__ i64 first() const { return w[0]; }
  // sign of build row r (word-major, `stride` rows a word) minus this key
  __device__ __forceinline__ int cmp(const i64* keys, int stride,
                                     int r) const {
#pragma unroll
    for (int i = 0; i < KW; ++i) {
      const i64 b = keys[(i64)i * stride + r];
      if (b != w[i]) return b < w[i] ? -1 : 1;
    }
    return 0;
  }
};

// W > 4: word 0 in a register, the others read again at each compare
template <>
struct ProbeKey<0> {
  const i64* probe;
  i64 n, p;
  int W;
  i64 w0;

  __device__ __forceinline__ void load(const i64* probe_, i64 n_, i64 p_,
                                       int W_) {
    probe = probe_;
    n = n_;
    p = p_;
    W = W_;
    w0 = probe_[p_];
  }
  __device__ __forceinline__ i64 first() const { return w0; }
  __device__ __forceinline__ int cmp(const i64* keys, int stride,
                                     int r) const {
    const i64 b0 = keys[r];
    if (b0 != w0) return b0 < w0 ? -1 : 1;
    for (int i = 1; i < W; ++i) {
      const i64 b = keys[(i64)i * stride + r];
      const i64 q = probe[(i64)i * n + p];
      if (b != q) return b < q ? -1 : 1;
    }
    return 0;
  }
};

// [lower, upper) of probe key q among build rows [0, bound)
template <int KW>
__device__ __forceinline__ void key_range(const i64* keys, int stride,
                                          const int* sidx,
                                          const Buckets& bk, int bound,
                                          const ProbeKey<KW>& q, int& lower,
                                          int& upper) {
  u64 off = 0;
  const int b = bound == 0 ? -1 : bk.of(q.first(), off);
  if (b < 0 || b >= bk.count) {
    lower = upper = b < 0 ? 0 : bound;
    return;
  }
  const int s = sidx[b], e = sidx[b + 1];
  int g = s;
  if (e - s > 1 && bk.shift > 0) {
    // the key's place in its bucket, scaled to the bucket's rows
    const u64 frac = off & ((1ull << bk.shift) - 1);
    const int drop = bk.shift > 32 ? bk.shift - 32 : 0;
    g = s + (int)(((frac >> drop) * (u64)(e - s)) >> (bk.shift - drop));
  }
  // a unique key at the guess (dense keys): the guess and its two
  // neighbours in one round of independent loads
  const int gm = g > s ? g - 1 : g, gp = g + 1 < e ? g + 1 : g;
  const int cm = q.cmp(keys, stride, gm), c0 = q.cmp(keys, stride, g),
            cp = q.cmp(keys, stride, gp);
  if (c0 == 0 && (gm == g || cm < 0) && (gp == g || cp > 0)) {
    lower = g;
    upper = g + 1;
    return;
  }
  lower = gallop(s, e, g,
                 [&](int r) { return q.cmp(keys, stride, r) < 0; });
  upper = gallop(lower, e, lower,
                 [&](int r) { return q.cmp(keys, stride, r) <= 0; });
}

template <int KW, bool SMEM>
__global__ void __launch_bounds__(kProbeThreads, 2)
probe_ranges_kernel(const i64* __restrict__ build, int bcap, int W,
                    const int* __restrict__ bound_p, int log_nb,
                    const int* __restrict__ index,
                    const i64* __restrict__ probe, i64 n,
                    const uint8_t* __restrict__ all_valid,
                    int* __restrict__ lo_out, int* __restrict__ cnt_out) {
  // [W, bcap] build words (SMEM only), then the index's starts
  extern __shared__ __align__(16) unsigned char smem[];
  i64* sbuild = reinterpret_cast<i64*>(smem);
  int* sidx = reinterpret_cast<int*>(
      smem + (SMEM ? (size_t)W * bcap * sizeof(i64) : 0));
  const int bound = clamp_bound(*bound_p, bcap);
  Buckets bk = {0, 0, 0};
  if (bound > 0) bk.init(build[0], build[bound - 1], log_nb);
  for (int i = threadIdx.x; i <= bk.count && bound > 0; i += blockDim.x)
    sidx[i] = index[i];
  if (SMEM) {
    // whole pairs of rows with 16-byte loads where aligned; row bound of
    // an odd bound is still below bcap, which is then even
    const bool vec = (reinterpret_cast<uintptr_t>(build) & 15) == 0 &&
                     (bcap & 1) == 0;
    for (int w = 0; w < W; ++w) {
      const i64* src = build + (i64)w * bcap;
      i64* dst = sbuild + (i64)w * bcap;
      if (vec) {
        const int pairs = (bound + 1) >> 1;
        for (int i = threadIdx.x; i < pairs; i += blockDim.x)
          reinterpret_cast<longlong2*>(dst)[i] =
              reinterpret_cast<const longlong2*>(src)[i];
      } else {
        for (int i = threadIdx.x; i < bound; i += blockDim.x) dst[i] = src[i];
      }
    }
  }
  __syncthreads();
  const i64* keys = SMEM ? sbuild : build;
  const i64 step = (i64)gridDim.x * blockDim.x;
  for (i64 p = (i64)blockIdx.x * blockDim.x + threadIdx.x; p < n;
       p += 2 * step) {
    const i64 p2 = p + step;
    const bool two = p2 < n;
    ProbeKey<KW> qa, qb;
    qa.load(probe, n, p, W);
    const bool va = all_valid[p];
    bool vb = false;
    if (two) {
      qb.load(probe, n, p2, W);
      vb = all_valid[p2];
    }
    int lower, upper;
    key_range(keys, bcap, sidx, bk, bound, qa, lower, upper);
    lo_out[p] = lower;
    cnt_out[p] = va ? upper - lower : 0;
    if (two) {
      key_range(keys, bcap, sidx, bk, bound, qb, lower, upper);
      lo_out[p2] = lower;
      cnt_out[p2] = vb ? upper - lower : 0;
    }
  }
}

template <int KW, bool SMEM>
int launch_probe(const i64* build, int bcap, int W, const int* bound,
                 int log_nb, const int* index, const i64* probe, i64 n,
                 const uint8_t* all_valid, int* lo, int* counts,
                 size_t smem, int blocks, cudaStream_t s) {
  auto kernel = probe_ranges_kernel<KW, SMEM>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<blocks, kProbeThreads, smem, s>>>(build, bcap, W, bound, log_nb,
                                             index, probe, n, all_valid, lo,
                                             counts);
  return (int)cudaGetLastError();
}

template <bool SMEM>
int launch_w(const i64* build, int bcap, int W, const int* bound,
             int log_nb, const int* index, const i64* probe, i64 n,
             const uint8_t* all_valid, int* lo, int* counts, size_t smem,
             int blocks, cudaStream_t s) {
#define SRTPU_PROBE(KW)                                                 \
  return launch_probe<KW, SMEM>(build, bcap, W, bound, log_nb, index,   \
                                probe, n, all_valid, lo, counts, smem,  \
                                blocks, s)
  switch (W) {
    case 1: SRTPU_PROBE(1);
    case 2: SRTPU_PROBE(2);
    case 3: SRTPU_PROBE(3);
    case 4: SRTPU_PROBE(4);
    default: SRTPU_PROBE(0);
  }
#undef SRTPU_PROBE
}

}  // namespace srtpu

using namespace srtpu;

// build: [W, bcap] int64 (row-major, sorted); probe: [W, n] int64;
// valid_bound: 0-d int32; all_valid: [n] bool; lo, counts: [n] int32;
// index: 2^14 + 1 int32 of scratch (the bucket starts).
extern "C" int srtpu_probe_ranges(const void* build, int bcap, int W,
                                  const void* valid_bound, const void* probe,
                                  long long n, const void* all_valid,
                                  void* lo, void* counts, void* index,
                                  int sm_count, void* stream) {
  if (W < 1 || bcap < 0 || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t build_bytes = (size_t)W * bcap * sizeof(i64);
  const bool in_smem = build_bytes <= kSmemBuildMax;
  // as many buckets as build rows (a power of two), as far as they fit
  int log_nb = 1;
  while (log_nb < kIndexLogMax && (1LL << log_nb) < bcap) ++log_nb;
  size_t smem;
  for (;; --log_nb) {
    smem = (in_smem ? build_bytes : 0) +
           (((size_t)1 << log_nb) + 1) * sizeof(int);
    if (smem <= kSmemBlockMax || log_nb == 1) break;
  }
  i64 index_blocks = ((i64)bcap + kThreads) / kThreads;  // bcap + 1 rows
  if (index_blocks > (i64)sm_count * 8) index_blocks = (i64)sm_count * 8;
  bucket_index_kernel<<<(int)index_blocks, kThreads, 0, s>>>(
      (const i64*)build, bcap, (const int*)valid_bound, log_nb, (int*)index);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int per_sm = smem <= kSmemTwoBlocks ? 2 : 1;
  i64 blocks = (n + 2 * kProbeThreads - 1) / (2 * kProbeThreads);
  if (blocks > (i64)sm_count * per_sm) blocks = (i64)sm_count * per_sm;
  if (blocks < 1) blocks = 1;
  return in_smem
             ? launch_w<true>((const i64*)build, bcap, W,
                              (const int*)valid_bound, log_nb,
                              (const int*)index, (const i64*)probe, n,
                              (const uint8_t*)all_valid, (int*)lo,
                              (int*)counts, smem, (int)blocks, s)
             : launch_w<false>((const i64*)build, bcap, W,
                               (const int*)valid_bound, log_nb,
                               (const int*)index, (const i64*)probe, n,
                               (const uint8_t*)all_valid, (int*)lo,
                               (int*)counts, smem, (int)blocks, s);
}
