// K12 seg_minmax: masked segmented minimum or maximum.
//
// Replaces spark_rapids_tpu/ops/segmented.py:420 seg_min and :431 seg_max
// (jnp.where(valid, values, ident) and jax.ops.segment_min/segment_max,
// which XLA compiles). For rows i with 0 <= gid[i] < nseg:
//   out[s] = min (max) over rows with gid s of (valid[i] ? values[i] : ident)
// and out[s] = ident for a segment no row names, where ident is +inf (-inf)
// for floats and the type's largest (smallest) value for integers. Rows
// whose gid lies outside [0, nseg) are dropped, as segment_min drops them.
// Floats follow what jax.ops.segment_min/max give on the CPU backend: a NaN
// in a segment makes its result NaN (written as the canonical quiet NaN),
// and -0.0 orders below 0.0, so min(-0.0, 0.0) = -0.0 and max = 0.0.
//
// Every value maps to an integer key whose signed order is that order
// (for floats the IEEE total-order bit trick, with NaN mapped to the
// type's smallest key for a minimum and its largest for a maximum; no real
// value maps there), so every reduction is an integer atomicMin/atomicMax
// on the output taken as keys, and floats map back in a last pass.
//
// Bound on the H100: bytes. It reads the value, gid and (where given)
// validity of every row and writes nseg results: the window's partition
// bounds over 2^26 int32 positions move 4 + 4 bytes a row, 537 MB, 0.16 ms
// at 3.35 TB/s.
//
// Design: three launches on the caller's stream: fill the output with the
// identity's key; reduce; map float keys back (integers skip it).
// - sorted gid (the reference's default, `_SORTED_GIDS`): a warp owns
//   kRounds * 32 consecutive rows; per round a segmented scan over the
//   warp's 32 rows (shuffles; equal neighbouring gids are one run, since
//   gid is sorted) leaves each run's partial in its last lane, a run that
//   ends inside the round goes to memory by one atomic, and the run open
//   at lane 31 is carried in registers to the next round. So a run costs
//   one atomic per warp it touches, not one per row: the ~2,000 partition
//   bounds over 2^26 rows take ~131,000 atomics, not 2^26.
// - unsorted gid: one atomic per valid row with an in-range gid.

#include <limits.h>

#include "common.cuh"

namespace srtpu {

constexpr int kRounds = 16;  // rounds of 32 rows a warp owns (sorted path)

enum SegType { kSegI32 = 0, kSegI64 = 1, kSegF32 = 2, kSegF64 = 3 };

// Ord<T>: T's integer key type K and the value <-> key maps
template <typename T>
struct Ord;

template <>
struct Ord<int> {
  typedef int K;
  __device__ static K key(int v, bool) { return v; }
  __device__ static int val(K k) { return k; }
  __device__ static K ident(bool is_max) { return is_max ? INT_MIN : INT_MAX; }
};

template <>
struct Ord<long long> {
  typedef long long K;
  __device__ static K key(long long v, bool) { return v; }
  __device__ static long long val(K k) { return k; }
  __device__ static K ident(bool is_max) {
    return is_max ? LLONG_MIN : LLONG_MAX;
  }
};

template <>
struct Ord<float> {
  typedef int K;
  __device__ static K key(float v, bool is_max) {
    if (v != v) return is_max ? INT_MAX : INT_MIN;
    const int b = __float_as_int(v);
    return b ^ ((b >> 31) & 0x7fffffff);
  }
  __device__ static float val(K k) {
    if (k == INT_MAX || k == INT_MIN) return __int_as_float(0x7fc00000);
    return __int_as_float(k ^ ((k >> 31) & 0x7fffffff));
  }
  __device__ static K ident(bool is_max) {
    return key(__int_as_float(is_max ? (int)0xff800000u : 0x7f800000),
               is_max);
  }
};

template <>
struct Ord<double> {
  typedef long long K;
  __device__ static K key(double v, bool is_max) {
    if (v != v) return is_max ? LLONG_MAX : LLONG_MIN;
    const long long b = __double_as_longlong(v);
    return b ^ ((b >> 63) & 0x7fffffffffffffffLL);
  }
  __device__ static double val(K k) {
    if (k == LLONG_MAX || k == LLONG_MIN)
      return __longlong_as_double(0x7ff8000000000000LL);
    return __longlong_as_double(k ^ ((k >> 63) & 0x7fffffffffffffffLL));
  }
  __device__ static K ident(bool is_max) {
    return key(__longlong_as_double(is_max ? (long long)0xfff0000000000000ULL
                                           : 0x7ff0000000000000LL),
               is_max);
  }
};

template <typename K>
__device__ __forceinline__ K pick(K a, K b, bool is_max) {
  return is_max ? (a > b ? a : b) : (a < b ? a : b);
}

template <typename K>
__device__ __forceinline__ void atomic_pick(K* p, K v, bool is_max) {
  if (is_max)
    atomicMax(p, v);
  else
    atomicMin(p, v);
}

template <typename T>
__global__ void seg_fill_kernel(typename Ord<T>::K* __restrict__ out,
                                int nseg, bool is_max) {
  const typename Ord<T>::K id = Ord<T>::ident(is_max);
  for (int s = blockIdx.x * blockDim.x + threadIdx.x; s < nseg;
       s += gridDim.x * blockDim.x)
    out[s] = id;
}

template <typename T>
__global__ void seg_unmap_kernel(T* __restrict__ out, int nseg) {
  typedef typename Ord<T>::K K;
  for (int s = blockIdx.x * blockDim.x + threadIdx.x; s < nseg;
       s += gridDim.x * blockDim.x)
    out[s] = Ord<T>::val(reinterpret_cast<K*>(out)[s]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
seg_sorted_kernel(const T* __restrict__ vals,
                  const uint8_t* __restrict__ valid,
                  const int* __restrict__ gid, i64 n, int nseg,
                  typename Ord<T>::K* __restrict__ out, bool is_max) {
  typedef typename Ord<T>::K K;
  const int lane = threadIdx.x & 31;
  const i64 warp = ((i64)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const i64 lo = warp * (32 * kRounds);
  if (lo >= n) return;  // whole warps leave together
  const K id = Ord<T>::ident(is_max);
  int carry_g = -1;  // the run open at the end of the last round
  K carry_k = id;
  for (int r = 0; r < kRounds; ++r) {
    const i64 i = lo + r * 32 + lane;
    const bool in = i < n;
    // past the rows: a gid no row has, so the tail never joins a run
    const int g = in ? gid[i] : INT_MAX;
    K k = (in && (valid == nullptr || valid[i])) ? Ord<T>::key(vals[i], is_max)
                                                 : id;
    // segmented inclusive scan: gid is sorted, so an equal gid `off`
    // lanes below lies in this lane's run
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int og = __shfl_up_sync(kFull, g, off);
      const K ok = __shfl_up_sync(kFull, k, off);
      if (lane >= off && og == g) k = pick(k, ok, is_max);
    }
    const int g0 = __shfl_sync(kFull, g, 0);
    if (carry_g >= 0 && carry_g != g0) {
      // the carried run ended at the last round's lane 31
      if (lane == 0 && carry_g < nseg) atomic_pick(out + carry_g, carry_k,
                                                   is_max);
    } else if (carry_g >= 0 && g == carry_g) {
      k = pick(k, carry_k, is_max);
    }
    const int ng = __shfl_down_sync(kFull, g, 1);
    if (lane != 31 && ng != g && g >= 0 && g < nseg)
      atomic_pick(out + g, k, is_max);
    carry_g = __shfl_sync(kFull, g, 31);
    carry_k = __shfl_sync(kFull, k, 31);
    if (carry_g == INT_MAX) break;  // past the rows
  }
  if (lane == 0 && carry_g >= 0 && carry_g < nseg)
    atomic_pick(out + carry_g, carry_k, is_max);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
seg_unsorted_kernel(const T* __restrict__ vals,
                    const uint8_t* __restrict__ valid,
                    const int* __restrict__ gid, i64 n, int nseg,
                    typename Ord<T>::K* __restrict__ out, bool is_max) {
  for (i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (i64)gridDim.x * blockDim.x) {
    const int g = gid[i];
    if (g < 0 || g >= nseg || (valid != nullptr && !valid[i])) continue;
    atomic_pick(out + g, Ord<T>::key(vals[i], is_max), is_max);
  }
}

template <typename T>
int seg_minmax(const T* vals, const uint8_t* valid, const int* gid, i64 n,
               int nseg, T* out, bool is_max, bool sorted, int sm_count,
               cudaStream_t s) {
  typedef typename Ord<T>::K K;
  K* keys = reinterpret_cast<K*>(out);
  const int fill_blocks = nseg / kThreads + 1 < 4 * sm_count
                              ? nseg / kThreads + 1 : 4 * sm_count;
  seg_fill_kernel<T><<<fill_blocks, kThreads, 0, s>>>(keys, nseg, is_max);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (n > 0) {
    if (sorted) {
      const i64 warps = (n + 32 * kRounds - 1) / (32 * kRounds);
      const i64 blocks = (warps + kWarps - 1) / kWarps;
      seg_sorted_kernel<T><<<(unsigned)blocks, kThreads, 0, s>>>(
          vals, valid, gid, n, nseg, keys, is_max);
    } else {
      i64 blocks = (n + kThreads - 1) / kThreads;
      if (blocks > 16LL * sm_count) blocks = 16LL * sm_count;
      seg_unsorted_kernel<T><<<(unsigned)blocks, kThreads, 0, s>>>(
          vals, valid, gid, n, nseg, keys, is_max);
    }
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (sizeof(T) == sizeof(K) && (T)0.5 != (T)0) {  // floats map back
    seg_unmap_kernel<T><<<fill_blocks, kThreads, 0, s>>>(out, nseg);
    e = cudaGetLastError();
  }
  return (int)e;
}

}  // namespace srtpu

using namespace srtpu;

// type: SegType; vals: [n] of the type; valid: [n] bool or null (every row
// valid); gid: [n] int32; out: [nseg] of the type; sorted: gid is
// non-decreasing.
extern "C" int srtpu_seg_minmax(int type, int is_max, const void* vals,
                                const void* valid, const void* gid,
                                long long n, int nseg, void* out,
                                int sorted, int sm_count, void* stream) {
  if (nseg < 1 || n < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* v = (const uint8_t*)valid;
  const int* g = (const int*)gid;
  switch (type) {
    case kSegI32:
      return seg_minmax<int>((const int*)vals, v, g, n, nseg, (int*)out,
                             is_max != 0, sorted != 0, sm_count, s);
    case kSegI64:
      return seg_minmax<long long>((const long long*)vals, v, g, n, nseg,
                                   (long long*)out, is_max != 0, sorted != 0,
                                   sm_count, s);
    case kSegF32:
      return seg_minmax<float>((const float*)vals, v, g, n, nseg,
                               (float*)out, is_max != 0, sorted != 0,
                               sm_count, s);
    case kSegF64:
      return seg_minmax<double>((const double*)vals, v, g, n, nseg,
                                (double*)out, is_max != 0, sorted != 0,
                                sm_count, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
