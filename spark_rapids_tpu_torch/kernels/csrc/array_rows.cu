// K34 array_compact and K35 array_sort: row-local passes over the padded
// array layout ([rows, max_elems] elements, their validity, the row's
// element count), one mode a launch.
//
// K34, compact: replaces spark_rapids_tpu/expr/collections.py:625
// _row_compact (a stable argsort of ~keep along each row and three
// take_along_axis), behind ArrayFilter (:336), ArrayRemove (:730),
// ArrayIntersect and ArrayExcept (:919, :931). Kept elements move to the
// row's front in order with their validity (ev & keep) and, for an
// array<string> cube, their byte counts; lengths = kept count. Slots past
// it are zeroed (the reference leaves the dropped elements there, which
// nothing reads: every reader masks with j < lengths).
// K34, distinct: replaces :944 _distinct_of (a [rows, me, me] pairwise
// equality, an "earlier" mask and an any) and the compaction after it,
// behind ArrayDistinct, ArrayIntersect, ArrayExcept and ArrayUnion: an
// element j < lengths is kept unless an earlier element of the row equals
// it, NULL equal to NULL and NaN to NaN (-0.0 equals 0.0), the
// reference's `_elem_eq` with its validity arguments. No [rows, me, me]
// intermediate is built.
// K35, sort: replaces :391-433 SortArray (jnp.lexsort of (key, rank)
// along each row and two take_along_axis). The first lengths elements are
// sorted stably by (rank, key): rank 0 for nulls ascending (1
// descending), 1 for values ascending (0 descending); key the value,
// NaN mapped to +inf, negated (two's complement, wrapping) for
// descending, so NaN ties +inf and INT_MIN stays first descending, as in
// the reference (ROADMAP section C). Slots past lengths keep their place
// (the reference's rank 2 sorts them last, stably).
//
// Bound on the H100: bytes. Each row's elements, validity and count are
// read once and written once; for the path's [15M, 8] int32 arrays about
// 15M * (8 * (4 + 1) * 2 + 4 * 2) bytes.
//
// Design: one thread a row over a grid-stride loop. The row's elements
// sit at a stride of max_elems * element bytes, so neighbouring threads
// read neighbouring row blocks; the thread keeps a running output slot
// (compact, distinct) or insertion-sorts its row in the output (sort,
// O(me^2) compares for the path's me = 8). No shared memory, no atomics.

#include <math.h>

#include "common.cuh"

namespace srtpu {

enum ArrMode { kArrCompact = 0, kArrDistinct = 1, kArrSortAsc = 2,
               kArrSortDesc = 3 };
// element kinds (kernels.ELEM_KINDS); kArrBytes: an opaque element of
// elem_bytes bytes (a cube's string), compact mode only
enum ArrKind { kArrI8 = 0, kArrI16 = 1, kArrI32 = 2, kArrI64 = 3,
               kArrF32 = 4, kArrF64 = 5, kArrBytes = 6 };

template <typename T>
__device__ __forceinline__ bool arr_eq(T a, T b) {
  return a == b;
}
template <>
__device__ __forceinline__ bool arr_eq<float>(float a, float b) {
  return a == b || (isnan(a) && isnan(b));
}
template <>
__device__ __forceinline__ bool arr_eq<double>(double a, double b) {
  return a == b || (isnan(a) && isnan(b));
}

// the sort key: NaN -> +inf, negated for descending; an integer's
// negation wraps in its own width (the negation of its minimum is the
// minimum), computed in 64 bits
template <typename T>
struct SortKey {
  typedef long long type;
  __device__ __forceinline__ static long long of(T v, bool desc) {
    const long long x = (long long)v;
    if (!desc) return x;
    const T low = (T)(1ULL << (sizeof(T) * 8 - 1));  // T's minimum
    if (x == (long long)low) return x;
    return -x;
  }
};
template <>
struct SortKey<float> {
  typedef float type;
  __device__ __forceinline__ static float of(float v, bool desc) {
    if (isnan(v)) v = INFINITY;
    return desc ? -v : v;
  }
};
template <>
struct SortKey<double> {
  typedef double type;
  __device__ __forceinline__ static double of(double v, bool desc) {
    if (isnan(v)) v = INFINITY;
    return desc ? -v : v;
  }
};

// Compact or distinct over typed elements.
template <typename T>
__global__ void __launch_bounds__(kThreads)
array_compact_kernel(const T* __restrict__ data,
                     const uint8_t* __restrict__ ev,
                     const uint8_t* __restrict__ keep,
                     const int* __restrict__ lengths, i64 rows, int me,
                     int distinct, T* __restrict__ out,
                     uint8_t* __restrict__ out_ev,
                     int* __restrict__ out_len) {
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 r = (i64)blockIdx.x * blockDim.x + threadIdx.x; r < rows;
       r += stride) {
    const T* in = data + r * me;
    const uint8_t* iv = ev + r * me;
    T* o = out + r * me;
    uint8_t* ov = out_ev + r * me;
    int m = 0;
    if (distinct) {
      const int len = lengths[r] < me ? lengths[r] : me;
      for (int j = 0; j < len; ++j) {
        const T v = in[j];
        const bool ok = iv[j] != 0;
        bool dup = false;
        for (int q = 0; q < j && !dup; ++q)
          dup = ok ? (iv[q] && arr_eq<T>(in[q], v)) : !iv[q];
        if (dup) continue;
        o[m] = v;
        ov[m] = ok;
        ++m;
      }
    } else {
      const uint8_t* kp = keep + r * me;
      for (int j = 0; j < me; ++j) {
        if (!kp[j]) continue;
        o[m] = in[j];
        ov[m] = iv[j];
        ++m;
      }
    }
    out_len[r] = m;
    for (int q = m; q < me; ++q) {
      o[q] = T(0);
      ov[q] = 0;
    }
  }
}

// Compact of opaque elements of eb bytes (eb a multiple of 8 here), with
// their byte counts: an array<string> cube.
__global__ void __launch_bounds__(kThreads)
array_compact_bytes_kernel(const unsigned long long* __restrict__ data,
                           const uint8_t* __restrict__ ev,
                           const uint8_t* __restrict__ keep,
                           const int* __restrict__ elem_len, i64 rows,
                           int me, int words,
                           unsigned long long* __restrict__ out,
                           uint8_t* __restrict__ out_ev,
                           int* __restrict__ out_elem_len,
                           int* __restrict__ out_len) {
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 r = (i64)blockIdx.x * blockDim.x + threadIdx.x; r < rows;
       r += stride) {
    int m = 0;
    for (int j = 0; j < me; ++j) {
      if (!keep[r * me + j]) continue;
      const unsigned long long* src = data + (r * me + j) * words;
      unsigned long long* dst = out + (r * me + m) * words;
      for (int w = 0; w < words; ++w) dst[w] = src[w];
      out_ev[r * me + m] = ev[r * me + j];
      if (elem_len) out_elem_len[r * me + m] = elem_len[r * me + j];
      ++m;
    }
    out_len[r] = m;
    for (int q = m; q < me; ++q) {
      unsigned long long* dst = out + (r * me + q) * words;
      for (int w = 0; w < words; ++w) dst[w] = 0;
      out_ev[r * me + q] = 0;
      if (elem_len) out_elem_len[r * me + q] = 0;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
array_sort_kernel(const T* __restrict__ data, const uint8_t* __restrict__ ev,
                  const int* __restrict__ lengths, i64 rows, int me,
                  int desc, T* __restrict__ out,
                  uint8_t* __restrict__ out_ev) {
  const i64 stride = (i64)gridDim.x * blockDim.x;
  // a value's rank: ascending puts nulls (rank 0) first, descending
  // (valid rank 0) last
  const int valid_rank = desc ? 0 : 1;
  for (i64 r = (i64)blockIdx.x * blockDim.x + threadIdx.x; r < rows;
       r += stride) {
    const T* in = data + r * me;
    const uint8_t* iv = ev + r * me;
    T* o = out + r * me;
    uint8_t* ov = out_ev + r * me;
    for (int j = 0; j < me; ++j) {
      o[j] = in[j];
      ov[j] = iv[j];
    }
    const int len = lengths[r] < 0 ? 0 : (lengths[r] < me ? lengths[r] : me);
    for (int j = 1; j < len; ++j) {
      const T v = o[j];
      const uint8_t vok = ov[j];
      const int vr = vok ? valid_rank : 1 - valid_rank;
      const typename SortKey<T>::type vk = SortKey<T>::of(v, desc);
      int q = j - 1;
      while (q >= 0) {
        const int qr = ov[q] ? valid_rank : 1 - valid_rank;
        if (!(vr < qr || (vr == qr && vk < SortKey<T>::of(o[q], desc))))
          break;
        o[q + 1] = o[q];
        ov[q + 1] = ov[q];
        --q;
      }
      o[q + 1] = v;
      ov[q + 1] = vok;
    }
  }
}

template <typename T>
static int array_launch(int mode, const void* data, const void* ev,
                        const void* keep, const void* lengths, i64 rows,
                        int me, void* out, void* out_ev, void* out_len,
                        int sm_count, cudaStream_t s) {
  const unsigned blocks = (unsigned)(
      (rows + kThreads - 1) / kThreads < 16LL * sm_count
          ? (rows + kThreads - 1) / kThreads : 16LL * sm_count);
  if (mode == kArrSortAsc || mode == kArrSortDesc)
    array_sort_kernel<T><<<blocks, kThreads, 0, s>>>(
        (const T*)data, (const uint8_t*)ev, (const int*)lengths, rows, me,
        mode == kArrSortDesc, (T*)out, (uint8_t*)out_ev);
  else
    array_compact_kernel<T><<<blocks, kThreads, 0, s>>>(
        (const T*)data, (const uint8_t*)ev, (const uint8_t*)keep,
        (const int*)lengths, rows, me, mode == kArrDistinct, (T*)out,
        (uint8_t*)out_ev, (int*)out_len);
  return (int)cudaGetLastError();
}

}  // namespace srtpu

using namespace srtpu;

// data: [rows, me] elements of `kind` (or [rows, me, elem_bytes] bytes
// for kArrBytes, elem_bytes a multiple of 8); ev, keep: [rows, me] bool;
// lengths: [rows] int32 (read by distinct and sort); elem_len: [rows, me]
// int32 or null (kArrBytes); out, out_ev, out_elem_len like the inputs;
// out_len: [rows] int32 (compact, distinct). Sort writes out and out_ev.
extern "C" int srtpu_array_rows(int mode, int kind, int elem_bytes,
                                const void* data, const void* ev,
                                const void* keep, const void* lengths,
                                const void* elem_len, long long rows, int me,
                                void* out, void* out_ev, void* out_elem_len,
                                void* out_len, int sm_count, void* stream) {
  if (rows < 0 || me < 1 || mode < kArrCompact || mode > kArrSortDesc)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (kind == kArrBytes) {
    if (mode != kArrCompact || elem_bytes < 8 || elem_bytes % 8)
      return (int)cudaErrorInvalidValue;
    const long long want = (rows + kThreads - 1) / kThreads;
    const unsigned blocks =
        (unsigned)(want < 16LL * sm_count ? want : 16LL * sm_count);
    array_compact_bytes_kernel<<<blocks, kThreads, 0, s>>>(
        (const unsigned long long*)data, (const uint8_t*)ev,
        (const uint8_t*)keep, (const int*)elem_len, rows, me,
        elem_bytes / 8, (unsigned long long*)out, (uint8_t*)out_ev,
        (int*)out_elem_len, (int*)out_len);
    return (int)cudaGetLastError();
  }
  switch (kind) {
    case kArrI8:
      return array_launch<int8_t>(mode, data, ev, keep, lengths, rows, me,
                                  out, out_ev, out_len, sm_count, s);
    case kArrI16:
      return array_launch<short>(mode, data, ev, keep, lengths, rows, me,
                                 out, out_ev, out_len, sm_count, s);
    case kArrI32:
      return array_launch<int>(mode, data, ev, keep, lengths, rows, me, out,
                               out_ev, out_len, sm_count, s);
    case kArrI64:
      return array_launch<long long>(mode, data, ev, keep, lengths, rows, me,
                                     out, out_ev, out_len, sm_count, s);
    case kArrF32:
      return array_launch<float>(mode, data, ev, keep, lengths, rows, me,
                                 out, out_ev, out_len, sm_count, s);
    case kArrF64:
      return array_launch<double>(mode, data, ev, keep, lengths, rows, me,
                                  out, out_ev, out_len, sm_count, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
