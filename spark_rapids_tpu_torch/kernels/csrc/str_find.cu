// K19 str_find: where a literal needle occurs in each row of a string
// column.
//
// Replaces the needle search of spark_rapids_tpu/expr/strings.py:
// Contains (:226, a sliding compare of every start), _find_candidates
// (:275, the same as an [n, mb] mask), _select_nonoverlapping (:289, a
// lax.scan over the positions carrying each row's next free byte) and
// _first_match_charpos (:550, a cumsum of character starts and an
// argmax), which XLA compiles. Modes:
//   kFindAny     out0[r] = the needle starts at some byte s with
//                s + nb <= len (Contains);
//   kFindFirst   out0[r] = 1 + the character index of the first start at
//                a character (not a UTF-8 continuation byte) whose index
//                is >= arg, else 0; an empty needle gives
//                min(arg, nchars) + 1 when arg <= nchars, else 0 (Instr,
//                Locate);
//   kFindSelect  out0[r, s] = 1 at the starts Java's repeated indexOf
//                takes: left to right, each at or past the end of the one
//                before (StringReplace's emission, K21);
//   kFindSplit   SubstringIndex's cut over those starts, as the byte
//                range [out0[r], out1[r]) it keeps (K20 compacts it):
//                arg > 0 keeps the bytes before the arg-th start (all
//                when there are fewer); arg < 0 keeps the bytes after the
//                end of the (total + arg + 1)-th start (all when there
//                are fewer than -arg).
// An empty needle or one longer than a row never starts in it (but in
// kFindFirst, above).
//
// Bound on the H100: bytes. It reads each row's bytes up to its length
// and writes 1 or 4 bytes a row (mb bytes a row for kFindSelect): for 15M
// comment rows of about 48 bytes, about 0.8 GB, 0.24 ms at 3.35 TB/s.
//
// Design: one thread a row. The scan reads the row 8 bytes a load
// (RowReader) and compares the rest of the needle only where its first
// byte matches (L1-cached byte loads); the greedy selection carries the
// next free byte in a register, as the reference's scan carries it across
// steps. kFindSplit with arg < 0 walks the row twice: the first pass
// counts the starts.

#include "strings.cuh"

namespace srtpu {

enum FindMode { kFindAny = 0, kFindFirst = 1, kFindSelect = 2,
                kFindSplit = 3 };

__device__ __forceinline__ bool match_at(const uint8_t* __restrict__ row,
                                         int s,
                                         const uint8_t* __restrict__ needle,
                                         int nb) {
  for (int j = 1; j < nb; ++j)
    if (__ldg(row + s + j) != __ldg(needle + j)) return false;
  return true;
}

// the greedy starts of one row, in order: calls f(s) for each; stops
// when f returns false
template <typename F>
__device__ __forceinline__ void each_start(RowReader& row, int len,
                                           const uint8_t* __restrict__ needle,
                                           int nb, F f) {
  if (nb < 1) return;
  const uint32_t first = __ldg(needle);
  for (int s = 0; s + nb <= len; ++s) {
    if (row[s] == first && match_at(row.row, s, needle, nb)) {
      if (!f(s)) return;
      s += nb - 1;
    }
  }
}

__global__ void __launch_bounds__(kStrThreads)
str_find_kernel(int mode, const uint8_t* __restrict__ data,
                const int* __restrict__ lengths, i64 n, int mb,
                const uint8_t* __restrict__ needle, int nb, i64 arg,
                void* __restrict__ out0, void* __restrict__ out1) {
  for (i64 r = (i64)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += (i64)gridDim.x * blockDim.x) {
    const int len = row_len(lengths, r, mb);
    RowReader row(data, r, mb);
    if (mode == kFindAny) {
      bool found = nb == 0;
      each_start(row, len, needle, nb, [&](int) {
        found = true;
        return false;
      });
      static_cast<uint8_t*>(out0)[r] = found;
    } else if (mode == kFindFirst) {
      int hit = 0;
      if (nb == 0) {
        i64 nchars = 0;
        for (int i = 0; i < len; ++i) nchars += !is_cont(row[i]);
        hit = arg <= nchars ? (int)((arg < nchars ? arg : nchars) + 1) : 0;
      } else {
        const uint32_t first = __ldg(needle);
        i64 ci = -1;  // character index of byte s
        for (int s = 0; s + nb <= len; ++s) {
          const uint32_t b = row[s];
          if (is_cont(b)) continue;
          ++ci;
          if (ci >= arg && b == first && match_at(row.row, s, needle, nb)) {
            hit = (int)(ci + 1);
            break;
          }
        }
      }
      static_cast<int*>(out0)[r] = hit;
    } else if (mode == kFindSelect) {
      RowWriter sel(static_cast<uint8_t*>(out0), r, mb);
      each_start(row, len, needle, nb, [&](int s) {
        while (sel.pos < s) sel.put(0);
        sel.put(1);
        return true;
      });
      sel.finish();
    } else {
      int lo = 0, hi = len;
      if (arg > 0) {
        i64 k = 0;
        each_start(row, len, needle, nb, [&](int s) {
          if (++k == arg) {
            hi = s;
            return false;
          }
          return true;
        });
      } else {
        i64 total = 0;
        each_start(row, len, needle, nb, [&](int) {
          ++total;
          return true;
        });
        if (total >= -arg) {
          const i64 target = total + arg + 1;
          i64 k = 0;
          RowReader again(data, r, mb);
          each_start(again, len, needle, nb, [&](int s) {
            if (++k == target) {
              lo = s + nb;
              return false;
            }
            return true;
          });
        }
      }
      static_cast<int*>(out0)[r] = lo;
      static_cast<int*>(out1)[r] = hi;
    }
  }
}

}  // namespace srtpu

using namespace srtpu;

// data: [n, mb] uint8; lengths: [n] int32; needle: nb bytes on the
// device (null when nb is 0); out0/out1 as the mode says above.
extern "C" int srtpu_str_find(int mode, const void* data, const void* lengths,
                              long long n, int mb, const void* needle, int nb,
                              long long arg, void* out0, void* out1,
                              int sm_count, void* stream) {
  if (n < 1 || mb < 1 || nb < 0 || mode < kFindAny || mode > kFindSplit ||
      (nb > 0 && needle == nullptr) || (mode == kFindSplit && (arg == 0 ||
                                                              out1 == nullptr)))
    return (int)cudaErrorInvalidValue;
  str_find_kernel<<<str_blocks(n, sm_count), kStrThreads, 0,
                    (cudaStream_t)stream>>>(
      mode, (const uint8_t*)data, (const int*)lengths, n, mb,
      (const uint8_t*)needle, nb, arg, out0, out1);
  return (int)cudaGetLastError();
}
