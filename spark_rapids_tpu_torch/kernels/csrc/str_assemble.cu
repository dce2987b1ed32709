// K21 str_assemble: writes each output row of width mb_out from spans of
// its inputs.
//
// Replaces the assembling rewrites of spark_rapids_tpu/expr/strings.py,
// which XLA compiles: Concat (:142) and ConcatWs (:679), each a gather of
// every input at the running offset (take_along_axis) and a cumulative
// offset; LPad and RPad (:390, :405, with _layout :370, a cumsum of
// character starts); StringRepeat (:434); and StringReplace's emission
// (:625-656, a cummax over the selected starts, a cumsum of emitted
// bytes and a row-wise argsort that packs them). Kinds:
//   kConcat    the columns' bytes one after another (Concat: nulls are
//              the caller's validity);
//   kConcatWs  the valid columns' bytes, `text` between two of them
//              (ConcatWs);
//   kLPad      a characters: (a - nchars) bytes of the cycled `text`, then
//              the bytes of the row's first a characters (LPad);
//   kRPad      those bytes first, the cycled pad after them (RPad);
//   kRepeat    the row's bytes a times (StringRepeat);
//   kReplace   the row with `text` in place of each a-byte match that
//              K19 selected (sel[r, s] = 1 at a start: StringReplace).
// Pads take `text` from its first byte at the first pad byte, as the
// reference does. out_len[r] is the bytes written (at most mb_out).
//
// Bound on the H100: bytes. It reads the inputs' bytes up to their
// lengths (and sel's row for kReplace) and writes mb_out bytes and a
// length a row: for 36M joined `promo` rows, concat_ws to width 32 is
// about 2.2 GB, 0.66 ms at 3.35 TB/s.
//
// Design: one thread an output row, written left to right 8 bytes a
// store (RowWriter), its inputs read 8 bytes a load (RowReader), so the
// output offset the reference scans for is a register. The column
// descriptors travel in parameter space.

#include "strings.cuh"

namespace srtpu {

struct StrCol {
  const uint8_t* data;      // [n, width] uint8
  const int* lengths;       // [n] int32
  const uint8_t* validity;  // [n] bool (kConcatWs)
  int width;
  int pad;
};

constexpr int kMaxStrCols = 16;

struct StrCols {
  StrCol c[kMaxStrCols];
};

enum AssembleKind { kConcat = 0, kConcatWs = 1, kLPad = 2, kRPad = 3,
                    kRepeat = 4, kReplace = 5 };

__device__ __forceinline__ void put_span(RowWriter& w, RowReader& row,
                                         int lo, int hi) {
  for (int i = lo; i < hi; ++i) w.put(row[i]);
}

__global__ void __launch_bounds__(kStrThreads)
str_assemble_kernel(int kind, StrCols cols, int ncols, i64 n,
                    const uint8_t* __restrict__ text, int tlen, i64 a,
                    const uint8_t* __restrict__ sel, uint8_t* __restrict__ out,
                    int mb_out, int* __restrict__ out_len) {
  for (i64 r = (i64)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += (i64)gridDim.x * blockDim.x) {
    RowWriter w(out, r, mb_out);
    if (kind == kConcat || kind == kConcatWs) {
      bool any = false;
      for (int k = 0; k < ncols; ++k) {
        const StrCol& c = cols.c[k];
        if (kind == kConcatWs) {
          if (!c.validity[r]) continue;
          if (any)
            for (int j = 0; j < tlen; ++j) w.put(__ldg(text + j));
          any = true;
        }
        RowReader row(c.data, r, c.width);
        put_span(w, row, 0, row_len(c.lengths, r, c.width));
      }
    } else {
      const StrCol& c = cols.c[0];
      const int len = row_len(c.lengths, r, c.width);
      RowReader row(c.data, r, c.width);
      if (kind == kLPad || kind == kRPad) {
        i64 nchars = 0;
        int kept = len;
        for (int i = 0; i < len; ++i) {
          if (is_cont(row[i])) continue;
          if (nchars == a) kept = i;
          ++nchars;
        }
        const i64 npad = a > nchars ? a - nchars : 0;
        if (kind == kRPad) put_span(w, row, 0, kept);
        for (i64 j = 0; j < npad && w.pos < mb_out; ++j)
          w.put(__ldg(text + j % tlen));
        if (kind == kLPad) put_span(w, row, 0, kept);
      } else if (kind == kRepeat) {
        for (i64 t = 0; t < a && len > 0 && w.pos < mb_out; ++t)
          put_span(w, row, 0, len);
      } else {  // kReplace
        RowReader starts(sel, r, c.width);
        int i = 0;
        while (i < len) {
          if (starts[i]) {
            for (int j = 0; j < tlen; ++j) w.put(__ldg(text + j));
            i += (int)a;
          } else {
            w.put(row[i]);
            ++i;
          }
        }
      }
    }
    out_len[r] = w.finish();
  }
}

}  // namespace srtpu

using namespace srtpu;

// cols: host array of ncols StrCol (at most 16; one for the pads, repeat
// and replace); text: tlen bytes on the device (the separator, the pad,
// the replacement; null when tlen is 0); sel: [n, cols[0].width] uint8
// (kReplace); out: [n, mb_out] uint8; out_len: [n] int32.
extern "C" int srtpu_str_assemble(int kind, const StrCol* cols, int ncols,
                                  long long n, const void* text, int tlen,
                                  long long a, const void* sel, void* out,
                                  int mb_out, void* out_len, int sm_count,
                                  void* stream) {
  if (n < 1 || mb_out < 1 || ncols < 1 || ncols > kMaxStrCols ||
      kind < kConcat || kind > kReplace || tlen < 0 ||
      (tlen > 0 && text == nullptr) ||
      ((kind == kLPad || kind == kRPad) && tlen < 1) ||
      (kind == kReplace && (sel == nullptr || a < 1)))
    return (int)cudaErrorInvalidValue;
  StrCols t = {};
  for (int k = 0; k < ncols; ++k) {
    t.c[k] = cols[k];
    if (kind == kConcatWs && cols[k].validity == nullptr)
      return (int)cudaErrorInvalidValue;
  }
  str_assemble_kernel<<<str_blocks(n, sm_count), kStrThreads, 0,
                        (cudaStream_t)stream>>>(
      kind, t, ncols, n, (const uint8_t*)text, tlen, a,
      (const uint8_t*)sel, (uint8_t*)out, mb_out, (int*)out_len);
  return (int)cudaGetLastError();
}
