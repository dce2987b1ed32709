// K20 str_rewrite: rewrites each row of a string column within its width:
// a byte map, a rule of which bytes stay (left-packed, the tail zeroed,
// the new byte count written), a reversal by character, InitCap, or the
// character count alone.
//
// Replaces these rewrites of spark_rapids_tpu/expr/strings.py, which XLA
// compiles: _compact_bytes (:261, a stable row-wise argsort of ~keep and a
// take), the case maps (_CaseMap :57), Substring (:102, a cumsum of
// character starts), the trim family (:321, cumprods from either end),
// StringTranslate (:586, a byte table and a delete set), StringReverse
// (:461, a cummax and a row-wise argsort of character keys), InitCap
// (:490), SubstringIndex's keep (:792-814) and Length (:49, the
// _is_continuation count). Kinds:
//   kMap      each byte b < len becomes table[b], or goes when table[b]
//             is negative (Upper, Lower, Translate);
//   kChars    the bytes of the characters [start, end) that Spark's
//             substringSQL(a = pos, b = length) keeps (Substring);
//   kTrim     the bytes between the leading (a != 0) and the trailing
//             (b != 0) run of bytes with a negative table entry;
//   kRange    the bytes in [lo[r], hi[r]) (SubstringIndex, from K19);
//   kReverse  the characters in reverse order, each character's bytes in
//             order; continuation bytes before the first character start
//             (no character of their own) go last, in order, as the
//             reference's sort keys place them;
//   kInitCap  an ASCII letter after a space or at the start upper-cased,
//             every other ASCII letter lower-cased;
//   kLength   out_len[r] = the characters (bytes that are not UTF-8
//             continuation bytes); no bytes are written.
// A character is a byte that is not a continuation byte (0b10xxxxxx)
// with the continuation bytes after it, as the reference counts them.
//
// Bound on the H100: bytes. It reads each row's bytes up to its length
// and writes the row's width and its length: for 15M comment rows of
// width 128, about 2.6 GB, 0.78 ms at 3.35 TB/s.
//
// Design: one thread a row; the row is read and written 8 bytes a load
// and a store (RowReader, RowWriter), so the compaction that the
// reference does with a sort is a single ordered pass. The 256-entry
// table sits in shared memory. kChars with a negative position, kTrim
// and kReverse take one more pass over the row (the character count, the
// trailing run, the walk back).

#include "strings.cuh"

namespace srtpu {

enum RewriteKind { kMap = 0, kChars = 1, kTrim = 2, kRange = 3,
                   kReverse = 4, kInitCap = 5, kLength = 6 };

__global__ void __launch_bounds__(kStrThreads)
str_rewrite_kernel(int kind, const uint8_t* __restrict__ data,
                   const int* __restrict__ lengths, i64 n, int mb,
                   const int16_t* __restrict__ table, i64 a, i64 b,
                   const int* __restrict__ lo_p, const int* __restrict__ hi_p,
                   uint8_t* __restrict__ out, int* __restrict__ out_len) {
  __shared__ int16_t tab[256];
  if (table != nullptr)
    for (int i = threadIdx.x; i < 256; i += blockDim.x) tab[i] = table[i];
  __syncthreads();
  for (i64 r = (i64)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += (i64)gridDim.x * blockDim.x) {
    const int len = row_len(lengths, r, mb);
    RowReader row(data, r, mb);
    if (kind == kLength) {
      int chars = 0;
      for (int i = 0; i < len; ++i) chars += !is_cont(row[i]);
      out_len[r] = chars;
      continue;
    }
    RowWriter w(out, r, mb);
    if (kind == kMap) {
      for (int i = 0; i < len; ++i) {
        const int m = tab[row[i]];
        if (m >= 0) w.put((uint32_t)m);
      }
    } else if (kind == kChars) {
      i64 start_raw;
      if (a > 0) {
        start_raw = a - 1;
      } else if (a == 0) {
        start_raw = 0;
      } else {
        i64 nchars = 0;
        for (int i = 0; i < len; ++i) nchars += !is_cont(row[i]);
        start_raw = nchars + a;
      }
      const i64 end_char = start_raw + (b < (1LL << 30) ? b : (1LL << 30));
      const i64 start_char = start_raw > 0 ? start_raw : 0;
      i64 ci = -1;
      for (int i = 0; i < len; ++i) {
        const uint32_t c = row[i];
        ci += !is_cont(c);
        if (ci >= end_char) break;
        if (ci >= start_char) w.put(c);
      }
    } else if (kind == kTrim) {
      int first = 0, last = len;
      if (a != 0) {
        while (first < len && tab[row[first]] < 0) ++first;
      }
      if (b != 0) {
        last = 0;
        for (int i = len - 1; i >= 0; --i)
          if (tab[row[i]] >= 0) {
            last = i + 1;
            break;
          }
      }
      for (int i = first; i < last; ++i) w.put(row[i]);
    } else if (kind == kRange) {
      const int lo = lo_p[r] > 0 ? lo_p[r] : 0;
      const int hi = hi_p[r] < len ? hi_p[r] : len;
      for (int i = lo; i < hi; ++i) w.put(row[i]);
    } else if (kind == kReverse) {
      int i = len - 1;
      while (i >= 0) {
        const int end = i + 1;
        while (i >= 0 && is_cont(row[i])) --i;
        const int p = i >= 0 ? i : 0;  // no start: the orphan prefix
        for (int k = p; k < end; ++k) w.put(row[k]);
        i = p - 1;
      }
    } else {  // kInitCap
      uint32_t prev = 0x20;
      for (int i = 0; i < len; ++i) {
        const uint32_t c = row[i];
        uint32_t o = c;
        if (prev == 0x20) {
          if (c >= 0x61 && c <= 0x7A) o = c - 32;
        } else if (c >= 0x41 && c <= 0x5A) {
          o = c + 32;
        }
        w.put(o);
        prev = c;
      }
    }
    const int written = w.finish();
    if (out_len != nullptr) out_len[r] = written;
  }
}

}  // namespace srtpu

using namespace srtpu;

// data: [n, mb] uint8; lengths: [n] int32; table: [256] int16 (kMap,
// kTrim; null otherwise); lo/hi: [n] int32 (kRange); out: [n, mb] uint8
// (null for kLength); out_len: [n] int32, or null where the caller keeps
// the input's lengths.
extern "C" int srtpu_str_rewrite(int kind, const void* data,
                                 const void* lengths, long long n, int mb,
                                 const void* table, long long a, long long b,
                                 const void* lo, const void* hi, void* out,
                                 void* out_len, int sm_count, void* stream) {
  if (n < 1 || mb < 1 || kind < kMap || kind > kLength ||
      ((kind == kMap || kind == kTrim) && table == nullptr) ||
      (kind == kRange && (lo == nullptr || hi == nullptr)) ||
      (kind == kLength ? out_len == nullptr : out == nullptr))
    return (int)cudaErrorInvalidValue;
  str_rewrite_kernel<<<str_blocks(n, sm_count), kStrThreads, 0,
                       (cudaStream_t)stream>>>(
      kind, (const uint8_t*)data, (const int*)lengths, n, mb,
      (const int16_t*)table, a, b, (const int*)lo, (const int*)hi,
      (uint8_t*)out, (int*)out_len);
  return (int)cudaGetLastError();
}
