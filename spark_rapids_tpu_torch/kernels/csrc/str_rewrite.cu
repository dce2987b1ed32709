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
// Reverse and InitCap keep the input's lengths (out_len[r] = lengths[r],
// as the reference's bodies return them); Length writes no bytes.
//
// Bound on the H100: bytes. It reads each row's bytes up to its length
// and writes the row's width and its length: for 15M comment rows of
// width 128, about 2.6 GB, 0.78 ms at 3.35 TB/s.
//
// Design: a tile of whole rows in shared memory, a thread a row. A block
// of 128 threads (fewer for wide rows) owns R consecutive rows [r0, r0 +
// R), one contiguous byte range of device memory; narrow rows take up to
// 8 KB a tile, a thread every 128th row (expr/strings.py _rewrite_plan).
// The block reads the rows' lengths, then copies the tile into shared
// memory with coalesced vec-byte loads, vec = 16 where the width and the
// data's and output's addresses allow it (else 8, 4, 2 or 1: the widest
// that divides all three, so a word never straddles two rows and every
// tile starts on a word), skipping every word that lies wholly past its
// row's length (so a 32-byte sector past the length is never read). Each
// row sits at a pitch of an odd number of 4-byte words, so a warp's 32
// threads reading or writing word k of their rows meet 32 banks, and so
// do the copies' 4-byte stores and loads. Each thread rewrites its rows in
// place (Reverse into a second tile): a word at a time where the kept
// bytes are one run, trim's (found byte by byte from either end, in one
// read of the row), substring's (from counts of character starts, a word
// at a time) and range's, copied shifted left with funnel shifts; a word
// at a time where every byte stays (a map that drops nothing: four
// lookups in a byte table a word; Length: a popcount of the character
// starts); byte by byte otherwise (a map that drops bytes, Reverse,
// InitCap: SmemReader, SmemWriter). The tail is zeroed, the tile goes back
// with coalesced vec-byte stores, and each thread writes its rows'
// out_len. Rows wider than a 32-row tile's 48 KB allows (about 1,500
// bytes, 750 for Reverse) take the row route: a thread a row over device
// memory, 8 bytes a load and a store (RowReader, RowWriter).
//
// Measured on the H100 (PERF.md): a group of 4-byte lanes a row, with
// scans and reductions across the lanes, lost to its per-row shuffles
// (trim 3.41 ms, substring over the region rows 2.61; the one-thread-a-row
// kernel over device memory before it 9.43 and 0.81); a thread a row with
// separate input and output tiles and a byte at a time held 6 blocks an
// SM (trim 2.28); in place, 1.63; words where the run allows, 1.32.
// The plain PyTorch version is expr/strings.py _rewrite_plain and
// _char_count_plain.

#include "strings.cuh"

namespace srtpu {

enum RewriteKind { kMap = 0, kChars = 1, kTrim = 2, kRange = 3,
                   kReverse = 4, kInitCap = 5, kLength = 6 };

constexpr int kTileSmem = 48 * 1024;  // a tile's shared memory at most

// Reads one row in shared memory a 4-byte word at a time.
struct SmemReader {
  const uint32_t* row;
  int cur;
  uint32_t w;

  __device__ __forceinline__ explicit SmemReader(const uint8_t* base)
      : row(reinterpret_cast<const uint32_t*>(base)), cur(-1), w(0) {}

  __device__ __forceinline__ uint32_t operator[](int i) {
    const int wi = i >> 2;
    if (wi != cur) {
      cur = wi;
      w = row[wi];
    }
    return (w >> ((i & 3) * 8)) & 0xFFu;
  }
};

// Writes one row in shared memory left to right a 4-byte word at a time
// and zeroes its words past the last at finish(); bytes past the width
// are dropped.
struct SmemWriter {
  uint32_t* row;
  int width;
  int pos;
  uint32_t w;

  __device__ __forceinline__ SmemWriter(uint8_t* base, int mb)
      : row(reinterpret_cast<uint32_t*>(base)), width(mb), pos(0), w(0) {}

  __device__ __forceinline__ void put(uint32_t b) {
    if (pos >= width) return;
    w |= (b & 0xFFu) << ((pos & 3) * 8);
    ++pos;
    if ((pos & 3) == 0) {
      row[(pos >> 2) - 1] = w;
      w = 0;
    }
  }

  __device__ __forceinline__ int finish() {
    const int n = pos;
    int wi = pos >> 2;
    if (pos & 3) row[wi++] = w;
    for (; wi < (width + 3) >> 2; ++wi) row[wi] = 0;
    return n;
  }
};

// Trim's kept run [first, last): the bytes between the leading (a != 0)
// and the trailing (b != 0) run of bytes whose table entry is negative.
template <class Rd>
__device__ __forceinline__ void trim_run(Rd& row, int len,
                                         const int16_t* tab, i64 a, i64 b,
                                         int& first, int& last) {
  first = 0;
  last = len;
  if (a != 0) {
    while (first < len && tab[row[first]] < 0) ++first;
  }
  if (b != 0) {
    last = 0;
    for (int i = len - 1; i >= first; --i)
      if (tab[row[i]] >= 0) {
        last = i + 1;
        break;
      }
  }
}

// the first nb (0-4) bytes of x, the rest 0
__device__ __forceinline__ uint32_t low_bytes(uint32_t x, int nb) {
  return nb >= 4 ? x : (x & ((1u << (8 * nb)) - 1u));
}

// bytes [s, s + 4) of a row of shared-memory words, at any s
__device__ __forceinline__ uint32_t word_at(const uint32_t* w, int s) {
  const int q = s >> 2, sh = s & 3;
  return sh == 0 ? w[q] : __funnelshift_r(w[q], w[q + 1], 8 * sh);
}

// out's bytes [0, last - first) = in's [first, last), its words up to
// `words` past them 0; in place (out == in) too: word k is written after
// every read of in's words up to k
__device__ __forceinline__ int copy_run(const uint32_t* in, uint32_t* out,
                                        int first, int last, int words) {
  const int cnt = last > first ? last - first : 0;
  int k = 0;
  for (; 4 * k < cnt; ++k)
    out[k] = low_bytes(word_at(in, first + 4 * k), cnt - 4 * k);
  for (; k < words; ++k) out[k] = 0;
  return cnt;
}

// bit 7 of each of x's first nb bytes that starts a character (is not a
// continuation byte)
__device__ __forceinline__ uint32_t word_starts(uint32_t x, int nb) {
  const uint32_t cont = x & ~(x << 1) & 0x80808080u;
  return low_bytes(~cont & 0x80808080u, nb);
}

// the characters among x's first nb bytes
__device__ __forceinline__ int word_chars(uint32_t x, int nb) {
  return __popc(word_starts(x, nb));
}

// A row's 4-byte words (word q: bytes [4q, 4q + 4), little-endian) from
// shared memory, or composed from a byte reader (bytes at or past len
// read as 0).
struct SmemWords {
  const uint32_t* w;
  __device__ __forceinline__ uint32_t operator()(int q) const { return w[q]; }
};

template <class Rd>
struct ByteWords {
  Rd& row;
  int len;
  __device__ __forceinline__ uint32_t operator()(int q) const {
    uint32_t x = 0;
    for (int k = 0; k < 4 && 4 * q + k < len; ++k)
      x |= row[4 * q + k] << (8 * k);
    return x;
  }
};

// the byte where character k (0-based) of a row starts, len where the row
// has no character k
template <class Words>
__device__ __forceinline__ int char_pos(const Words& w, int len, i64 k) {
  for (int q = 0; 4 * q < len; ++q) {
    uint32_t st = word_starts(w(q), len - 4 * q);
    const int c = __popc(st);
    if (k < c) {
      for (int j = 0; j < (int)k; ++j) st &= st - 1;
      return 4 * q + ((__ffs(st) - 1) >> 3);
    }
    k -= c;
  }
  return len;
}

// Substring's kept run [first, last): the bytes of the characters
// [start, end) of Spark's substringSQL(a = pos, b = length), found from
// counts of character starts a word at a time; empty where last <= first.
template <class Words>
__device__ __forceinline__ void chars_run(const Words& w, int len, i64 a,
                                          i64 b, int& first, int& last) {
  i64 start_raw;
  if (a > 0) {
    start_raw = a - 1;
  } else if (a == 0) {
    start_raw = 0;
  } else {
    i64 nchars = 0;
    for (int q = 0; 4 * q < len; ++q) nchars += word_chars(w(q), len - 4 * q);
    start_raw = nchars + a;
  }
  const i64 end_char = start_raw + (b < (1LL << 30) ? b : (1LL << 30));
  const i64 start_char = start_raw > 0 ? start_raw : 0;
  if (end_char <= start_char) {
    first = last = 0;
    return;
  }
  first = char_pos(w, len, start_char);
  last = char_pos(w, len, end_char);
}

// One row by one thread: the kind's rule over `row` (a reader of its
// bytes) into `w` (a writer). Returns the bytes written (kLength: the
// characters, nothing written).
template <class Rd, class Wr>
__device__ __forceinline__ int rewrite_one(int kind, Rd& row, Wr& w,
                                           int len, const int16_t* tab,
                                           i64 a, i64 b, int lo_r,
                                           int hi_r) {
  if (kind == kLength) {
    int chars = 0;
    for (int i = 0; i < len; ++i) chars += !is_cont(row[i]);
    return chars;
  }
  if (kind == kMap) {
    for (int i = 0; i < len; ++i) {
      const int m = tab[row[i]];
      if (m >= 0) w.put((uint32_t)m);
    }
  } else if (kind == kChars || kind == kTrim || kind == kRange) {
    int first, last;
    if (kind == kChars) {
      chars_run(ByteWords<Rd>{row, len}, len, a, b, first, last);
    } else if (kind == kTrim) {
      trim_run(row, len, tab, a, b, first, last);
    } else {
      first = lo_r > 0 ? lo_r : 0;
      last = hi_r < len ? hi_r : len;
    }
    for (int i = first; i < last; ++i) w.put(row[i]);
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
  return w.finish();
}

struct RwArgs {
  int kind;
  const uint8_t* data;
  const int* lengths;
  i64 n;
  int mb;
  const int16_t* table;
  i64 a, b;
  const int* lo;
  const int* hi;
  uint8_t* out;
  int* out_len;
};

// one row's out_len: the rewritten count, the input's length for Reverse
// and InitCap (the reference keeps it)
__device__ __forceinline__ void put_len(const RwArgs& p, i64 r, int v) {
  if (p.out_len == nullptr) return;
  p.out_len[r] =
      (p.kind == kReverse || p.kind == kInitCap) ? p.lengths[r] : v;
}

// The tile's bytes from device memory into the pitched rows of shared
// memory in words of V (V divides mb, so a word is one row's), skipping
// words wholly past their row's length.
template <typename V>
__device__ __forceinline__ void copy_in(const uint8_t* __restrict__ src,
                                        uint8_t* tin, int nbytes, int mb,
                                        int pitch, const int* lens) {
  constexpr int kV = (int)sizeof(V);
  for (int w = threadIdx.x; w < nbytes / kV; w += blockDim.x) {
    const int o = w * kV, row = o / mb, col = o - row * mb;
    if (col >= lens[row]) continue;
    uint8_t* dst = tin + row * pitch + col;
    if constexpr (kV >= 4) {
      V v = __ldcs(reinterpret_cast<const V*>(src) + w);  // read once
      const uint32_t* u = reinterpret_cast<const uint32_t*>(&v);
#pragma unroll
      for (int k = 0; k < kV / 4; ++k)
        reinterpret_cast<uint32_t*>(dst)[k] = u[k];
    } else {
      *reinterpret_cast<V*>(dst) = reinterpret_cast<const V*>(src)[w];
    }
  }
}

template <typename V>
__device__ __forceinline__ void copy_out(const uint8_t* tout,
                                         uint8_t* __restrict__ dst,
                                         int nbytes, int mb, int pitch) {
  constexpr int kV = (int)sizeof(V);
  for (int w = threadIdx.x; w < nbytes / kV; w += blockDim.x) {
    const int o = w * kV, row = o / mb, col = o - row * mb;
    const uint8_t* src = tout + row * pitch + col;
    if constexpr (kV >= 4) {
      V v;
      uint32_t* u = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
      for (int k = 0; k < kV / 4; ++k)
        u[k] = reinterpret_cast<const uint32_t*>(src)[k];
      __stcs(reinterpret_cast<V*>(dst) + w, v);
    } else {
      reinterpret_cast<V*>(dst)[w] = *reinterpret_cast<const V*>(src);
    }
  }
}

// One tile row by its thread: a word at a time where the kept bytes are
// one run (trim's found byte by byte from either end, substring's by
// counting character starts a word at a time, range's given; then copied
// shifted) or every byte stays (a map that drops nothing, Length); else
// byte by byte (rewrite_one). `in` and `out` are the same row but for
// Reverse.
__device__ __forceinline__ int tile_row(const RwArgs& p, const int16_t* tab,
                                        const uint8_t* tab8, bool drops,
                                        uint8_t* in, uint8_t* out, int len,
                                        int words, i64 r) {
  const uint32_t* win = reinterpret_cast<const uint32_t*>(in);
  uint32_t* wout = reinterpret_cast<uint32_t*>(out);
  const int used = (len + 3) >> 2;  // words holding the row's bytes
  if (p.kind == kLength) {
    int chars = 0;
    for (int k = 0; k < used; ++k) chars += word_chars(win[k], len - 4 * k);
    return chars;
  }
  if (p.kind == kMap && !drops) {
    int k = 0;
    for (; k < used; ++k) {
      const uint32_t x = win[k];
      const uint32_t y = tab8[x & 0xFFu] | (uint32_t)tab8[(x >> 8) & 0xFFu]
                         << 8 | (uint32_t)tab8[(x >> 16) & 0xFFu] << 16 |
                         (uint32_t)tab8[x >> 24] << 24;
      wout[k] = low_bytes(y, len - 4 * k);
    }
    for (; k < words; ++k) wout[k] = 0;
    return len;
  }
  if (p.kind == kTrim || p.kind == kRange || p.kind == kChars) {
    int first, last;
    if (p.kind == kTrim) {
      SmemReader rd(in);
      trim_run(rd, len, tab, p.a, p.b, first, last);
    } else if (p.kind == kChars) {
      chars_run(SmemWords{win}, len, p.a, p.b, first, last);
    } else {
      first = p.lo[r] > 0 ? p.lo[r] : 0;
      last = p.hi[r] < len ? p.hi[r] : len;
    }
    return copy_run(win, wout, first, last, words);
  }
  SmemReader rd(in);
  SmemWriter wr(out, p.mb);
  return rewrite_one(p.kind, rd, wr, len, tab, p.a, p.b,
                     p.kind == kRange ? p.lo[r] : 0,
                     p.kind == kRange ? p.hi[r] : 0);
}

// shared memory: table [256] int16 | its low bytes [256] | lengths [R] |
// the tile | (Reverse) the output tile | 16 bytes of slack (word_at's
// second word), R = tile_rows rows of `pitch` bytes each, a thread every
// blockDim.x rows. Every kind but Reverse rewrites its row in place: its
// writer never passes its reader (one output byte at most a byte read,
// each word written once the reader has moved past it), and trim's and
// substring's scans read before any write.
__global__ void __launch_bounds__(128)
str_rewrite_tiles(RwArgs p, int tile_rows, int pitch, int vec) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int mb = p.mb, nt = blockDim.x, t = threadIdx.x;
  int16_t* tab = reinterpret_cast<int16_t*>(smem);
  uint8_t* tab8 = smem + 512;
  int* lens = reinterpret_cast<int*>(smem + 768);
  uint8_t* tin = smem + 768 + 4 * tile_rows;
  uint8_t* tout = p.kind == kReverse ? tin + tile_rows * pitch : tin;
  const i64 r0 = (i64)blockIdx.x * tile_rows;
  const int rows = (int)(p.n - r0 < tile_rows ? p.n - r0 : tile_rows);
  int neg = 0;
  if (p.table != nullptr)
    for (int i = t; i < 256; i += nt) {
      const int16_t v = p.table[i];
      tab[i] = v;
      tab8[i] = (uint8_t)v;
      neg |= v < 0;
    }
  for (int i = t; i < rows; i += nt) lens[i] = row_len(p.lengths, r0 + i, mb);
  const bool drops = __syncthreads_or(neg) != 0;
  const int nbytes = rows * mb;
  const uint8_t* src = p.data + r0 * mb;
  switch (vec) {
    case 16: copy_in<uint4>(src, tin, nbytes, mb, pitch, lens); break;
    case 8: copy_in<uint2>(src, tin, nbytes, mb, pitch, lens); break;
    case 4: copy_in<uint32_t>(src, tin, nbytes, mb, pitch, lens); break;
    case 2: copy_in<uint16_t>(src, tin, nbytes, mb, pitch, lens); break;
    default: copy_in<uint8_t>(src, tin, nbytes, mb, pitch, lens);
  }
  __syncthreads();
  const int words = (mb + 3) >> 2;
  for (int i = t; i < rows; i += nt) {
    const i64 r = r0 + i;
    put_len(p, r, tile_row(p, tab, tab8, drops, tin + i * pitch,
                           tout + i * pitch, lens[i], words, r));
  }
  if (p.kind == kLength) return;
  __syncthreads();
  uint8_t* dst = p.out + r0 * mb;
  switch (vec) {
    case 16: copy_out<uint4>(tout, dst, nbytes, mb, pitch); break;
    case 8: copy_out<uint2>(tout, dst, nbytes, mb, pitch); break;
    case 4: copy_out<uint32_t>(tout, dst, nbytes, mb, pitch); break;
    case 2: copy_out<uint16_t>(tout, dst, nbytes, mb, pitch); break;
    default: copy_out<uint8_t>(tout, dst, nbytes, mb, pitch);
  }
}

// A writer that drops everything (kLength on the row route).
struct NoWriter {
  __device__ __forceinline__ void put(uint32_t) {}
  __device__ __forceinline__ int finish() { return 0; }
};

// the row route (wide rows): a thread a row over device memory
__global__ void __launch_bounds__(kStrThreads)
str_rewrite_rows(RwArgs p) {
  __shared__ int16_t tab[256];
  if (p.table != nullptr)
    for (int i = threadIdx.x; i < 256; i += blockDim.x) tab[i] = p.table[i];
  __syncthreads();
  for (i64 r = (i64)blockIdx.x * blockDim.x + threadIdx.x; r < p.n;
       r += (i64)gridDim.x * blockDim.x) {
    const int len = row_len(p.lengths, r, p.mb);
    RowReader row(p.data, r, p.mb);
    const int lo = p.kind == kRange ? p.lo[r] : 0;
    const int hi = p.kind == kRange ? p.hi[r] : 0;
    int v;
    if (p.kind == kLength) {
      NoWriter w;
      v = rewrite_one(p.kind, row, w, len, tab, p.a, p.b, lo, hi);
    } else {
      RowWriter w(p.out, r, p.mb);
      v = rewrite_one(p.kind, row, w, len, tab, p.a, p.b, lo, hi);
    }
    put_len(p, r, v);
  }
}

}  // namespace srtpu

using namespace srtpu;

// data: [n, mb] uint8; lengths: [n] int32; table: [256] int16 (kMap,
// kTrim; null otherwise); lo/hi: [n] int32 (kRange); out: [n, mb] uint8
// (null for kLength); out_len: [n] int32, or null where the caller keeps
// the input's lengths. tile_rows, pitch, vec: the tile route's plan
// (expr/strings.py _rewrite_plan; tile_rows 0: the row route).
extern "C" int srtpu_str_rewrite(int kind, const void* data,
                                 const void* lengths, long long n, int mb,
                                 const void* table, long long a, long long b,
                                 const void* lo, const void* hi, void* out,
                                 void* out_len, int tile_rows, int pitch,
                                 int vec, int sm_count, void* stream) {
  if (n < 1 || mb < 1 || kind < kMap || kind > kLength ||
      ((kind == kMap || kind == kTrim) && table == nullptr) ||
      (kind == kRange && (lo == nullptr || hi == nullptr)) ||
      (kind == kLength ? out_len == nullptr : out == nullptr))
    return (int)cudaErrorInvalidValue;
  const RwArgs p = {kind, (const uint8_t*)data, (const int*)lengths, n, mb,
                    (const int16_t*)table, a, b, (const int*)lo,
                    (const int*)hi, (uint8_t*)out, (int*)out_len};
  cudaStream_t s = (cudaStream_t)stream;
  if (tile_rows == 0) {
    str_rewrite_rows<<<str_blocks(n, sm_count), kStrThreads, 0, s>>>(p);
    return (int)cudaGetLastError();
  }
  const uintptr_t addr = (uintptr_t)data | (uintptr_t)out;
  const long long smem =
      768 + 4LL * tile_rows +
      (kind == kReverse ? 2LL : 1LL) * tile_rows * pitch + 16;
  if (tile_rows < 32 || tile_rows > 1024 ||
      (tile_rows & (tile_rows - 1)) != 0 || pitch < mb ||
      (pitch & 3) != 0 || ((pitch >> 2) & 1) == 0 || smem > kTileSmem ||
      vec < 1 || vec > 16 || (vec & (vec - 1)) != 0 ||
      (addr & (vec - 1)) != 0 || mb % vec != 0)
    return (int)cudaErrorInvalidValue;
  const long long tiles = (n + tile_rows - 1) / tile_rows;
  str_rewrite_tiles<<<(unsigned)tiles, tile_rows < 128 ? tile_rows : 128,
                      (size_t)smem, s>>>(p, tile_rows, pitch, vec);
  return (int)cudaGetLastError();
}
