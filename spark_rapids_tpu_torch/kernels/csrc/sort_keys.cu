// K9: orderable key words, and a stable LSD radix sort of them.
//
// Replaces spark_rapids_tpu/ops/common.py:53 _float_orderable, :68
// _string_orderable, :96 orderable_keys (an elementwise chain that XLA
// compiles) and :175 sort_permutation (lax.sort(is_stable=True) over the
// key words plus an iota), and through them the build sort of
// spark_rapids_tpu/ops/joinops.py:59 build_side.
//
// Pack (srtpu_pack_keys): one thread per row writes every key word of the
// row, word-major ([nwords, n] int64): per column an optional null-rank
// word (0/1 by NULLS FIRST/LAST, 2 for dead rows), then the value words:
// sign-extended integers and codes, 0/1 booleans, the total-order bits of
// float64/float32 (NaN canonical, -0.0 folded into 0.0 when asked),
// strings as big-endian 4-byte words of the zero-padded bytes with the
// length last, a decimal(> 18)'s [n, 2] limbs as two words, the high limb
// and the low one with its sign bit flipped (spark_rapids_tpu/ops/
// common.py:140 over decimal128.py:238 orderable_limbs); null or dead
// rows' values are 0; descending is bitwise NOT
// of the values. A join side may instead lead with one rank word "some key
// is null or the row is dead" and write the all-keys-valid mask.
//
// Sort (srtpu_sort_words): the stable permutation that sorts the rows by
// (word 0, word 1, ...) as signed int64, the same unique permutation as a
// stable lax.sort. LSD radix sort over 8-bit digits, from the last word to
// the first and from the low digit to the high one:
//   1. one launch histograms all 8 digits of every word (order-free);
//   2. one launch per pass marks the digit constant (one bin holds every
//      row) or live and turns its histogram into bucket starts;
//   3. per word: gather the word through the current permutation into a
//      key buffer; per live digit: per-block digit counts, their scan
//      across blocks (one block per digit), and a stable scatter of
//      (key, row) pairs into the other buffer.
// Passes whose digit is constant launch and return at once: which buffer
// holds the current permutation is computed on the card from the pass
// flags, so the host never waits for them. q5's null-rank words have one
// live digit and its region codes one.
//
// Bound on the H100: bytes. A sort must read its key words once and write
// the int32 permutation: 12 bytes a row for one word, 6.7 us for 2^21 rows
// at 3.35 TB/s. Each live pass here moves the (key, row) pairs through
// device memory twice (about 36 bytes a row), and the digit's scatter to
// 256 buckets is poorly coalesced; sorts of small inputs are bound by
// their ~25 launches a word. Fewer passes (11-bit digits, onesweep) and a
// one-block path for small inputs are later work.

#include "common.cuh"

namespace srtpu {

// ------------------------------------------------------------------ pack

constexpr int kMaxPackCols = 16;

enum PackKind { PK_I8 = 0, PK_I16, PK_I32, PK_I64, PK_F32, PK_F64, PK_STR,
                PK_BOOL, PK_D128 };

struct PackCol {  // PackCol in kernels/__init__.py
  const void* data;
  const uint8_t* validity;
  const int* lengths;   // strings only
  int kind;
  int row_bytes;        // strings: bytes a row of `data`
  int word0;            // first output word of this column
  int with_rank;        // write the null-rank word first
  int descending;
  int nulls_first;
  int normalize_zero;   // -0.0 -> 0.0 before the bits
  int pad;
};

struct PackArgs {
  PackCol cols[kMaxPackCols];
  int ncols;
  int lead_rank;   // word 0 = some key null or row dead (join build side)
};

__device__ __forceinline__ i64 f64_key(i64 b, bool normz) {
  const unsigned long long u = (unsigned long long)b;
  if (normz && (u << 1) == 0ull) return 0;            // -0.0 == 0.0
  if ((u & 0x7FFFFFFFFFFFFFFFull) > 0x7FF0000000000000ull)
    return 0x7FF8000000000000LL;                      // canonical NaN
  return b < 0 ? (i64)(u ^ 0x7FFFFFFFFFFFFFFFull) : b;
}

__device__ __forceinline__ i64 f32_key(int b, bool normz) {
  const unsigned u = (unsigned)b;
  if (normz && (u << 1) == 0u) return 0;
  if ((u & 0x7FFFFFFFu) > 0x7F800000u) return 0x7FC00000LL;
  return b < 0 ? (i64)(int)(u ^ 0x7FFFFFFFu) : (i64)b;
}

__global__ void __launch_bounds__(kThreads)
pack_kernel(PackArgs a, const uint8_t* __restrict__ live, i64 n,
            i64* __restrict__ words, uint8_t* __restrict__ all_valid) {
  for (i64 i = (i64)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (i64)gridDim.x * kThreads) {
    const bool lv = live[i] != 0;
    bool all = lv;
    for (int c = 0; c < a.ncols; ++c) {
      const PackCol& col = a.cols[c];
      const bool valid = col.validity[i] != 0;
      all = all && valid;
      i64* out = words + (i64)col.word0 * n + i;
      if (col.with_rank) {
        *out = lv ? (i64)(col.nulls_first ? valid : !valid) : 2;
        out += n;
      }
      const bool use = valid && lv;
      const i64 flip = col.descending ? -1 : 0;  // x ^ -1 == ~x
      switch (col.kind) {
        case PK_STR: {
          const uint8_t* row = (const uint8_t*)col.data + i * col.row_bytes;
          const int nw = (col.row_bytes + 3) / 4;
          for (int w = 0; w < nw; ++w) {
            i64 v = 0;
            if (use) {
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                const int at = 4 * w + k;
                const i64 byte = at < col.row_bytes ? row[at] : 0;
                v |= byte << (24 - 8 * k);
              }
            }
            *out = v ^ flip;
            out += n;
          }
          *out = (use ? (i64)col.lengths[i] : 0) ^ flip;
          break;
        }
        case PK_D128: {
          const i64* limbs = (const i64*)col.data + 2 * i;
          *out = (use ? limbs[0] : 0) ^ flip;
          out += n;
          *out = (use ? (i64)((unsigned long long)limbs[1] ^
                              0x8000000000000000ull)
                      : 0) ^ flip;
          break;
        }
        case PK_F64: {
          const i64 b = ((const i64*)col.data)[i];
          *out = (use ? f64_key(b, col.normalize_zero) : 0) ^ flip;
          break;
        }
        case PK_F32: {
          const int b = ((const int*)col.data)[i];
          *out = (use ? f32_key(b, col.normalize_zero) : 0) ^ flip;
          break;
        }
        default: {
          i64 v;
          switch (col.kind) {
            case PK_I8: v = ((const int8_t*)col.data)[i]; break;
            case PK_I16: v = ((const int16_t*)col.data)[i]; break;
            case PK_I32: v = ((const int*)col.data)[i]; break;
            case PK_BOOL: v = ((const uint8_t*)col.data)[i] != 0; break;
            default: v = ((const i64*)col.data)[i]; break;
          }
          *out = (use ? v : 0) ^ flip;
        }
      }
    }
    if (a.lead_rank) words[i] = all ? 0 : 1;
    if (all_valid != nullptr) all_valid[i] = all;
  }
}

// ------------------------------------------------------------------ sort

constexpr int kDigits = 256;
constexpr int kPassesPerWord = 8;
constexpr int kMaxSortBlocks = 1024;
constexpr int kHistBlocks = 264;  // 2 per SM of the H100
constexpr unsigned long long kSign = 0x8000000000000000ull;

struct SortLayout {
  int nwords, n, rows_per_block, nblocks;
  size_t keys, perm1, hist, live, start, counts, offsets, total;
};

inline size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

inline SortLayout sort_layout(int nwords, int n) {
  SortLayout L;
  L.nwords = nwords;
  L.n = n;
  const int per = (n + kMaxSortBlocks - 1) / kMaxSortBlocks;
  int r = ((per + kThreads - 1) / kThreads) * kThreads;
  L.rows_per_block = r < kTile ? kTile : r;
  L.nblocks = (n + L.rows_per_block - 1) / L.rows_per_block;
  const int passes = nwords * kPassesPerWord;
  size_t at = 0;
  L.keys = at;    at = align16(at + 2 * (size_t)n * 8);
  L.perm1 = at;   at = align16(at + (size_t)n * 4);
  L.hist = at;    at = align16(at + (size_t)passes * kDigits * 4);
  L.live = at;    at = align16(at + (size_t)passes * 4);
  L.start = at;   at = align16(at + (size_t)passes * kDigits * 4);
  L.counts = at;  at = align16(at + (size_t)kDigits * L.nblocks * 4);
  L.offsets = at; at = align16(at + (size_t)kDigits * L.nblocks * 4);
  L.total = at;
  return L;
}

// Passes run words nwords-1 .. 0, digits 0 .. 7; each live pass flips the
// buffer holding the current permutation. Parity before pass (w, d); w = -1
// gives the parity after every pass.
__device__ int parity_before(const int* __restrict__ live, int nwords, int w,
                             int d) {
  int c = 0;
  for (int x = nwords - 1; x > w; --x)
    for (int y = 0; y < kPassesPerWord; ++y) c += live[x * kPassesPerWord + y];
  if (w >= 0)
    for (int y = 0; y < d; ++y) c += live[w * kPassesPerWord + y];
  return c & 1;
}

__device__ __forceinline__ int block_parity(const int* live, int nwords,
                                            int w, int d) {
  __shared__ int s;
  if (threadIdx.x == 0) s = parity_before(live, nwords, w, d);
  __syncthreads();
  return s;
}

// digit histograms of all 8 digit positions of word blockIdx.y
__global__ void __launch_bounds__(kThreads)
global_hist_kernel(const i64* __restrict__ words, int n,
                   int* __restrict__ hist) {
  __shared__ int h[kPassesPerWord][kDigits];
  for (int t = threadIdx.x; t < kPassesPerWord * kDigits; t += kThreads)
    (&h[0][0])[t] = 0;
  __syncthreads();
  const int w = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const i64 stride = (i64)gridDim.x * kThreads;
  for (i64 base = (i64)blockIdx.x * kThreads; base < n; base += stride) {
    const i64 i = base + threadIdx.x;
    const bool in = i < n;
    const unsigned long long k =
        in ? ((unsigned long long)words[(i64)w * n + i]) ^ kSign : 0ull;
#pragma unroll
    for (int d = 0; d < kPassesPerWord; ++d) {
      const int dig = in ? (int)((k >> (8 * d)) & 255) : kDigits;
      const unsigned peers = __match_any_sync(kFull, dig);
      if (in && lane == __ffs(peers) - 1) atomicAdd(&h[d][dig], __popc(peers));
    }
  }
  __syncthreads();
  int* g = hist + (size_t)w * kPassesPerWord * kDigits;
  for (int t = threadIdx.x; t < kPassesPerWord * kDigits; t += kThreads) {
    const int v = (&h[0][0])[t];
    if (v) atomicAdd(&g[t], v);
  }
}

// per pass (one block each): live flag and bucket starts
__global__ void __launch_bounds__(kDigits)
plan_kernel(const int* __restrict__ hist, int n, int* __restrict__ live,
            int* __restrict__ start) {
  __shared__ int warp_tot[kDigits / 32];
  __shared__ int any_full;
  const int p = blockIdx.x;
  const int c = hist[(size_t)p * kDigits + threadIdx.x];
  if (threadIdx.x == 0) any_full = 0;
  __syncthreads();
  if (c == n) any_full = 1;
  int total;
  const int ex = block_exclusive_scan<int, kDigits / 32>(c, warp_tot, total);
  start[(size_t)p * kDigits + threadIdx.x] = ex;
  __syncthreads();
  if (threadIdx.x == 0) live[p] = any_full ? 0 : 1;
}

__global__ void __launch_bounds__(kThreads)
iota_kernel(int* __restrict__ perm, int n) {
  for (i64 i = (i64)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (i64)gridDim.x * kThreads)
    perm[i] = (int)i;
}

// keys[s][i] = word w of row perm[s][i], sign bit flipped (unsigned order)
__global__ void __launch_bounds__(kThreads)
gather_word_kernel(const i64* __restrict__ words, int n, int nwords, int w,
                   const int* __restrict__ live, int* perm0, int* perm1,
                   unsigned long long* keys) {
  __shared__ int any;
  if (threadIdx.x == 0) {
    int a = 0;
    for (int d = 0; d < kPassesPerWord; ++d) a |= live[w * kPassesPerWord + d];
    any = a;
  }
  __syncthreads();
  if (!any) return;
  const int s = block_parity(live, nwords, w, 0);
  const int* perm = s ? perm1 : perm0;
  unsigned long long* k = keys + (size_t)s * n;
  const i64* word = words + (i64)w * n;
  for (i64 i = (i64)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (i64)gridDim.x * kThreads)
    k[i] = ((unsigned long long)word[perm[i]]) ^ kSign;
}

// counts[dig][b]: rows of block b's range whose digit is dig
__global__ void __launch_bounds__(kThreads)
block_hist_kernel(int n, int nwords, int w, int d, int rows_per_block,
                  int nblocks, const int* __restrict__ live,
                  const unsigned long long* keys, int* __restrict__ counts) {
  if (!live[w * kPassesPerWord + d]) return;
  __shared__ int h[kDigits];
  h[threadIdx.x] = 0;
  const int s = block_parity(live, nwords, w, d);  // syncs
  const unsigned long long* k = keys + (size_t)s * n;
  const int lane = threadIdx.x & 31;
  const i64 lo = (i64)blockIdx.x * rows_per_block;
  const i64 hi = lo + rows_per_block < n ? lo + rows_per_block : n;
  for (i64 base = lo; base < hi; base += kThreads) {
    const i64 i = base + threadIdx.x;
    const bool in = i < hi;
    const int dig = in ? (int)((k[i] >> (8 * d)) & 255) : kDigits;
    const unsigned peers = __match_any_sync(kFull, dig);
    if (in && lane == __ffs(peers) - 1) atomicAdd(&h[dig], __popc(peers));
  }
  __syncthreads();
  counts[(size_t)threadIdx.x * nblocks + blockIdx.x] = h[threadIdx.x];
}

// offsets[dig][b] = start[dig] + rows of digit dig in blocks before b
__global__ void __launch_bounds__(kScanThreads)
block_offsets_kernel(int nwords, int w, int d, int nblocks,
                     const int* __restrict__ live,
                     const int* __restrict__ start,
                     const int* __restrict__ counts,
                     int* __restrict__ offsets) {
  const int p = w * kPassesPerWord + d;
  if (!live[p]) return;
  __shared__ int warp_tot[kScanThreads / 32];
  const int dig = blockIdx.x;
  const int b = threadIdx.x;
  const int v = b < nblocks ? counts[(size_t)dig * nblocks + b] : 0;
  int total;
  const int ex =
      block_exclusive_scan<int, kScanThreads / 32>(v, warp_tot, total);
  if (b < nblocks)
    offsets[(size_t)dig * nblocks + b] = start[(size_t)p * kDigits + dig] + ex;
}

// stable scatter of (key, row) pairs by digit d of word w
__global__ void __launch_bounds__(kThreads)
scatter_kernel(int n, int nwords, int w, int d, int rows_per_block,
               int nblocks, const int* __restrict__ live,
               const int* __restrict__ offsets, unsigned long long* keys,
               int* perm0, int* perm1) {
  if (!live[w * kPassesPerWord + d]) return;
  __shared__ int run[kDigits];
  __shared__ int wcnt[kWarps][kDigits];
  run[threadIdx.x] = offsets[(size_t)threadIdx.x * nblocks + blockIdx.x];
#pragma unroll
  for (int x = 0; x < kWarps; ++x) wcnt[x][threadIdx.x] = 0;
  const int s = block_parity(live, nwords, w, d);  // syncs
  const unsigned long long* kin = keys + (size_t)s * n;
  unsigned long long* kout = keys + (size_t)(1 - s) * n;
  const int* pin = s ? perm1 : perm0;
  int* pout = s ? perm0 : perm1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;
  const i64 lo = (i64)blockIdx.x * rows_per_block;
  const i64 hi = lo + rows_per_block < n ? lo + rows_per_block : n;
  for (i64 base = lo; base < hi; base += kThreads) {
    const i64 i = base + threadIdx.x;
    const bool in = i < hi;
    unsigned long long key = 0;
    int row = 0, dig = kDigits;
    if (in) {
      key = kin[i];
      row = pin[i];
      dig = (int)((key >> (8 * d)) & 255);
    }
    const unsigned peers = __match_any_sync(kFull, dig);
    if (in && lane == __ffs(peers) - 1) wcnt[warp][dig] = __popc(peers);
    __syncthreads();
    if (in) {
      int before = 0;
      for (int x = 0; x < warp; ++x) before += wcnt[x][dig];
      const int pos = run[dig] + before + __popc(peers & lanes_below);
      kout[pos] = key;
      pout[pos] = row;
    }
    __syncthreads();
    int tot = 0;
#pragma unroll
    for (int x = 0; x < kWarps; ++x) {
      tot += wcnt[x][threadIdx.x];
      wcnt[x][threadIdx.x] = 0;
    }
    run[threadIdx.x] += tot;
    __syncthreads();
  }
}

// the permutation ends in perm1 after an odd number of live passes
__global__ void __launch_bounds__(kThreads)
final_copy_kernel(int n, int nwords, const int* __restrict__ live,
                  int* __restrict__ perm0, const int* __restrict__ perm1) {
  if (!block_parity(live, nwords, -1, 0)) return;
  for (i64 i = (i64)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (i64)gridDim.x * kThreads)
    perm0[i] = perm1[i];
}

inline int grid_for(i64 n, int sm_count) {
  const i64 want = (n + kThreads - 1) / kThreads;
  const i64 cap = (i64)sm_count * 8;
  return (int)(want < cap ? (want > 0 ? want : 1) : cap);
}

}  // namespace srtpu

using namespace srtpu;

// cols: ncols PackCol (host memory); live: [n] bool; words: [nwords, n]
// int64; all_valid: [n] bool or null.
extern "C" int srtpu_pack_keys(const void* cols, int ncols, int lead_rank,
                               const void* live, long long n, void* words,
                               void* all_valid, int sm_count,
                               void* stream) {
  if (ncols > kMaxPackCols) return (int)cudaErrorInvalidValue;
  PackArgs a;
  for (int c = 0; c < ncols; ++c) a.cols[c] = ((const PackCol*)cols)[c];
  a.ncols = ncols;
  a.lead_rank = lead_rank;
  pack_kernel<<<grid_for(n, sm_count), kThreads, 0, (cudaStream_t)stream>>>(
      a, (const uint8_t*)live, n, (i64*)words, (uint8_t*)all_valid);
  return (int)cudaGetLastError();
}

extern "C" long long srtpu_sort_scratch_bytes(int nwords, int n) {
  return (long long)sort_layout(nwords, n).total;
}

// words: [nwords, n] int64; perm: [n] int32 out; scratch: bytes from
// srtpu_sort_scratch_bytes.
extern "C" int srtpu_sort_words(const void* words, int nwords, int n,
                                void* perm, void* scratch, int sm_count,
                                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const SortLayout L = sort_layout(nwords, n);
  char* base = (char*)scratch;
  unsigned long long* keys = (unsigned long long*)(base + L.keys);
  int* perm0 = (int*)perm;
  int* perm1 = (int*)(base + L.perm1);
  int* hist = (int*)(base + L.hist);
  int* live = (int*)(base + L.live);
  int* start = (int*)(base + L.start);
  int* counts = (int*)(base + L.counts);
  int* offsets = (int*)(base + L.offsets);
  const i64* w64 = (const i64*)words;
  const int passes = nwords * kPassesPerWord;
  const int grid = grid_for(n, sm_count);
  cudaError_t e = cudaMemsetAsync(
      hist, 0, (size_t)passes * kDigits * sizeof(int), st);
  if (e != cudaSuccess) return (int)e;
  int hb = (n + kThreads - 1) / kThreads;
  if (hb > kHistBlocks) hb = kHistBlocks;
  global_hist_kernel<<<dim3(hb, nwords), kThreads, 0, st>>>(w64, n, hist);
  plan_kernel<<<passes, kDigits, 0, st>>>(hist, n, live, start);
  iota_kernel<<<grid, kThreads, 0, st>>>(perm0, n);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  for (int w = nwords - 1; w >= 0; --w) {
    gather_word_kernel<<<grid, kThreads, 0, st>>>(w64, n, nwords, w, live,
                                                 perm0, perm1, keys);
    for (int d = 0; d < kPassesPerWord; ++d) {
      block_hist_kernel<<<L.nblocks, kThreads, 0, st>>>(
          n, nwords, w, d, L.rows_per_block, L.nblocks, live, keys, counts);
      block_offsets_kernel<<<kDigits, kScanThreads, 0, st>>>(
          nwords, w, d, L.nblocks, live, start, counts, offsets);
      scatter_kernel<<<L.nblocks, kThreads, 0, st>>>(
          n, nwords, w, d, L.rows_per_block, L.nblocks, live, offsets, keys,
          perm0, perm1);
    }
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  final_copy_kernel<<<grid, kThreads, 0, st>>>(n, nwords, live, perm0, perm1);
  return (int)cudaGetLastError();
}
