// Row readers and the packed-window compare shared by the window-check
// kernels (dual_compare.cu, window_compare.cu, window_staged.cu), the
// staged row windows of window_staged.cu and of the ring of tiles
// (tile_ring.cuh), and the tiles of column inputs of that ring.
//
// Reads are 2-bit bases packed 16 to a uint32 word, base i in bits
// [30 - 2(i%16), 32 - 2(i%16)) of word i/16.  A word index outside the row
// reads as 0: the TPU kernels zero-fill their word rolls
// (disco_tpu/overlap/fused_kernel.py::_roll_up).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace disco {

constexpr int kThreads = 256;

// Word w of pair p's row held as a column of a (W, P) array.
struct ColumnRow {
  const uint32_t* col;  // &x[0 * P + p]
  int64_t stride;       // P
  int words;            // W
  __device__ __forceinline__ uint32_t operator()(int w) const {
    return static_cast<unsigned>(w) < static_cast<unsigned>(words)
               ? __ldg(col + static_cast<int64_t>(w) * stride)
               : 0u;
  }
};

// Word w of one row of a row-major (R, Wp) table.
struct TableRow {
  const uint32_t* row;
  int words;            // Wp, or 0 for a row index outside the table
  __device__ __forceinline__ uint32_t operator()(int w) const {
    return static_cast<unsigned>(w) < static_cast<unsigned>(words)
               ? __ldg(row + w)
               : 0u;
  }
};

// Row r of a row-major (n_rows, words) table; an index outside the table
// gives a row of zeros.
__device__ __forceinline__ TableRow table_row(const uint32_t* table,
                                              int64_t n_rows, int words,
                                              int64_t r) {
  const bool in_table = r >= 0 && r < n_rows;
  return TableRow{table + (in_table ? r * words : 0), in_table ? words : 0};
}

// a[d1 words + s1 bits ...] == b[d2 words + s2 bits ...] over n bases; a
// length of 0 or less gives true without reading any row word.  Word wi of
// a window is the top 32 bits of (row[d + wi] : row[d + wi + 1]) << s,
// s in 0..31 (s == 0 gives row[d + wi]); the last partial word is masked.
// The compare stops at the first mismatching word.
template <class A, class B>
__device__ __forceinline__ bool window_equal_at(const A& a, int d1, int s1,
                                                const B& b, int d2, int s2,
                                                int n) {
  if (n <= 0) return true;
  uint32_t a_cur = a(d1), b_cur = b(d2);
  for (int wi = 0, rem = n; rem > 0; ++wi, rem -= 16) {
    const uint32_t a_nxt = a(d1 + wi + 1), b_nxt = b(d2 + wi + 1);
    const uint32_t x = __funnelshift_l(a_nxt, a_cur, s1);
    const uint32_t y = __funnelshift_l(b_nxt, b_cur, s2);
    const uint32_t mask =
        rem >= 16 ? 0xFFFFFFFFu : (0xFFFFFFFFu << (2 * (16 - rem)));
    if ((x ^ y) & mask) return false;
    a_cur = a_nxt;
    b_cur = b_nxt;
  }
  return true;
}

// a@o1 == b@o2 over n bases, base offsets split as o >> 4 (word) and
// (o & 15) << 1 (bit phase), as in fused_kernel.py::_split_off.
template <class A, class B>
__device__ __forceinline__ bool window_equal(const A& a, int o1, const B& b,
                                             int o2, int n) {
  return window_equal_at(a, o1 >> 4, (o1 & 15) << 1, b, o2 >> 4,
                         (o2 & 15) << 1, n);
}

inline unsigned blocks_for(int64_t P) {
  return static_cast<unsigned>((P + kThreads - 1) / kThreads);
}

// ---------------------------------------------------------------------------
// A staged row window (window_staged.cu): one block's rows of a row-major
// (n_rows, wt) table, copied into shared memory before its pairs read them.
//
// Rows [base, base + rows), words [0, ws) of each, lie at smem[k * stride],
// stride = ws | 1.  The odd stride puts word w of 32 consecutive rows on 32
// different banks (a stride of 32 words would put them all on one).  The
// copy is cp.async 4 B at a time, neighbouring threads on neighbouring
// words: the 16-B form needs 16-B aligned rows, which an odd stride breaks.
// A row outside the window, or a word at or past ws of a staged row, is read
// from device memory, so a read is exact for every row index; each row read
// outside the window is counted.
constexpr int kTilePairs = 1024;   // pairs per block, kThreads threads

__device__ __forceinline__ void cp_async4(uint32_t* dst, const uint32_t* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) {
  return a > b ? a : b;
}

struct RowWindow {
  uint32_t* smem;
  int64_t base;  // first staged row
  int rows;      // rows staged
  int ws;        // words staged per row
  int stride;    // ws | 1
};

// The window of up to `cap` rows from row `first`, cut to the table, with
// only rows [first, last] staged; every thread of the block calls this and
// then syncs (`stage_rows`).
__device__ __forceinline__ RowWindow row_window(uint32_t* smem, int64_t first,
                                                int64_t last, int cap,
                                                int64_t n_rows, int ws) {
  const int64_t lo = max64(first, 0);
  const int64_t hi = min64(min64(first + cap, last + 1), n_rows);
  return RowWindow{smem, lo, static_cast<int>(max64(hi - lo, 0)), ws,
                   ws | 1};
}

// Start the block's cp.async copies of `w` (no wait).
__device__ __forceinline__ void stage_rows(const RowWindow& w,
                                           const uint32_t* table, int wt) {
  const int total = w.rows * w.ws;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int k = i / w.ws, c = i - k * w.ws;
    cp_async4(w.smem + k * w.stride + c, table + (w.base + k) * wt + c);
  }
}

// stage_rows with no division for each copy: thread i starts at word i of
// the window's rows laid end to end and steps blockDim.x words, carrying
// its row and column (a block does not divide into 17-word rows, and a
// division by a width known only at run time is a sequence of
// instructions, where the step is two adds).
__device__ __forceinline__ void stage_rows_stepped(const RowWindow& w,
                                                   const uint32_t* table,
                                                   int wt) {
  const int total = w.rows * w.ws;
  int i = threadIdx.x;
  if (i >= total) return;
  const int T = blockDim.x;
  const int dk = T / w.ws, dc = T - dk * w.ws;
  int k = i / w.ws, c = i - k * w.ws;
  uint32_t* dst = w.smem + k * w.stride + c;
  const uint32_t* src = table + (w.base + k) * wt + c;
  const int64_t src_step = static_cast<int64_t>(dk) * wt + dc;
  const int dst_step = dk * w.stride + dc;
  for (; i < total; i += T) {
    cp_async4(dst, src);
    dst += dst_step;
    src += src_step;
    c += dc;
    if (c >= w.ws) {        // into the next row
      c -= w.ws;
      dst += w.stride - w.ws;
      src += wt - w.ws;
    }
  }
}

// Word w of one row: the staged copy for w < ws, device memory for
// ws <= w < words, 0 past `words` (the compared width) or for a row outside
// the table.
struct StagedRow {
  const uint32_t* s;  // the staged row (ws = 0: not staged)
  const uint32_t* g;  // the row in device memory
  int ws;
  int words;
  __device__ __forceinline__ uint32_t operator()(int w) const {
    const unsigned u = static_cast<unsigned>(w);
    if (u < static_cast<unsigned>(ws)) return s[w];
    return u < static_cast<unsigned>(words) ? __ldg(g + w) : 0u;
  }
};

// Row r of the table (`words` of its wt words compared), from window `w`
// when it lies there; a row read outside the window adds one to `misses`.
__device__ __forceinline__ StagedRow staged_row(const RowWindow& w,
                                                const uint32_t* table,
                                                int64_t n_rows, int wt,
                                                int words, int64_t r,
                                                int& misses) {
  const bool in_table = r >= 0 && r < n_rows;
  const int64_t k = r - w.base;
  const bool staged = k >= 0 && k < w.rows;
  misses += !staged;
  return StagedRow{staged ? w.smem + k * w.stride : nullptr,
                   table + (in_table ? r * wt : 0),
                   staged ? min(w.ws, words) : 0, in_table ? words : 0};
}

// staged_row for a caller that counts its misses itself.  Built on
// staged_row and not the other way round: that cost T3's kernel two
// registers.
__device__ __forceinline__ StagedRow staged_row_at(const RowWindow& w,
                                                   const uint32_t* table,
                                                   int64_t n_rows, int wt,
                                                   int words, int64_t r) {
  int unused = 0;
  return staged_row(w, table, n_rows, wt, words, r, unused);
}

// Block-wide min and max of one int64 a thread (kThreads threads); every
// thread gets both.  `scratch` holds 2 * kThreads / 32 int64.
__device__ __forceinline__ void block_min_max(int64_t v_min, int64_t v_max,
                                              int64_t* scratch, int64_t& lo,
                                              int64_t& hi) {
  for (int o = 16; o > 0; o >>= 1) {
    v_min = min64(v_min, __shfl_xor_sync(0xFFFFFFFFu, v_min, o));
    v_max = max64(v_max, __shfl_xor_sync(0xFFFFFFFFu, v_max, o));
  }
  constexpr int kWarps = kThreads / 32;
  if ((threadIdx.x & 31) == 0) {
    scratch[threadIdx.x / 32] = v_min;
    scratch[kWarps + threadIdx.x / 32] = v_max;
  }
  __syncthreads();
  lo = scratch[0];
  hi = scratch[kWarps];
  for (int i = 1; i < kWarps; ++i) {
    lo = min64(lo, scratch[i]);
    hi = max64(hi, scratch[kWarps + i]);
  }
}

// Adds the block's per-thread counts into *total: one atomic per warp.
__device__ __forceinline__ void add_count(int n,
                                          unsigned long long* total) {
  const unsigned s = __reduce_add_sync(0xFFFFFFFFu, static_cast<unsigned>(n));
  if ((threadIdx.x & 31) == 0 && s) atomicAdd(total, s);
}

// ---------------------------------------------------------------------------
// A tile of column inputs in shared memory (window_compare.cu: K3, K4).
//
// A tile is T = blockDim.x consecutive pairs [p0, p0 + T), T a multiple of
// 32.  Word rows [lo, lo + rows) of a (W, P) column input, columns
// [p0, p0 + T), lie at s[(w - lo) * T + (p - p0)], so the 32 threads of a
// warp, each reading some word of its own column, read 32 banks.
struct TileRows {
  int lo;    // first staged word row
  int rows;  // rows staged (0: none)
};

// The least `lo` and greatest `hi` over a tile's pairs (lo > hi: none).
struct TileSpan {
  int lo, hi;
};

// The span of no pair: lo > hi, and a min/max over pairs starts from it.
__device__ __forceinline__ TileSpan no_span() {
  return TileSpan{0x7FFFFFFF, static_cast<int>(0x80000000u)};
}

// The words window_equal_at reads of a row for a window of n bases at base
// offset o: o >> 4 to (o >> 4) + ceil(n / 16), its one-past word included.
// A pair with n <= 0, or not `live`, reads none: INT_MAX and INT_MIN.
__device__ __forceinline__ TileSpan pair_words(int o, int n, bool live) {
  return live && n > 0
             ? TileSpan{o >> 4, (o >> 4) + (n >> 4) + ((n & 15) != 0)}
             : no_span();
}

// Block-wide least lo and greatest hi of each of K spans (every thread gets
// them).  `scratch` holds 2 * K * 32 ints; every thread of the block calls
// this, and it syncs once.
template <int K>
__device__ __forceinline__ void tile_spans(const TileSpan (&mine)[K],
                                           int* scratch,
                                           TileSpan (&out)[K]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int l = __reduce_min_sync(0xFFFFFFFFu, mine[k].lo);
    const int h = __reduce_max_sync(0xFFFFFFFFu, mine[k].hi);
    if (lane == 0) {
      scratch[(2 * k) * 32 + warp] = l;
      scratch[(2 * k + 1) * 32 + warp] = h;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    int l = 0x7FFFFFFF, h = static_cast<int>(0x80000000u);
    for (int i = 0; i < warps; ++i) {
      l = min(l, scratch[(2 * k) * 32 + i]);
      h = max(h, scratch[(2 * k + 1) * 32 + i]);
    }
    out[k] = TileSpan{l, h};
  }
}

// The word rows of a (words, P) column input to stage for a tile whose
// windows read the words of span s (pair_words): s cut to [0, words).  A
// word outside the row reads as 0 without being staged, so these are all
// the words the tile's compares read from the input.
__device__ __forceinline__ TileRows tile_rows(TileSpan s, int words) {
  const int l = max(s.lo, 0), h = min(s.hi, words - 1);
  return TileRows{l, h >= l ? h - l + 1 : 0};
}

__device__ __forceinline__ void cp_async16(uint32_t* dst, const uint32_t* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start (no wait) the block's copies of rows r of a (W, P) column input,
// columns [p0, p0 + T), into s.  Thread i takes the 16-B chunk i % (T / 4)
// of every fourth row from row i / (T / 4): one 16-B cp.async.cg where the
// source is 16-B aligned and the chunk lies inside [0, P), else a 4-B copy
// for each of its columns inside [0, P) (rows of a P % 4 != 0 input start
// misaligned; the last tile ends at P).  Columns past P are not copied:
// their pairs are not compared.
__device__ __forceinline__ void stage_columns(uint32_t* s, const uint32_t* x,
                                              int64_t P, int64_t p0,
                                              TileRows r) {
  const int T = blockDim.x, chunks = T >> 2;
  const int c = 4 * (static_cast<int>(threadIdx.x) % chunks);
  const int64_t left = P - p0 - c;
  int i = static_cast<int>(threadIdx.x) / chunks;
  if (i >= r.rows) return;
  const uint32_t* src = x + static_cast<int64_t>(r.lo + i) * P + p0 + c;
  uint32_t* dst = s + i * T + c;
  for (; i < r.rows; i += 4, src += 4 * P, dst += 4 * T) {
    if (left >= 4 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      cp_async16(dst, src);
    } else {
      for (int k = 0; k < 4 && k < left; ++k) cp_async4(dst + k, src + k);
    }
  }
}

// window_equal_at for n > 0 over words that all lie in shared memory: word
// d + i of a at pa[i * step_a] (pa = word d1), of b at pb[i * step_b], for
// i = 0 .. ceil(n / 16), its one-past word included.  The same compares in
// the same order, without the readers' bounds checks, and with the partial
// mask only on the last word.
__device__ __forceinline__ bool staged_window_equal(const uint32_t* pa,
                                                    int step_a, int s1,
                                                    const uint32_t* pb,
                                                    int step_b, int s2,
                                                    int n) {
  uint32_t a_cur = *pa, b_cur = *pb;
  int rem = n;
  for (; rem > 16; rem -= 16) {
    pa += step_a;
    pb += step_b;
    const uint32_t a_nxt = *pa, b_nxt = *pb;
    if (__funnelshift_l(a_nxt, a_cur, s1) != __funnelshift_l(b_nxt, b_cur, s2))
      return false;
    a_cur = a_nxt;
    b_cur = b_nxt;
  }
  const uint32_t mask = 0xFFFFFFFFu << (2 * (16 - rem));
  return ((__funnelshift_l(pa[step_a], a_cur, s1) ^
           __funnelshift_l(pb[step_b], b_cur, s2)) & mask) == 0;
}

// staged_window_equal for two rows at stride 1 and a window of at most
// kMax compared words (n <= 16 kMax): every word is read and compared
// without an early exit, the loop unrolled, so that a thread's shared
// loads do not each wait on the compare before them (with the early exit,
// each word cost a shared-memory latency).
template <int kMax>
__device__ __forceinline__ bool staged_rows_equal(const uint32_t* pa, int s1,
                                                  const uint32_t* pb, int s2,
                                                  int n) {
  const int nw = (n >> 4) + ((n & 15) != 0);
  const uint32_t last = 0xFFFFFFFFu << (2 * (16 * nw - n));
  uint32_t a_cur = pa[0], b_cur = pb[0], diff = 0;
#pragma unroll
  for (int i = 1; i <= kMax; ++i) {
    if (i <= nw) {
      const uint32_t a_nxt = pa[i], b_nxt = pb[i];
      const uint32_t x = __funnelshift_l(a_nxt, a_cur, s1) ^
                         __funnelshift_l(b_nxt, b_cur, s2);
      diff |= i == nw ? x & last : x;
      a_cur = a_nxt;
      b_cur = b_nxt;
    }
  }
  return diff == 0;
}

// Word w of one pair's row from its tile's staged rows (s = the stage's
// column of the pair, stride T); a word outside the staged rows reads as 0,
// which is exact for every word outside the row, and tile_rows stages every
// word inside the row that the pair's window reads.
struct TileColumn {
  const uint32_t* s;
  TileRows r;
  int stride;
  __device__ __forceinline__ uint32_t operator()(int w) const {
    const int i = w - r.lo;
    return static_cast<unsigned>(i) < static_cast<unsigned>(r.rows)
               ? s[i * stride]
               : 0u;
  }
};

// ok[p] for the tile's pairs, four to a 32-bit store where all four lie
// inside [0, P) and ok is 4-B aligned; every thread of the warp calls this.
__device__ __forceinline__ void store_flags(uint8_t* ok, int64_t p, int64_t P,
                                            bool v) {
  const unsigned x0 = v;
  const unsigned x1 = __shfl_down_sync(0xFFFFFFFFu, x0, 1);
  const unsigned x2 = __shfl_down_sync(0xFFFFFFFFu, x0, 2);
  const unsigned x3 = __shfl_down_sync(0xFFFFFFFFu, x0, 3);
  if ((threadIdx.x & 3) != 0 || p >= P) return;
  if (p + 4 <= P && (reinterpret_cast<uintptr_t>(ok + p) & 3) == 0) {
    *reinterpret_cast<uint32_t*>(ok + p) =
        x0 | (x1 << 8) | (x2 << 16) | (x3 << 24);
  } else {
    const unsigned xs[4] = {x0, x1, x2, x3};
    for (int k = 0; k < 4 && p + k < P; ++k) ok[p + k] = xs[k];
  }
}

// ---------------------------------------------------------------------------
// A row of the 16-word pack_lines16 table held in registers (K6 in
// window_compare.cu; the designs of k6_designs.cu).
constexpr int kRow16Words = 16;

// Words d .. d + 16 of row r of a (n_rows, 16) table into w[0 .. 16]: the
// row's 16-B chunks (d & ~3) / 4 .. (d & ~3) / 4 + 4 (a chunk outside the
// row, or any chunk of a row outside the table, is zeros), shifted down by
// d & 3 words in two select stages (a shift by a word count known only at
// run time, without indexing registers at run time, which would put the
// array in local memory).  Every word a window of at most 16 compared words
// at word offset d reads (d .. d + 16) lies in w.  Only the first `chunks`
// of the five chunks are loaded (the rest read as zeros).
__device__ __forceinline__ void row_words(const uint32_t* __restrict__ table,
                                          int64_t n_rows, int r, int d,
                                          uint32_t (&w)[20], int chunks = 5) {
  const int e = d & ~3, sh = d - e;
  const bool in = r >= 0 && r < n_rows;
  const uint4* g = reinterpret_cast<const uint4*>(
      table + (in ? static_cast<int64_t>(r) * kRow16Words : 0));
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    const int ci = (e >> 2) + c;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (in && c < chunks && ci >= 0 && ci < kRow16Words / 4) x = __ldg(g + ci);
    w[4 * c] = x.x;
    w[4 * c + 1] = x.y;
    w[4 * c + 2] = x.z;
    w[4 * c + 3] = x.w;
  }
#pragma unroll
  for (int i = 0; i < 19; ++i) w[i] = (sh & 1) ? w[i + 1] : w[i];
#pragma unroll
  for (int i = 0; i < 17; ++i) w[i] = (sh & 2) ? w[i + 2] : w[i];
}

}  // namespace disco
