// Row readers and the packed-window compare shared by the window-check
// kernels (dual_compare.cu, window_compare.cu, window_staged.cu), and the
// staged row window of window_staged.cu.
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

}  // namespace disco
