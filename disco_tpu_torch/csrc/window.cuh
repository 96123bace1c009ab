// Row readers and the packed-window compare shared by the window-check
// kernels (dual_compare.cu, window_compare.cu).
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

}  // namespace disco
