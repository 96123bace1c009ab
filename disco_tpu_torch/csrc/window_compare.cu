// Single window check for candidate read pairs, for NVIDIA Hopper (compiled
// for sm_90a).  Four kernels, one per TPU kernel they replace:
//
//   window_compare             <- disco_tpu/overlap/fused_kernel.py::fused_compare
//                                 (Pallas body _fused_kernel): both rows arrive
//                                 as pre-gathered (Wp, P) columns.
//   window_compare_fetch       <- fused_kernel.py::verify_windows_fused_mxu
//                                 (Pallas body _mxu2_kernel): read1's row is
//                                 fetched inside the kernel from a row-major
//                                 (R, Wt) table (pack_lines viewed as 32-word
//                                 rows); read2's row arrives as (Wb, P) columns.
//   window_compare_fetch_both  <- fused_kernel.py::verify_windows_fused_mxu_both16
//                                 (Pallas body _mxu3_16_kernel): both rows are
//                                 fetched inside the kernel from one row-major
//                                 (R, 16) table (pack_lines16 as 16-word rows).
//   window_compare_aligned     <- disco_tpu/overlap/pallas_kernel.py::compare_windows
//                                 (Pallas body _compare_kernel): word-aligned
//                                 (W+1, P) columns, a bit phase per pair, and
//                                 words wi < W compared only.
//
// For pair p: ok[p] = a@o1[p] == b@o2[p] over n[p] bases (window_equal of
// window.cuh), a length of 0 giving true.
//
// What bounds these kernels on an H100: device-memory bytes.  Per pair the
// work is a funnel shift, an XOR and a compare per 16 bases; the data is
// up to Wp x 4 B of each row plus 12 B of window geometry and 1 B out.
// The design for that:
//   - one thread per pair, so a (W, P) column layout puts neighbouring
//     threads on neighbouring words: every column load is coalesced;
//   - a check reads only the ceil(n/16) + 1 words its window spans and
//     stops at the first mismatching word; n = 0 lanes read only their
//     geometry;
//   - the fetch kernels read a row of the table directly.  The TPU kernels'
//     128-lane line blocks, one-hot MXU row expansion, span guards and
//     lax.cond fallbacks exist because a TPU has no cheap per-lane gather;
//     here there is no span precondition and so no fallback.  Candidates
//     sorted by read1 (and, after the locality relabel, read2 in a narrow
//     band of rows per tile) put neighbouring threads on the same rows,
//     which then hit in L1/L2.  A row index outside the table reads as a
//     row of zeros.  window_staged.cu stages a tile's row window in shared
//     memory instead (K5, T1, T3); K4's kernel here also serves T2
//     (tools/exp_fetch_variants.py::verify_pipe_nc, K4's Pallas body
//     without its guard).
//
// Each launcher is a plain C function: it launches on the given stream,
// does not synchronise, allocates nothing, and returns cudaGetLastError().
#include <cstdint>
#include <cuda_runtime.h>

#include "window.cuh"

namespace {

using disco::ColumnRow;
using disco::blocks_for;
using disco::kThreads;
using disco::table_row;
using disco::window_equal;
using disco::window_equal_at;

__global__ void __launch_bounds__(kThreads)
window_compare_kernel(const uint32_t* __restrict__ a,
                      const uint32_t* __restrict__ b, int wp, int64_t P,
                      const int32_t* __restrict__ o1,
                      const int32_t* __restrict__ o2,
                      const int32_t* __restrict__ n,
                      uint8_t* __restrict__ ok) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= P) return;
  const ColumnRow ra{a + p, P, wp};
  const ColumnRow rb{b + p, P, wp};
  ok[p] = window_equal(ra, o1[p], rb, o2[p], n[p]);
}

__global__ void __launch_bounds__(kThreads)
window_compare_fetch_kernel(const uint32_t* __restrict__ table,
                            int64_t n_rows, int wt,
                            const uint32_t* __restrict__ b, int wb,
                            const int32_t* __restrict__ rows1, int64_t P,
                            const int32_t* __restrict__ o1,
                            const int32_t* __restrict__ o2,
                            const int32_t* __restrict__ n,
                            uint8_t* __restrict__ ok) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= P) return;
  const auto ra = table_row(table, n_rows, wt, rows1[p]);
  const ColumnRow rb{b + p, P, wb};
  ok[p] = window_equal(ra, o1[p], rb, o2[p], n[p]);
}

__global__ void __launch_bounds__(kThreads)
window_compare_fetch_both_kernel(const uint32_t* __restrict__ table,
                                 int64_t n_rows, int wt,
                                 const int32_t* __restrict__ rows1,
                                 const int32_t* __restrict__ rows2,
                                 int64_t P,
                                 const int32_t* __restrict__ o1,
                                 const int32_t* __restrict__ o2,
                                 const int32_t* __restrict__ n,
                                 uint8_t* __restrict__ ok) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= P) return;
  const auto ra = table_row(table, n_rows, wt, rows1[p]);
  const auto rb = table_row(table, n_rows, wt, rows2[p]);
  ok[p] = window_equal(ra, o1[p], rb, o2[p], n[p]);
}

// Columns of W + 1 words: word wi is funnel(col[wi], col[wi + 1], bit) for
// wi < W only, so a window longer than 16 W bases is compared over W words
// (pallas_kernel.py:54).  The bit phases are in 0..31 (even, 0..30, as the
// callers make them).
__global__ void __launch_bounds__(kThreads)
window_compare_aligned_kernel(const uint32_t* __restrict__ a,
                              const uint32_t* __restrict__ b, int w1,
                              int64_t P,
                              const int32_t* __restrict__ bit1,
                              const int32_t* __restrict__ bit2,
                              const int32_t* __restrict__ n,
                              uint8_t* __restrict__ ok) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= P) return;
  const ColumnRow ra{a + p, P, w1};
  const ColumnRow rb{b + p, P, w1};
  ok[p] = window_equal_at(ra, 0, bit1[p], rb, 0, bit2[p],
                          min(n[p], 16 * (w1 - 1)));
}

cudaStream_t as_stream(void* s) { return static_cast<cudaStream_t>(s); }

const uint32_t* u32(const void* x) { return static_cast<const uint32_t*>(x); }

const int32_t* i32(const void* x) { return static_cast<const int32_t*>(x); }

uint8_t* u8(void* x) { return static_cast<uint8_t*>(x); }

}  // namespace

extern "C" {

int disco_window_compare(const void* a, const void* b, int wp, int64_t P,
                         const void* o1, const void* o2, const void* n,
                         void* ok, void* stream) {
  if (P <= 0) return 0;
  window_compare_kernel<<<blocks_for(P), kThreads, 0, as_stream(stream)>>>(
      u32(a), u32(b), wp, P, i32(o1), i32(o2), i32(n), u8(ok));
  return static_cast<int>(cudaGetLastError());
}

int disco_window_compare_fetch(const void* table, int64_t n_rows, int wt,
                               const void* b, int wb, const void* rows1,
                               int64_t P, const void* o1, const void* o2,
                               const void* n, void* ok, void* stream) {
  if (P <= 0) return 0;
  window_compare_fetch_kernel<<<blocks_for(P), kThreads, 0,
                                as_stream(stream)>>>(
      u32(table), n_rows, wt, u32(b), wb, i32(rows1), P, i32(o1), i32(o2),
      i32(n), u8(ok));
  return static_cast<int>(cudaGetLastError());
}

int disco_window_compare_fetch_both(const void* table, int64_t n_rows,
                                    int wt, const void* rows1,
                                    const void* rows2, int64_t P,
                                    const void* o1, const void* o2,
                                    const void* n, void* ok, void* stream) {
  if (P <= 0) return 0;
  window_compare_fetch_both_kernel<<<blocks_for(P), kThreads, 0,
                                     as_stream(stream)>>>(
      u32(table), n_rows, wt, i32(rows1), i32(rows2), P, i32(o1), i32(o2),
      i32(n), u8(ok));
  return static_cast<int>(cudaGetLastError());
}

int disco_window_compare_aligned(const void* a, const void* b, int w1,
                                 int64_t P, const void* bit1,
                                 const void* bit2, const void* n, void* ok,
                                 void* stream) {
  if (P <= 0) return 0;
  window_compare_aligned_kernel<<<blocks_for(P), kThreads, 0,
                                  as_stream(stream)>>>(
      u32(a), u32(b), w1, P, i32(bit1), i32(bit2), i32(n), u8(ok));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
