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
//
// window_compare and window_compare_fetch tile their column inputs through
// shared memory.  One thread a pair reading its own column word by word
// (the _direct kernels below, kept as timing controls) puts a warp's load
// on some 8-9 word rows, because neighbouring pairs start their windows at
// different words: each 4-B load costs its own 32-B sector and L1
// wavefront, and a thread has at most two dependent loads in flight.  Over
// a group of 8 neighbouring pairs the windows cover nearly every word of
// the row (67.6 of 68 B at 250 bp), so the least a kernel can read is the
// whole rows the tile's windows reach.  The tiled design reads just that,
// in whole lines, with many copies in flight, on the ring of tiles of
// tile_ring.cuh (shared with window_staged.cu's T1):
//   - a tile is T pairs (256; fewer for wide rows, so that the stages fit
//     the 227 KB of shared memory), one thread each.  Its staged rows of a
//     column input are those window_equal_at reads (window.cuh pair_words,
//     tile_spans, tile_rows: the least o >> 4 to the greatest (o >> 4) +
//     ceil(n / 16) over the tile's live pairs, cut to the row), so the
//     result is exact for every input.  Word w of pair p lies at
//     smem[w * T + p]: a warp's 32 threads read 32 banks;
//   - the copy is 16-B cp.async.cg, neighbouring threads on neighbouring
//     chunks of a row (4-B copies where a row starts misaligned, P % 4 != 0,
//     or at the end of P);
//   - the compare, not the copy, bounds a tile at 24 warps an SM: a window
//     whose words all lie in the staged rows takes staged_window_equal,
//     which walks two pointers with no bounds checks and masks only its
//     last word (through the generic readers K4 took half again as long);
//   - geometry and rows1 are read one 128-B line a warp, and the booleans
//     stored four to a 32-bit store.
// window_compare_fetch stages read2's (Wb, P) columns (for fused_mxu's
// Wb = 32 columns at 250 bp, rows 0..16: rows 17..31 are never copied) and,
// in the same stage, the tile's read1 rows of the table: up to 32 rows
// from its least rows1 (tile_ring.cuh NearestRows; rows1 is sorted, so a
// tile of 256 pairs spans some 5-6 rows at E. coli).  A row outside that
// window, or a word past the staged ones, is read from device memory, so
// the result is exact for any rows1.  Fetching read1's rows from device
// memory inside the compare instead, word by word, left the compare
// waiting on dependent loads at a quarter of the direct kernel's
// occupancy, and lost to it (PERF.md, section 6).  It also serves T2
// (tools/exp_fetch_variants.py::verify_pipe_nc, K4's Pallas body without
// its guard).
//
// The tiled kernels take column inputs of at most ring::kMaxWords = 256
// words (4,080 bp), so that a tile of 32 pairs fits its two stages; the
// wrappers send wider inputs to the one-thread-a-pair kernels, which take
// any width.
//
// window_compare_fetch_both (K6) reads both rows of a pair from the 64-B
// rows of the pack_lines16 table.  One thread a pair loading each compared
// word of both rows with its own 4-B load (the _direct control, the kernel
// before this one) is held back by the count of its loads, not by their
// bytes or their spread over rows (PERF.md, section 6: a warp staging its
// pairs' rows in shared memory by coalesced copies was slower than the
// direct kernel, a grid whose blocks walked contiguous runs of pairs to
// keep read2's band in L1 gained nothing, and each cut in load
// instructions gained).  So a thread takes four consecutive pairs, loads
// their geometry by five streaming 16-B loads (which leave L1 to the rows)
// and stores their four flags by one 4-B store, and reads each row as the
// 16-B chunks that hold words d .. d + 16 of it (d = o >> 4), aligned in
// registers by two select stages (row_words); the window's words are then
// compared without an early exit.  At most 64 registers (four blocks, 32
// warps an SM), no shared memory.  A window of more than 16 compared words
// (n > 256 bases) takes the checked readers, so the result is exact for
// every input; a table that is not 16-B aligned takes the direct kernel.
// tools/exp_k6_designs.py times the other designs (csrc/k6_designs.cu).
//
// The other kernel (K7), and the _direct controls, run one thread a pair on
// its own rows:
//   - a (W, P) column layout puts neighbouring threads on neighbouring
//     words; a check reads only the ceil(n/16) + 1 words its window spans
//     and stops at the first mismatching word; n = 0 lanes read only their
//     geometry;
//   - the fetch kernels read a row of the table directly.  The TPU kernels'
//     128-lane line blocks, one-hot MXU row expansion, span guards and
//     lax.cond fallbacks exist because a TPU has no cheap per-lane gather;
//     here there is no span precondition and so no fallback.  A row index
//     outside the table reads as a row of zeros.  window_staged.cu stages a
//     tile's row window in shared memory instead (K5, T1, T3).
//
// Each launcher is a plain C function: it launches on the given stream,
// does not synchronise, allocates nothing, and returns cudaGetLastError()
// (or the error of its launch-shape query).
#include <cstdint>
#include <cuda_runtime.h>

#include "tile_ring.cuh"
#include "window.cuh"

namespace {

using disco::ColumnRow;
using disco::blocks_for;
using disco::kThreads;
using disco::row_words;
using disco::table_row;
using disco::window_equal;
using disco::window_equal_at;

// ---------------------------------------------------------------------------
// the tiled kernels (K3, K4) on the ring of tile_ring.cuh
// ---------------------------------------------------------------------------
namespace ring = disco::ring;

// K4 stages the first min(wt, 256) words of each read1 row.
__host__ __device__ int read1_words(int wt) {
  return wt < ring::kMaxWords ? wt : ring::kMaxWords;
}

__global__ void __launch_bounds__(ring::kMaxTile, ring::kBlocksPerSm)
window_compare_kernel(const uint32_t* __restrict__ a,
                      const uint32_t* __restrict__ b, int wp, int64_t P,
                      const int32_t* __restrict__ o1,
                      const int32_t* __restrict__ o2,
                      const int32_t* __restrict__ n,
                      uint8_t* __restrict__ ok) {
  extern __shared__ uint4 smem4[];
  __shared__ int scratch[ring::kScratchInts];
  ring::compare_tiles<ring::Columns>(reinterpret_cast<uint32_t*>(smem4),
                                     scratch, a, nullptr, 0, 0, 0, b, wp,
                                     nullptr, P, o1, o2, n, ok, nullptr);
}

__global__ void __launch_bounds__(ring::kMaxTile, ring::kBlocksPerSm)
window_compare_fetch_kernel(const uint32_t* __restrict__ table,
                            int64_t n_rows, int wt,
                            const uint32_t* __restrict__ b, int wb,
                            const int32_t* __restrict__ rows1, int64_t P,
                            const int32_t* __restrict__ o1,
                            const int32_t* __restrict__ o2,
                            const int32_t* __restrict__ n,
                            uint8_t* __restrict__ ok) {
  extern __shared__ uint4 smem4[];
  __shared__ int scratch[ring::kScratchInts];
  ring::compare_tiles<ring::NearestRows>(
      reinterpret_cast<uint32_t*>(smem4), scratch, nullptr, table, n_rows,
      wt, read1_words(wt), b, wb, rows1, P, o1, o2, n, ok, nullptr);
}

// ---------------------------------------------------------------------------
// K6: four consecutive pairs a thread, each row by 16-B loads
// ---------------------------------------------------------------------------
constexpr int kRowWords = disco::kRow16Words;  // a pack_lines16 row
constexpr int kPairs = 4;         // consecutive pairs a thread
constexpr int kBothBlocksPerSm = 4;  // <= 64 registers: 32 warps an SM

// a@o1 == b@o2 over n bases for rows r1 and r2 of the table: windows of at
// most 16 compared words (n <= 256, all K6's path makes) from row_words,
// every word compared without an early exit; any other window through the
// checked readers.
__device__ __forceinline__ bool both16_equal(const uint32_t* __restrict__ table,
                                             int64_t n_rows, int r1, int r2,
                                             int o1, int o2, int n) {
  if (n <= 0) return true;
  const int nw = (n >> 4) + ((n & 15) != 0);
  if (nw > kRowWords)
    return window_equal(table_row(table, n_rows, kRowWords, r1), o1,
                        table_row(table, n_rows, kRowWords, r2), o2, n);
  uint32_t a[20], b[20];
  row_words(table, n_rows, r1, o1 >> 4, a);
  row_words(table, n_rows, r2, o2 >> 4, b);
  const int s1 = (o1 & 15) << 1, s2 = (o2 & 15) << 1;
  const uint32_t last = 0xFFFFFFFFu << (2 * (16 * nw - n));
  uint32_t diff = 0;
#pragma unroll
  for (int i = 0; i < kRowWords; ++i) {
    if (i < nw) {
      const uint32_t x = __funnelshift_l(a[i + 1], a[i], s1) ^
                         __funnelshift_l(b[i + 1], b[i], s2);
      diff |= i + 1 == nw ? x & last : x;
    }
  }
  return diff == 0;
}

__global__ void __launch_bounds__(kThreads, kBothBlocksPerSm)
window_compare_fetch_both_kernel(const uint32_t* __restrict__ table,
                                 int64_t n_rows,
                                 const int32_t* __restrict__ rows1,
                                 const int32_t* __restrict__ rows2,
                                 int64_t P,
                                 const int32_t* __restrict__ o1,
                                 const int32_t* __restrict__ o2,
                                 const int32_t* __restrict__ n,
                                 uint8_t* __restrict__ ok) {
  const int64_t p =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * kPairs;
  if (p >= P) return;
  const int32_t* src[5] = {rows1, rows2, o1, o2, n};
  uintptr_t bits = reinterpret_cast<uintptr_t>(ok) & 3;
#pragma unroll
  for (int a = 0; a < 5; ++a) bits |= reinterpret_cast<uintptr_t>(src[a]) & 15;
  const bool vec = bits == 0 && p + kPairs <= P;
  int g[5][kPairs];
#pragma unroll
  for (int a = 0; a < 5; ++a) {
    if (vec) {  // streaming loads: they leave L1 to the rows
      const int4 x = __ldcs(reinterpret_cast<const int4*>(src[a] + p));
      g[a][0] = x.x;
      g[a][1] = x.y;
      g[a][2] = x.z;
      g[a][3] = x.w;
    } else {
#pragma unroll
      for (int m = 0; m < kPairs; ++m)
        g[a][m] = p + m < P ? __ldg(src[a] + p + m) : 0;
    }
  }
  unsigned flags = 0;
#pragma unroll
  for (int m = 0; m < kPairs; ++m)
    flags |= static_cast<unsigned>(both16_equal(table, n_rows, g[0][m],
                                                g[1][m], g[2][m], g[3][m],
                                                g[4][m]))
             << (8 * m);
  if (vec) {
    *reinterpret_cast<uint32_t*>(ok + p) = flags;
  } else {
    for (int m = 0; m < kPairs && p + m < P; ++m)
      ok[p + m] = (flags >> (8 * m)) & 1;
  }
}

// ---------------------------------------------------------------------------
// one thread a pair: K7, and the controls of K3, K4 and K6 (the kernels of
// window_compare, window_compare_fetch and window_compare_fetch_both before
// their redesigns)
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
window_compare_direct_kernel(const uint32_t* __restrict__ a,
                             const uint32_t* __restrict__ b, int wp,
                             int64_t P, const int32_t* __restrict__ o1,
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
window_compare_fetch_direct_kernel(const uint32_t* __restrict__ table,
                                   int64_t n_rows, int wt,
                                   const uint32_t* __restrict__ b, int wb,
                                   const int32_t* __restrict__ rows1,
                                   int64_t P,
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
window_compare_fetch_both_direct_kernel(const uint32_t* __restrict__ table,
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
  int tile;
  size_t smem;
  unsigned grid;
  const cudaError_t e = ring::tiled_shape<ring::Columns>(
      window_compare_kernel, wp, 0, P, &tile, &smem, &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  window_compare_kernel<<<grid, tile, smem, as_stream(stream)>>>(
      u32(a), u32(b), wp, P, i32(o1), i32(o2), i32(n), u8(ok));
  return static_cast<int>(cudaGetLastError());
}

int disco_window_compare_fetch(const void* table, int64_t n_rows, int wt,
                               const void* b, int wb, const void* rows1,
                               int64_t P, const void* o1, const void* o2,
                               const void* n, void* ok, void* stream) {
  if (P <= 0) return 0;
  int tile;
  size_t smem;
  unsigned grid;
  if (wt < 0) return cudaErrorInvalidValue;
  const cudaError_t e = ring::tiled_shape<ring::NearestRows>(
      window_compare_fetch_kernel, wb, read1_words(wt), P, &tile, &smem,
      &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  window_compare_fetch_kernel<<<grid, tile, smem, as_stream(stream)>>>(
      u32(table), n_rows, wt, u32(b), wb, i32(rows1), P, i32(o1), i32(o2),
      i32(n), u8(ok));
  return static_cast<int>(cudaGetLastError());
}

// The launch shape of window_compare (wt = 0) or window_compare_fetch
// (read1's rows wt words wide) over staged columns of `words` words and P
// pairs: pairs per tile, blocks, and the stages of the ring.
int disco_window_compare_shape(int words, int wt, int64_t P, int* tile,
                               int* grid, int* stages) {
  size_t smem;
  unsigned g = 0;
  const cudaError_t e =
      wt > 0 ? ring::tiled_shape<ring::NearestRows>(
                   window_compare_fetch_kernel, words, read1_words(wt), P,
                   tile, &smem, &g)
             : ring::tiled_shape<ring::Columns>(window_compare_kernel, words,
                                                0, P, tile, &smem, &g);
  *grid = static_cast<int>(g);
  *stages = ring::kStages;
  return static_cast<int>(e);
}

int disco_window_compare_direct(const void* a, const void* b, int wp,
                                int64_t P, const void* o1, const void* o2,
                                const void* n, void* ok, void* stream) {
  if (P <= 0) return 0;
  window_compare_direct_kernel<<<blocks_for(P), kThreads, 0,
                                 as_stream(stream)>>>(
      u32(a), u32(b), wp, P, i32(o1), i32(o2), i32(n), u8(ok));
  return static_cast<int>(cudaGetLastError());
}

int disco_window_compare_fetch_direct(const void* table, int64_t n_rows,
                                      int wt, const void* b, int wb,
                                      const void* rows1, int64_t P,
                                      const void* o1, const void* o2,
                                      const void* n, void* ok, void* stream) {
  if (P <= 0) return 0;
  window_compare_fetch_direct_kernel<<<blocks_for(P), kThreads, 0,
                                       as_stream(stream)>>>(
      u32(table), n_rows, wt, u32(b), wb, i32(rows1), P, i32(o1), i32(o2),
      i32(n), u8(ok));
  return static_cast<int>(cudaGetLastError());
}

int disco_window_compare_fetch_both_direct(const void* table,
                                           int64_t n_rows, int wt,
                                           const void* rows1,
                                           const void* rows2, int64_t P,
                                           const void* o1, const void* o2,
                                           const void* n, void* ok,
                                           void* stream) {
  if (P <= 0) return 0;
  window_compare_fetch_both_direct_kernel<<<blocks_for(P), kThreads, 0,
                                            as_stream(stream)>>>(
      u32(table), n_rows, wt, i32(rows1), i32(rows2), P, i32(o1), i32(o2),
      i32(n), u8(ok));
  return static_cast<int>(cudaGetLastError());
}

int disco_window_compare_fetch_both(const void* table, int64_t n_rows,
                                    int wt, const void* rows1,
                                    const void* rows2, int64_t P,
                                    const void* o1, const void* o2,
                                    const void* n, void* ok, void* stream) {
  if (P <= 0) return 0;
  if (wt != kRowWords) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(table) & 15)   // no 16-B row loads
    return disco_window_compare_fetch_both_direct(table, n_rows, wt, rows1,
                                                  rows2, P, o1, o2, n, ok,
                                                  stream);
  const int64_t threads = (P + kPairs - 1) / kPairs;
  window_compare_fetch_both_kernel<<<blocks_for(threads), kThreads, 0,
                                     as_stream(stream)>>>(
      u32(table), n_rows, i32(rows1), i32(rows2), P, i32(o1), i32(o2),
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
