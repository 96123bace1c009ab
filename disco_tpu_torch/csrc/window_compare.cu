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
// The other two kernels, and the _direct controls, run one thread a pair on
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
// one thread a pair: K6, K7, and the controls of K3 and K4 (the kernels of
// window_compare and window_compare_fetch before they were tiled)
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
