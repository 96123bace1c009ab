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
// in whole lines, with many copies in flight:
//   - a tile is T pairs (256; fewer for wide rows, so that the stages fit
//     the 227 KB of shared memory), one thread each.  Its staged rows of a
//     column input are those window_equal_at reads (window.cuh pair_words,
//     tile_spans, tile_rows: the least o >> 4 to the greatest (o >> 4) +
//     ceil(n / 16) over the tile's live pairs, cut to the row), so the
//     result is exact for every input.  Word w of pair p lies at
//     smem[w * T + p]: a warp's 32 threads read 32 banks;
//   - the copy is 16-B cp.async.cg, neighbouring threads on neighbouring
//     chunks of a row (4-B copies where a row starts misaligned, P % 4 != 0,
//     or at the end of P).  Not TMA: a tile's row range changes from tile
//     to tile (a box per row, or a tensor map per range), P % 4 != 0 rules
//     out a tensor map, and the copy is spread over all the block's
//     threads anyway; what matters is the bytes in flight, which cp.async
//     gives;
//   - a persistent grid of as many blocks as fit on the SMs, each walking
//     tiles blockIdx.x, + gridDim.x, ...: a ring of two stages keeps the
//     next tile's copies in flight while a tile is compared, and each
//     tile's geometry is loaded two steps before its row range is needed
//     (loaded one step before, the wait on it came to a device-memory
//     latency a tile).  Two stages let three blocks of 256 pairs share an
//     SM, which measured faster than three stages and two blocks;
//   - the compare, not the copy, bounds a tile at 24 warps an SM: a window
//     whose words all lie in the staged rows takes staged_window_equal,
//     which walks two pointers with no bounds checks and masks only its
//     last word (through the generic readers K4 took half again as long);
//   - geometry and rows1 are read one 128-B line a warp, and the booleans
//     stored four to a 32-bit store.
// window_compare_fetch stages read2's (Wb, P) columns (for fused_mxu's
// Wb = 32 columns at 250 bp, rows 0..16: rows 17..31 are never copied) and,
// in the same stage, the tile's read1 rows of the table: up to kRowCap rows
// from its least rows1 (window.cuh RowWindow; rows1 is sorted, so a tile of
// 256 pairs spans some 5-6 rows at E. coli).  A row outside that window,
// or a word past the staged ones, is read from device memory, so the
// result is exact for any rows1.  Fetching read1's rows from device memory
// inside the compare instead, word by word, left the compare waiting on
// dependent loads at a quarter of the direct kernel's occupancy, and lost
// to it (PERF.md, PR 5).  It also serves T2
// (tools/exp_fetch_variants.py::verify_pipe_nc, K4's Pallas body without
// its guard).
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

#include "window.cuh"

namespace {

using disco::ColumnRow;
using disco::TileColumn;
using disco::TileRows;
using disco::TileSpan;
using disco::blocks_for;
using disco::kThreads;
using disco::table_row;
using disco::window_equal;
using disco::window_equal_at;

// ---------------------------------------------------------------------------
// the tiled kernels (K3, K4)
// ---------------------------------------------------------------------------
constexpr int kStages = 2;       // the tile compared and kStages - 1 in flight
constexpr int kSlots = kStages + 2;  // tiles whose geometry is held
constexpr int kMaxTile = 256;    // pairs per tile, one thread each
// blocks an SM: the stages of three blocks fit at 17 words (K3) and 32 (K4)
constexpr int kBlocksPerSm = 3;
constexpr int kMaxWords = 256;   // widest staged column input
constexpr int kSmemBytes = 232448;  // shared memory a block may use (sm_90)
constexpr int kRowCap = 32;      // K4: read1 rows staged a tile (RowWindow)
// tile_spans' scratch, one slot per stage (static shared memory)
constexpr int kSlotInts = 2 * 2 * 32;
constexpr int kScratchInts = kStages * kSlotInts;

// Words of one stage: the staged column inputs (K3: a and b; K4: b) of
// `words` rows and T columns, and for K4 a window of kRowCap read1 rows of
// the first min(wt, kMaxWords) words at an odd stride (window.cuh
// RowWindow).  A multiple of 4 words, so every stage starts 16-B aligned.
__host__ __device__ constexpr int stage_words(bool fetch, int words, int wt,
                                              int T) {
  return fetch ? words * T + kRowCap * ((wt < kMaxWords ? wt : kMaxWords) | 1)
               : 2 * words * T;
}

struct Pair {
  int o1, o2, n, r1;
  bool live;  // p < P
};

__device__ __forceinline__ Pair load_pair(int64_t p, int64_t P,
                                          const int32_t* __restrict__ o1,
                                          const int32_t* __restrict__ o2,
                                          const int32_t* __restrict__ n,
                                          const int32_t* __restrict__ rows1) {
  Pair q{0, 0, 0, 0, p < P};
  if (q.live) {
    q.o1 = __ldg(o1 + p);
    q.o2 = __ldg(o2 + p);
    q.n = __ldg(n + p);
    if (rows1 != nullptr) q.r1 = __ldg(rows1 + p);
  }
  return q;
}

// The tiles blockIdx.x, blockIdx.x + gridDim.x, ... of T = blockDim.x
// pairs.  kFetch (K4): read2's (w, P) columns `b` staged, and the tile's
// read1 rows of `table` staged as a RowWindow from its least rows1 (a row
// outside the window, or a word past the staged ones, is read from device
// memory, so the result is exact for any rows1).  Else (K3) both (w, P)
// column inputs `a` and `b` staged.  smem holds kStages stages of
// stage_words, scratch kScratchInts ints.
template <bool kFetch>
__device__ __forceinline__ void compare_tiles(
    uint32_t* smem, int* scratch, const uint32_t* __restrict__ a,
    const uint32_t* __restrict__ table, int64_t n_rows, int wt,
    const uint32_t* __restrict__ b, int w,
    const int32_t* __restrict__ rows1, int64_t P,
    const int32_t* __restrict__ o1, const int32_t* __restrict__ o2,
    const int32_t* __restrict__ n, uint8_t* __restrict__ ok) {
  const int T = blockDim.x;
  const int sw = stage_words(kFetch, w, wt, T);
  const int wr = wt < kMaxWords ? wt : kMaxWords;  // K4: read1 words staged
  const int64_t tiles = (P + T - 1) / T;
  const int64_t step = gridDim.x;
  const int64_t t0 = blockIdx.x;

  auto pair_of = [&](int64_t tile) {
    return load_pair(tile * T + threadIdx.x, P, o1, o2, n,
                     kFetch ? rows1 : nullptr);
  };
  // The tile's spans (K3: [0] the words read of a, [1] of b; K4: [0] the
  // words read of b, [1] the rows of read1); every thread calls this (one
  // sync).
  auto spans_of = [&](const Pair& q, int slot, TileSpan(&out)[2]) {
    TileSpan mine[2];
    if constexpr (kFetch) {
      mine[0] = disco::pair_words(q.o2, q.n, q.live);
      mine[1] = q.live && q.n > 0
                    ? TileSpan{q.r1, q.r1}
                    : TileSpan{0x7FFFFFFF, static_cast<int>(0x80000000u)};
    } else {
      mine[0] = disco::pair_words(q.o1, q.n, q.live);
      mine[1] = disco::pair_words(q.o2, q.n, q.live);
    }
    disco::tile_spans<2>(mine, scratch + slot * kSlotInts, out);
  };
  auto window_of = [&](uint32_t* s, const TileSpan& r) {
    return disco::row_window(s + w * T, r.lo, r.hi, kRowCap, n_rows, wr);
  };
  auto stage = [&](int slot, int64_t tile, const TileSpan(&sp)[2]) {
    uint32_t* s = smem + slot * sw;
    if constexpr (kFetch) {
      disco::stage_columns(s, b, P, tile * T, disco::tile_rows(sp[0], w));
      disco::stage_rows(window_of(s, sp[1]), table, wt);
    } else {
      disco::stage_columns(s, a, P, tile * T, disco::tile_rows(sp[0], w));
      disco::stage_columns(s + w * T, b, P, tile * T,
                           disco::tile_rows(sp[1], w));
    }
  };

  // Tile j of this block (t0 + j * step) keeps its geometry and spans in
  // slot j % kSlots and its rows in stage j % kStages.  Iteration j stages
  // tile j + kStages - 1, loads the geometry of tile j + kStages + 1 into
  // the slot tile j - 1 freed, and compares tile j: a tile's geometry
  // arrives two iterations before its spans are taken.  The loop is
  // unrolled over the slots, so a slot is a fixed set of registers.
  Pair g[kSlots];
  TileSpan sp[kSlots][2];
#pragma unroll
  for (int j = 0; j < kSlots - 1; ++j) g[j] = pair_of(t0 + j * step);
#pragma unroll
  for (int j = 0; j + 1 < kStages; ++j) {
    spans_of(g[j], j, sp[j]);
    stage(j, t0 + j * step, sp[j]);
    disco::cp_async_commit();
  }
  int slot = 0;  // the stage of tile j
  for (int64_t t = t0;; t += kSlots * step) {
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const int64_t tile = t + j * step;
      if (tile >= tiles) {
        disco::cp_async_wait<0>();
        return;
      }
      // tile j + kStages - 1 goes into the stage that tile j - 1 used:
      // every thread has passed that compare (spans_of syncs first)
      constexpr int kAhead = kStages - 1;
      const int ahead = slot == 0 ? kStages - 1 : slot - 1;
      spans_of(g[(j + kAhead) % kSlots], ahead, sp[(j + kAhead) % kSlots]);
      stage(ahead, tile + kAhead * step, sp[(j + kAhead) % kSlots]);
      disco::cp_async_commit();
      g[(j + kSlots - 1) % kSlots] = pair_of(tile + (kSlots - 1) * step);
      disco::cp_async_wait<kStages - 1>();
      __syncthreads();

      // A window whose words all lie in the staged rows takes
      // staged_window_equal; any other (past the row, outside the row
      // window) the readers, which give 0 or read device memory.
      const Pair& q = g[j];
      uint32_t* s = smem + slot * sw;
      const int d1 = q.o1 >> 4, d2 = q.o2 >> 4;
      const int nw = (q.n >> 4) + ((q.n & 15) != 0);
      bool v;
      if constexpr (kFetch) {
        const disco::RowWindow rw = window_of(s, sp[j][1]);
        const TileRows rb = disco::tile_rows(sp[j][0], w);
        const int64_t k = static_cast<int64_t>(q.r1) - rw.base;
        if (q.n > 0 && k >= 0 && k < rw.rows && d1 >= 0 && d1 + nw < rw.ws &&
            d2 >= rb.lo && d2 + nw < rb.lo + rb.rows) {
          v = disco::staged_window_equal(
              rw.smem + k * rw.stride + d1, 1, (q.o1 & 15) << 1,
              s + (d2 - rb.lo) * T + threadIdx.x, T, (q.o2 & 15) << 1, q.n);
        } else {
          int misses = 0;
          v = window_equal(disco::staged_row(rw, table, n_rows, wt, wt, q.r1,
                                             misses),
                           q.o1, TileColumn{s + threadIdx.x, rb, T}, q.o2,
                           q.n);
        }
      } else {
        const TileRows ra = disco::tile_rows(sp[j][0], w);
        const TileRows rb = disco::tile_rows(sp[j][1], w);
        if (q.n > 0 && d1 >= ra.lo && d1 + nw < ra.lo + ra.rows &&
            d2 >= rb.lo && d2 + nw < rb.lo + rb.rows) {
          v = disco::staged_window_equal(
              s + (d1 - ra.lo) * T + threadIdx.x, T, (q.o1 & 15) << 1,
              s + w * T + (d2 - rb.lo) * T + threadIdx.x, T,
              (q.o2 & 15) << 1, q.n);
        } else {
          v = window_equal(TileColumn{s + threadIdx.x, ra, T}, q.o1,
                           TileColumn{s + w * T + threadIdx.x, rb, T}, q.o2,
                           q.n);
        }
      }
      disco::store_flags(ok, tile * T + threadIdx.x, P, v);
      slot = slot + 1 == kStages ? 0 : slot + 1;
    }
  }
}

__global__ void __launch_bounds__(kMaxTile, kBlocksPerSm)
window_compare_kernel(const uint32_t* __restrict__ a,
                      const uint32_t* __restrict__ b, int wp, int64_t P,
                      const int32_t* __restrict__ o1,
                      const int32_t* __restrict__ o2,
                      const int32_t* __restrict__ n,
                      uint8_t* __restrict__ ok) {
  extern __shared__ uint4 smem4[];
  __shared__ int scratch[kScratchInts];
  compare_tiles<false>(reinterpret_cast<uint32_t*>(smem4), scratch, a,
                       nullptr, 0, 0, b, wp, nullptr, P, o1, o2, n, ok);
}

__global__ void __launch_bounds__(kMaxTile, kBlocksPerSm)
window_compare_fetch_kernel(const uint32_t* __restrict__ table,
                            int64_t n_rows, int wt,
                            const uint32_t* __restrict__ b, int wb,
                            const int32_t* __restrict__ rows1, int64_t P,
                            const int32_t* __restrict__ o1,
                            const int32_t* __restrict__ o2,
                            const int32_t* __restrict__ n,
                            uint8_t* __restrict__ ok) {
  extern __shared__ uint4 smem4[];
  __shared__ int scratch[kScratchInts];
  compare_tiles<true>(reinterpret_cast<uint32_t*>(smem4), scratch, nullptr,
                      table, n_rows, wt, b, wb, rows1, P, o1, o2, n, ok);
}

// Pairs per tile: 256, or the largest multiple of 32 whose kStages stages
// fit a block's shared memory (32 for K3 at 256 words).
int tile_pairs(bool fetch, int words, int wt) {
  const int budget = (kSmemBytes - 4 * kScratchInts) / (4 * kStages);
  const int fixed = stage_words(fetch, 0, wt, 0);
  const int per_pair = stage_words(fetch, words > 1 ? words : 1, wt, 1) -
                       fixed;
  const int t = (budget - fixed) / per_pair;
  return t >= kMaxTile ? kMaxTile : t / 32 * 32;
}

// The launch shape of a tiled kernel: its tile, its dynamic shared memory,
// and a grid of as many blocks as fit on the card's SMs at that size, but
// no more than there are tiles.
template <class Kernel>
cudaError_t tiled_shape(Kernel kernel, bool fetch, int words, int wt,
                        int64_t P, int* tile, size_t* smem, unsigned* grid) {
  if (words < 0 || words > kMaxWords || wt < 0)
    return cudaErrorInvalidValue;
  *tile = tile_pairs(fetch, words, wt);
  *smem = static_cast<size_t>(kStages) * 4 *
          stage_words(fetch, words, wt, *tile);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(*smem));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, *tile,
                                                      *smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t tiles = (P + *tile - 1) / *tile;
  const int64_t most = static_cast<int64_t>(per_sm) * sms;
  *grid = static_cast<unsigned>(tiles < most ? tiles : most);
  return cudaSuccess;
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
  const cudaError_t e = tiled_shape(window_compare_kernel, false, wp, 0, P,
                                    &tile, &smem, &grid);
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
  const cudaError_t e = tiled_shape(window_compare_fetch_kernel, true, wb,
                                    wt, P, &tile, &smem, &grid);
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
      wt > 0 ? tiled_shape(window_compare_fetch_kernel, true, words, wt, P,
                           tile, &smem, &g)
             : tiled_shape(window_compare_kernel, false, words, 0, P, tile,
                           &smem, &g);
  *grid = static_cast<int>(g);
  *stages = kStages;
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
